"""Selective state-space scan (mamba1), forward and backward.

Port of ``repro/kernels/ssm_scan.py``:

    x_t = exp(delta_t * A) * x_{t-1} + (delta_t * u_t) * B_t
    y_t = sum_n C_t[n] * x_t[:, n]

u and delta are [Bt, L, D], A is [D, N], B and C are [Bt, L, N], in any
float type, taken as float32; the outputs are y [Bt, L, D] and the final
state [Bt, D, N], both float32.  The reference's shape contract stays:
``D % 128 == 0`` and ``L % chunk == 0`` (a ``ValueError`` here, an
``assert`` there); ``chunk`` changes nothing else, since the recurrence
runs step by step either way.  The plain versions compute in float64 when
an operand is float64 (``torch.autograd.gradcheck``), else in float32.

``ssm_scan`` launches ``csrc/ssm_scan.cu`` for tensors on the card and runs
``ssm_scan_plain`` for tensors on the CPU.  The kernel takes any state
dimension N >= 1 and any number of batch rows (earlier it took N <= 32 and
at most 65,535 rows).  A lane holds ``STATES_PER_LANE`` states of one
channel and ``scan_layout`` gives a channel the lanes its states need; the
kernel walks L step by step, rounding the state as ``ssm_scan_plain``
does.

The backward is the port's own: the JAX package trains through XLA's
autodiff of its ``lax.scan`` (``repro/models/ssm.py::selective_scan_seq``)
and never runs the Pallas scan there.  ``ssm_scan_bwd`` launches
``csrc/ssm_scan_bwd.cu`` for tensors on the card and runs
``ssm_scan_bwd_plain`` (the reverse recurrence step by step) for tensors on
the CPU; ``SSMScan`` is the ``torch.autograd.Function`` the mamba block
calls, forward through ``ssm_scan`` and backward through ``ssm_scan_bwd``.
The backward kernel reads bf16 u, delta, B and C as they come (u laid
out steps first and B and C as strided slices of one projection, as the
mamba block hands them over), so the model path makes no copies; a lane
holds ``BWD_STATES`` states of one channel, ``bwd_layout`` gives a
channel its lanes and a block its channels, and the state checkpoints go
to a device scratch.  The kernel sums dB and dC over the channels and dA
over batch rows and steps in a fixed order, with no float atomics, so a
rerun gives the same bits.

Both wrappers are ``torch.library`` custom ops (``repro_torch::ssm_scan``,
``repro_torch::ssm_scan_bwd``): the same kernels or plain versions behind
them, plus a fake implementation that gives the outputs' shapes without
computing them (``FakeTensorMode``: the dry-run traces a step on fake
tensors) and a FLOP formula for ``torch.utils.flop_counter`` (the
recurrence's operations per (batch row, step, channel, state),
``SCAN_OPS`` and ``SCAN_BWD_OPS``, counted from the plain versions' lines).
``SSMScan`` stays the autograd function around the two.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.kernels import _build

LANES = 128               # the reference's D tile
DEFAULT_CHUNK = 32
# states in one lane's registers and steps of a lane's round (the
# kernel's build flags REPRO_SSM_STATES and REPRO_SSM_ROUND): at
# falcon-mamba-7b's mixer (batch 1, 8,192 channels, N 16) 4 and 8 were the
# fastest of states 2, 4, 8 x rounds 4, 8, 16 on an H100, and within 5 %
# of the fastest at batch 8 (tools/ssm_scan_probe.py, PERF.md section 6)
STATES_PER_LANE = 4
STEPS_PER_ROUND = 8
WARP = 32
# The backward kernel's build flags: states a lane (REPRO_SSM_BWD_STATES),
# steps between state checkpoints, which the reverse walk recomputes into
# registers (REPRO_SSM_BWD_STEPS), steps a round of the reverse walk, after
# which dB and dC are summed over the block's channels
# (REPRO_SSM_BWD_ROUND), threads a block (REPRO_SSM_BWD_THREADS; a block
# takes BWD_THREADS / lanes channels) and the blocks an SM holds by
# registers (REPRO_SSM_BWD_BLOCKS: at most 65,536 / (BWD_BLOCKS x
# BWD_THREADS) registers a thread).  Chosen with
# tools/ssm_scan_bwd_probe.py on an H100 (PERF.md section 6, row 13): of
# 13 variants (states 1-8, steps 4-16, rounds 4-8, 128-256 threads, 3-4
# blocks) none was faster at both hymba-1.5b's (B 2, L 1,024, D 3,200) and
# falcon-mamba-7b's (D 8,192) widths; 4, 8, 4, 128, 4 ran 0.47 / 0.79 ms
# cold on contiguous B and C (0.49 / 0.82 on the model path's slices), no
# spills, 56 KB of shared memory (so falcon's 512 blocks fit one wave at 4
# an SM); checkpoints every 4 steps were within 2-5 % at twice
# the scratch, rounds of 8 faster at hymba but 72 KB (3 blocks an SM, two
# waves at falcon), 2 states a lane two waves at falcon, 8 states 2x slower.
BWD_STATES = 4
BWD_STEPS = 8
BWD_ROUND = 4
BWD_THREADS = 128
BWD_BLOCKS = 4
BWD_CHUNK = 32            # steps a staged chunk (the kernel's kCh)


def scan_layout(n: int) -> int:
    """Lanes G of one channel in the kernel: ``STATES_PER_LANE`` states
    each, a power of two, at most a warp (past ``WARP * STATES_PER_LANE``
    states the kernel runs passes)."""
    groups = -(-n // STATES_PER_LANE)
    return min(WARP, 1 << max(0, groups - 1).bit_length())


def bwd_lanes(n: int) -> int:
    """Lanes G of one channel in the backward kernel: ``BWD_STATES``
    states each, a power of two, at most a warp (past ``WARP *
    BWD_STATES`` states the kernel runs passes)."""
    groups = -(-n // BWD_STATES)
    return min(WARP, 1 << max(0, groups - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BwdLayout:
    """How ``ssm_scan_bwd`` lays a shape out on the card."""
    lanes: int           # G: lanes a channel
    channels: int        # channels a block, BWD_THREADS / lanes
    states: int          # states a pass, BWD_STATES * lanes
    passes: int
    d_blocks: int        # blocks along D
    blocks: int          # the grid: batch rows x d_blocks
    segments: int        # checkpoints a pass, one every BWD_STEPS steps


def bwd_layout(bt: int, length: int, d: int, n: int) -> BwdLayout:
    """The backward kernel's layout for u of [bt, length, d] and n states;
    the kernel sizes its shared memory itself, the same at every shape of
    one lane count (its checkpoints go to a device scratch of ``segments``
    states a (batch row, channel, pass's state))."""
    lanes = bwd_lanes(n)
    channels = BWD_THREADS // lanes
    states = BWD_STATES * lanes
    d_blocks = d // channels
    return BwdLayout(lanes, channels, states, -(-n // states), d_blocks,
                     bt * d_blocks,
                     -(-length // BWD_CHUNK) * (BWD_CHUNK // BWD_STEPS))


def _dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The plain versions' type: float64 if an operand is, else float32."""
    return torch.float64 if any(t.dtype == torch.float64 for t in tensors) \
        else torch.float32


def _check(u, delta, A, B, C, chunk: int) -> Tuple[int, int, int, int]:
    if u.dim() != 3 or delta.shape != u.shape:
        raise ValueError(f"u and delta must both be [B, L, D], got "
                         f"{tuple(u.shape)}, {tuple(delta.shape)}")
    bt, length, d = u.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"A must be [D={d}, N], got {tuple(A.shape)}")
    n = A.shape[1]
    if B.shape != (bt, length, n) or C.shape != (bt, length, n):
        raise ValueError(f"B and C must be [{bt}, {length}, {n}], got "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if d % LANES or chunk < 1 or length % chunk:
        raise ValueError(f"need D % {LANES} == 0 and L % chunk == 0, got "
                         f"D={d}, L={length}, chunk={chunk}")
    return bt, length, d, n


def ssm_scan_plain(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   chunk: int = DEFAULT_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence step by step in float32 (float64 for
    a float64 operand)."""
    bt, length, d, n = _check(u, delta, A, B, C, chunk)
    f = _dtype(u, delta, A, B, C)
    u, delta, A, B, C = (t.to(f) for t in (u, delta, A, B, C))
    x = torch.zeros((bt, d, n), dtype=f, device=u.device)
    y = torch.empty((bt, length, d), dtype=f, device=u.device)
    for t in range(length):
        dt = delta[:, t, :, None]                                # [Bt, D, 1]
        x = torch.exp(dt * A) * x + (dt * u[:, t, :, None]) * B[:, t, None, :]
        y[:, t] = (x * C[:, t, None, :]).sum(dim=-1)
    return y, x


def ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = DEFAULT_CHUNK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [Bt, L, D] and the final state [Bt, D, N], float32 (float64 from a
    float64 operand on the CPU): the custom op ``repro_torch::ssm_scan``."""
    y, state = torch.ops.repro_torch.ssm_scan(u, delta, A, B, C, int(chunk))
    return y, state


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_scan_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for tensors on the card, the plain version on the CPU."""
    if not _build.on_card(u, delta, A, B, C):
        return ssm_scan_plain(u, delta, A, B, C, chunk)
    bt, length, d, n = _check(u, delta, A, B, C, chunk)
    # float32, contiguous, and (the kernel stages u, delta, B and C with
    # 16-byte copies) on 16-byte lines
    ops = [t.to(torch.float32).contiguous() for t in (u, delta, A, B, C)]
    ops = [t.clone() if t.data_ptr() % 16 else t for t in ops]
    for name, t, nd in zip(("u", "delta", "A", "B", "C"), ops,
                           (3, 3, 2, 3, 3)):
        _build.check_operand(t, name, torch.float32, nd)
    y = torch.empty((bt, length, d), dtype=torch.float32, device=u.device)
    state = torch.empty((bt, d, n), dtype=torch.float32, device=u.device)
    if not state.numel():          # no state: y is an empty sum
        return y.zero_(), state
    _build.launch("ssm_scan", "repro_ssm_scan", u.device,
                  *(t.data_ptr() for t in ops), y.data_ptr(),
                  state.data_ptr(), bt, length, d, n, scan_layout(n))
    return y, state


def _out_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The wrappers' output type: float32 on the card, the plain
    versions' on the CPU."""
    return torch.float32 if tensors[0].device.type != "cpu" else \
        _dtype(*tensors)


@_ssm_scan_op.register_fake
def _ssm_scan_fake(u, delta, A, B, C, chunk):
    bt, length, d, n = _check(u, delta, A, B, C, chunk)
    f = _out_dtype(u, delta, A, B, C)
    return u.new_empty((bt, length, d), dtype=f), \
        u.new_empty((bt, d, n), dtype=f)


# The recurrence's operations per (batch row, step, channel, state), an
# exp counted as one, from the plain versions' lines.  Forward: delta * A,
# its exp, a * x, (delta * u) * B, the add, x * C and y's sum (7), plus
# delta * u per (batch row, step, channel).  Backward: the forward walk
# without y (5), a = exp(delta * A) again (2), g = dy C + carry (2), dC
# (2), dB (2), du (3), ddelta (6), dA (4) and the carry a * g (1) (27),
# plus delta * u in the walk and in dB per (batch row, step, channel), and
# dA's running sum over the steps per (step, channel, state).
SCAN_OPS = 7
SCAN_CHANNEL_OPS = 1
SCAN_BWD_OPS = 27
SCAN_BWD_CHANNEL_OPS = 2


def scan_flops(u_shape, a_shape, backward: bool = False) -> int:
    """The FLOP formula of ``ssm_scan`` (``backward=True``:
    ``ssm_scan_bwd``) for u of ``u_shape`` [Bt, L, D] and A of ``a_shape``
    [D, N]: ``SCAN_OPS`` (``SCAN_BWD_OPS``) per (Bt, L, D, N) plus
    ``SCAN_CHANNEL_OPS`` (``SCAN_BWD_CHANNEL_OPS``) per (Bt, L, D), and
    backward one per (L, D, N)."""
    bt, length, d = u_shape
    n = a_shape[1]
    if backward:
        return ((SCAN_BWD_OPS * n + SCAN_BWD_CHANNEL_OPS) * bt * length * d
                + length * d * n)
    return (SCAN_OPS * n + SCAN_CHANNEL_OPS) * bt * length * d


def _check_bwd(u, delta, A, B, C, dy) -> Tuple[int, int, int, int]:
    dims = _check(u, delta, A, B, C, 1)
    if dy.shape != u.shape:
        raise ValueError(f"dy must be {tuple(u.shape)} as y, got "
                         f"{tuple(dy.shape)}")
    return dims


def ssm_scan_bwd_plain(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward: the states walked forward as
    ``ssm_scan_plain`` walks them, then the reverse recurrence
    g_t = dy_t C_t + a_{t+1} g_{t+1} step by step.  Returns du, ddelta
    [Bt, L, D], dA [D, N], dB, dC [Bt, L, N]."""
    bt, length, d, n = _check_bwd(u, delta, A, B, C, dy)
    f = _dtype(u, delta, A, B, C, dy)
    u, delta, A, B, C, dy = (t.to(f) for t in (u, delta, A, B, C, dy))
    x = torch.zeros((bt, d, n), dtype=f, device=u.device)
    xs = [x]                                        # x_{t-1} at index t
    for t in range(length):
        dt = delta[:, t, :, None]
        x = torch.exp(dt * A) * x + (dt * u[:, t, :, None]) * B[:, t, None, :]
        xs.append(x)
    du = torch.empty((bt, length, d), dtype=f, device=u.device)
    ddelta = torch.empty_like(du)
    dB = torch.empty((bt, length, n), dtype=f, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((d, n), dtype=f, device=u.device)
    carry = torch.zeros((bt, d, n), dtype=f, device=u.device)
    for t in reversed(range(length)):
        dt = delta[:, t, :, None]
        ut, bv = u[:, t, :, None], B[:, t, None, :]
        a = torch.exp(dt * A)
        g = dy[:, t, :, None] * C[:, t, None, :] + carry
        dC[:, t] = (dy[:, t, :, None] * xs[t + 1]).sum(1)
        dB[:, t] = (g * (dt * ut)).sum(1)
        du[:, t] = (g * (dt * bv)).sum(-1)
        ax = A * a * xs[t]
        ddelta[:, t] = (g * (ax + ut * bv)).sum(-1)
        dA += (g * dt * a * xs[t]).sum(0)
        carry = a * g
    return du, ddelta, dA, dB, dC


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous on a 16-byte line (cloned where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _u_operand(u: torch.Tensor, dtype: torch.dtype):
    """u in ``dtype`` and whether it is laid out steps first, as the mamba
    block's causal conv leaves it (the transpose of a contiguous [Bt, D,
    L] on a 16-byte line, L of 16 bytes' worth): the kernel reads that
    layout as it is; anything else is made contiguous."""
    u = u.to(dtype)
    bt, length, d = u.shape
    cols = (not u.is_contiguous() and length > 1 and
            u.stride() == (d * length, 1, length) and
            (length * u.element_size()) % 16 == 0 and u.data_ptr() % 16 == 0)
    return (u, True) if cols else (_aligned(u), False)


def _bc_operands(B: torch.Tensor, C: torch.Tensor, dtype: torch.dtype):
    """B and C in ``dtype`` with unit stride along N, one stride pair for
    both and 4-byte rows: the strided slices of the mamba block's
    projection as they are, anything else copied."""
    B, C = B.to(dtype), C.to(dtype)
    e = B.element_size()
    ok = (B.stride() == C.stride() and B.stride(2) == 1 and
          all((s * e) % 4 == 0 for s in B.stride()[:2]) and
          B.data_ptr() % 4 == 0 and C.data_ptr() % 4 == 0)
    return (B, C) if ok else (_aligned(B), _aligned(C))


def ssm_scan_bwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """du, ddelta [Bt, L, D], dA [D, N], dB, dC [Bt, L, N], float32, for
    ``dy`` over y; the kernel's shape contract is the forward's
    (``D % 128 == 0``, any N, any number of batch rows).  bf16 u, delta,
    B and C (the model path; N even) are read as they are, other types as
    float32 copies, the results the same bits either way; u laid out
    steps first and B and C as strided slices are read in place.  The
    custom op ``repro_torch::ssm_scan_bwd``."""
    return tuple(torch.ops.repro_torch.ssm_scan_bwd(u, delta, A, B, C, dy))


@torch.library.custom_op("repro_torch::ssm_scan_bwd", mutates_args=())
def _ssm_scan_bwd_op(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                     ) -> List[torch.Tensor]:
    """The kernel for tensors on the card, the plain version on the CPU."""
    if not _build.on_card(u, delta, A, B, C, dy):
        return list(ssm_scan_bwd_plain(u, delta, A, B, C, dy))
    bt, length, d, n = _check_bwd(u, delta, A, B, C, dy)
    dev = u.device
    if not (bt and length and n):     # nothing to walk: zero gradients
        return [torch.zeros(s, device=dev)
                for s in _bwd_shapes(bt, length, d, n)]
    bf16 = n % 2 == 0 and all(t.dtype == torch.bfloat16
                              for t in (u, delta, B, C))
    dtype = torch.bfloat16 if bf16 else torch.float32
    u, u_cols = _u_operand(u, dtype)
    delta = _aligned(delta.to(dtype))
    B, C = _bc_operands(B, C, dtype)
    A = A.to(torch.float32).contiguous()
    dy = _aligned(dy.to(torch.float32))
    for name, t, nd in zip(("u", "delta", "A", "B", "C", "dy"),
                           (u, delta, A, B, C, dy), (3, 3, 2, 3, 3, 3)):
        _build.check_operand(t, name, torch.float32 if name in ("A", "dy")
                             else dtype, nd,
                             contiguous=name not in ("u", "B", "C"))
    lay = bwd_layout(bt, length, d, n)
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((bt, length, d), **f32)
    ddelta = torch.empty_like(du)
    ck = torch.empty((bt, lay.segments, d, lay.states), **f32)
    dA_part = torch.empty((bt, d, n), **f32)
    dB_part = torch.empty((lay.d_blocks, bt, length, n), **f32)
    dC_part = torch.empty_like(dB_part)
    dA = torch.empty((d, n), **f32)
    dB = torch.empty((bt, length, n), **f32)
    dC = torch.empty_like(dB)
    _build.launch("ssm_scan_bwd", "repro_ssm_scan_bwd", dev,
                  *(t.data_ptr() for t in (u, delta, A, B, C, dy, ck, du,
                                           ddelta, dA_part, dB_part,
                                           dC_part, dA, dB, dC)),
                  bt, length, d, n, B.stride(0), B.stride(1), int(bf16),
                  int(u_cols), lay.lanes)
    return [du, ddelta, dA, dB, dC]


def _bwd_shapes(bt: int, length: int, d: int, n: int):
    return ((bt, length, d), (bt, length, d), (d, n), (bt, length, n),
            (bt, length, n))


@_ssm_scan_bwd_op.register_fake
def _ssm_scan_bwd_fake(u, delta, A, B, C, dy):
    f = _out_dtype(u, delta, A, B, C, dy)
    return [u.new_empty(s, dtype=f)
            for s in _bwd_shapes(*_check_bwd(u, delta, A, B, C, dy))]


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssm_scan)
    def _fwd(u, delta, A, *args, out_shape=None, **kwargs) -> int:
        return scan_flops(u, A)

    @register_flop_formula(torch.ops.repro_torch.ssm_scan_bwd)
    def _bwd(u, delta, A, *args, out_shape=None, **kwargs) -> int:
        return scan_flops(u, A, backward=True)


_register_flop_formulas()


class SSMScan(torch.autograd.Function):
    """y of the scan, differentiable in u, delta, A, B and C: forward
    through ``ssm_scan``, backward through ``ssm_scan_bwd``; each gradient
    in its input's dtype (bf16 u, delta, B, C and float32 A on the model
    path).  ``SSMScan.apply(u, delta, A, B, C, chunk)``."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, chunk: int = DEFAULT_CHUNK):
        y, _ = ssm_scan(u, delta, A, B, C, chunk=chunk)
        ctx.save_for_backward(u, delta, A, B, C)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        grads = ssm_scan_bwd(*saved, dy)
        return (*(g.to(t.dtype) for g, t in zip(grads, saved)), None)
