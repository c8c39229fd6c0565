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
The kernel sums dB and dC over the channels and dA over batch rows and
steps in a fixed order, with no float atomics, so a rerun gives the same
bits.
"""

from __future__ import annotations

from typing import Tuple

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
# steps between the backward kernel's state checkpoints (its build flag
# REPRO_SSM_BWD_STEPS): the reverse walk recomputes a chunk of them into
# registers from its checkpoint
BWD_STEPS = 16
BWD_THREADS = 128


def scan_layout(n: int) -> int:
    """Lanes G of one channel in the kernel: ``STATES_PER_LANE`` states
    each, a power of two, at most a warp (past ``WARP * STATES_PER_LANE``
    states the kernel runs passes)."""
    groups = -(-n // STATES_PER_LANE)
    return min(WARP, 1 << max(0, groups - 1).bit_length())


def bwd_layout(n: int) -> int:
    """Lanes G of one channel in the backward kernel: one state a lane, a
    power of two, at most a warp (past ``WARP`` states it runs passes)."""
    return min(WARP, 1 << max(0, n - 1).bit_length())


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
    """y [Bt, L, D] and the final state [Bt, D, N], float32."""
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


def ssm_scan_bwd(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """du, ddelta [Bt, L, D], dA [D, N], dB, dC [Bt, L, N], float32, for
    ``dy`` over y; the kernel's shape contract is the forward's
    (``D % 128 == 0``, any N, any number of batch rows)."""
    if not _build.on_card(u, delta, A, B, C, dy):
        return ssm_scan_bwd_plain(u, delta, A, B, C, dy)
    bt, length, d, n = _check_bwd(u, delta, A, B, C, dy)
    ops = [t.to(torch.float32).contiguous() for t in (u, delta, A, B, C, dy)]
    for name, t, nd in zip(("u", "delta", "A", "B", "C", "dy"), ops,
                           (3, 3, 2, 3, 3, 3)):
        _build.check_operand(t, name, torch.float32, nd)
    dev = u.device
    du = torch.zeros((bt, length, d), dtype=torch.float32, device=dev)
    ddelta = torch.zeros_like(du)
    if not (bt and length and n):     # nothing to walk: zero gradients
        return (du, ddelta, torch.zeros((d, n), device=dev),
                torch.zeros((bt, length, n), device=dev),
                torch.zeros((bt, length, n), device=dev))
    g = bwd_layout(n)
    blocks = d // (BWD_THREADS // g)
    chunks = -(-length // BWD_STEPS)
    ck = torch.empty((bt, chunks, d, n), dtype=torch.float32, device=dev)
    dA = torch.empty((bt, d, n), dtype=torch.float32, device=dev)
    dB = torch.empty((bt, length, blocks, n), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    _build.launch("ssm_scan_bwd", "repro_ssm_scan_bwd", dev,
                  *(t.data_ptr() for t in ops), ck.data_ptr(),
                  du.data_ptr(), ddelta.data_ptr(), dA.data_ptr(),
                  dB.data_ptr(), dC.data_ptr(), bt, length, d, n, g)
    return du, ddelta, dA.sum(0), dB.sum(2), dC.sum(2)


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
