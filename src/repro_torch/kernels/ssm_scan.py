"""Selective state-space scan (mamba1), forward only.

Port of ``repro/kernels/ssm_scan.py``:

    x_t = exp(delta_t * A) * x_{t-1} + (delta_t * u_t) * B_t
    y_t = sum_n C_t[n] * x_t[:, n]

u and delta are [Bt, L, D], A is [D, N], B and C are [Bt, L, N], in any
float type, taken as float32; the outputs are y [Bt, L, D] and the final
state [Bt, D, N], both float32.  The reference's shape contract stays:
``D % 128 == 0`` and ``L % chunk == 0`` (a ``ValueError`` here, an
``assert`` there); ``chunk`` changes nothing else, since the recurrence
runs step by step either way.  The JAX package has no backward for it, so
neither has the port.

``ssm_scan`` launches ``csrc/ssm_scan.cu`` for tensors on the card and runs
``ssm_scan_plain`` for tensors on the CPU.  The kernel takes any state
dimension N >= 1 and any number of batch rows (earlier it took N <= 32 and
at most 65,535 rows).  A lane holds ``STATES_PER_LANE`` states of one
channel and ``scan_layout`` gives a channel the lanes its states need; the
kernel walks L step by step, rounding the state as ``ssm_scan_plain``
does.
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


def scan_layout(n: int) -> int:
    """Lanes G of one channel in the kernel: ``STATES_PER_LANE`` states
    each, a power of two, at most a warp (past ``WARP * STATES_PER_LANE``
    states the kernel runs passes)."""
    groups = -(-n // STATES_PER_LANE)
    return min(WARP, 1 << max(0, groups - 1).bit_length())


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
    """Plain version: the recurrence step by step in float32."""
    bt, length, d, n = _check(u, delta, A, B, C, chunk)
    u, delta, A, B, C = (t.to(torch.float32) for t in (u, delta, A, B, C))
    x = torch.zeros((bt, d, n), dtype=torch.float32, device=u.device)
    y = torch.empty((bt, length, d), dtype=torch.float32, device=u.device)
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
