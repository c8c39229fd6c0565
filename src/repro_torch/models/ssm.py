"""Mamba1 selective-SSM block (falcon-mamba, hymba's parallel heads).

The full-sequence block (forward, prefill, loss) runs its selective scan
through ``repro_torch.kernels.ssm_scan.SSMScan``: forward through the
wrapper ``ssm_scan`` (the CUDA kernel ``csrc/ssm_scan.cu`` for tensors on
the card, its plain version for tensors on the CPU), backward through
``ssm_scan_bwd`` (``csrc/ssm_scan_bwd.cu``, or its plain version).  The
reference scans with ``lax.scan`` ('seq') or a chunked associative scan
('chunked'); both are the recurrence the kernel runs, so ``scan_impl``
takes either and raises on anything else.  The kernel needs
``d_inner % 128 == 0``: every published and ``reduced()`` config meets
it, and any other raises its ``ValueError``.

On a mesh (``ctx``, ``models/transformer.py``'s ``ShardCtx``) the block's
operands are DTensors, and the scan runs on each rank's shards through
``local_map`` (``SSMScan`` takes ``data_ptr()`` of plain tensors): u and
delta with their batch over the data axes and ``d_inner`` over `model`, A
``[d_inner, N]`` over `model`, B and C with their batch over the data
axes, whole over `model`.  A's gradient is a partial sum over the data
ranks that split the batch, B's and C's over the `model` ranks that split
``d_inner``, so they come back ``Partial``.  Where a rank's share of
``d_inner`` would not be a multiple of the kernel's 128 lanes, ``d_inner``
stays whole over `model` for the scan (as ``safe_spec`` drops an axis
that does not divide).  The depthwise causal conv runs the same way, per
channel on each rank's shard.

Decode is one recurrence step carrying (conv window, SSM state), both
written in place into the caller's cache (the reference returns copies).
The state stays float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ssm_scan as scan_kernel
from repro_torch.parallel.sharding import (mesh_axes, on_shards,
                                           partial_where, placements)


def log_f32(x: np.ndarray) -> np.ndarray:
    """Natural log of positive float32 values by Cephes' logf polynomial,
    each step rounded to float32: at the integers 1..4,096 (the state
    indices ``A_log`` takes) bit for bit what the reference's ``jnp.log``
    gives on the CPU, where ``torch.log`` and ``np.log`` are an ulp off at
    some (7, 37, 47 and 49 among 1..64)."""
    f = np.float32
    bits = np.asarray(x, np.float32).view(np.int32)
    e = ((bits >> 23) & 0xFF).astype(np.float32) - f(126)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(np.float32)  # [0.5, 1)
    low = m < f(0.707106781186547524)
    x = (m - f(1)) + np.where(low, m, f(0))
    e = e - low.astype(np.float32)
    p = [f(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                        -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                        2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
    x2 = x * x
    x3 = x2 * x
    y = (p[0] * x + p[1]) * x + p[2]
    y1 = (p[3] * x + p[4]) * x + p[5]
    y2 = (p[6] * x + p[7]) * x + p[8]
    y = ((y * x3 + y1) * x3 + y2) * x3
    y = y + e * f(-2.12194440e-4)
    x = x - x2 * f(0.5)
    x = x + y
    return x + e * f(0.693359375)


def a_log_init(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """``A_log`` [L, di, N]: log(1..N) in float32 for every channel, then
    cast, bit for bit the reference's."""
    n = shape[-1]
    row = torch.from_numpy(log_f32(np.arange(1, n + 1, dtype=np.float32)))
    return row.to(device).expand(shape).to(dtype)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor, ctx=None) -> torch.Tensor:
    """Depthwise causal conv, on each rank's shard under ``ctx.mesh``."""
    if ctx is None or ctx.mesh is None:
        return _conv1d_local(x, w, b)
    mesh, dm = ctx.mesh, _split_channels(ctx, x.shape[2], 1)
    xs = placements(mesh, x.shape, (ctx.dp, None, dm))
    ws = placements(mesh, w.shape, (None, dm))
    bs = placements(mesh, b.shape, (dm,))
    # the weights' gradients are partial sums on the dimensions that split
    # the batch
    return on_shards(mesh, _conv1d_local, (xs,), (xs, ws, bs),
                     (xs, partial_where(xs, 0, ws), partial_where(xs, 0, bs))
                     )(x, w, b)


def _conv1d_local(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,di], w [dk,di], b [di]; left-padded
    by dk-1, a cross-correlation as the reference's NWC/WIO conv."""
    dk, di = w.shape
    xp = F.pad(x.transpose(1, 2), (dk - 1, 0))               # [B,di,S+dk-1]
    out = F.conv1d(xp, w.to(x.dtype).t()[:, None, :], groups=di)
    return out.transpose(1, 2) + b.to(x.dtype)


def mamba_features(x: torch.Tensor, p, cfg: ArchConfig, ctx=None):
    """Shared projections: returns (u, dt, A, Bm, Cm, z)."""
    di, N, dtr = cfg.d_inner, cfg.ssm.d_state, cfg.dt_rank
    xz = x @ p["in_proj"].to(x.dtype)
    u, z = xz[..., :di], xz[..., di:]
    u = F.silu(_conv1d_causal(u, p["conv_w"], p["conv_b"], ctx))
    x_dbl = u @ p["x_proj"].to(x.dtype)
    dt_in = x_dbl[..., :dtr]
    Bm = x_dbl[..., dtr:dtr + N]
    Cm = x_dbl[..., dtr + N:]
    dt = F.softplus(dt_in @ p["dt_proj"].to(x.dtype) + p["dt_bias"].to(x.dtype))
    A = -torch.exp(p["A_log"].float())
    return u, dt, A, Bm, Cm, z


SCAN_IMPLS = ("seq", "chunked")


def _split_channels(ctx, d: int, tile: int):
    """`model` where it splits d channels into shares of whole ``tile``s,
    else None."""
    model = mesh_axes(ctx.mesh)["model"]
    return "model" if d % model == 0 and (d // model) % tile == 0 else None


def selective_scan(u, dt, A, Bm, Cm, chunk: int, ctx=None) -> torch.Tensor:
    """y of ``SSMScan`` (the kernels), on each rank's shards under
    ``ctx.mesh`` with the gradients' partial sums placed as ``Partial``."""
    if ctx is None or ctx.mesh is None:
        return scan_kernel.SSMScan.apply(u, dt, A, Bm, Cm, chunk)
    mesh, dm = ctx.mesh, _split_channels(ctx, u.shape[2], scan_kernel.LANES)
    act = placements(mesh, u.shape, (ctx.dp, None, dm))
    a = placements(mesh, A.shape, (dm, None))
    bc = placements(mesh, Bm.shape, (ctx.dp, None, None))
    # A's gradient is a partial sum on the mesh dimensions that split the
    # batch, B's and C's on those that split d_inner
    da, dbc = partial_where(act, 0, a), partial_where(act, 2, bc)
    run = on_shards(mesh, scan_kernel.SSMScan.apply, (act,),
                    (act, act, a, bc, bc, None),
                    (act, act, da, dbc, dbc, None))
    return run(u, dt, A, Bm, Cm, chunk)


def mamba_block(x: torch.Tensor, p, cfg: ArchConfig,
                scan_impl: str = "seq", ctx=None) -> torch.Tensor:
    """Full-sequence mamba block (training / prefill).  The scan's chunk
    divides L, so a prompt of any length runs; the kernel steps through L
    whatever the chunk."""
    if scan_impl not in SCAN_IMPLS:
        raise ValueError(f"scan_impl must be 'seq' or 'chunked', got "
                         f"{scan_impl!r}")
    u, dt, A, Bm, Cm, z = mamba_features(x, p, cfg, ctx)
    chunk = math.gcd(x.shape[1], scan_kernel.DEFAULT_CHUNK)
    y = selective_scan(u, dt, A, Bm, Cm, chunk, ctx)
    y = y.to(x.dtype) + p["D"].to(x.dtype) * u
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


# --------------------------------------------------------------------------- #
# decode (single step)
# --------------------------------------------------------------------------- #
def mamba_decode_step(x: torch.Tensor, p, cfg: ArchConfig,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,1,D]; conv_state [B,dk-1,di]; ssm_state [B,di,N] (float32),
    both updated in place.  Returns (y [B,1,D], conv_state, ssm_state)."""
    di, N, dtr = cfg.d_inner, cfg.ssm.d_state, cfg.dt_rank
    xz = x @ p["in_proj"].to(x.dtype)
    u, z = xz[..., :di], xz[..., di:]                          # [B,1,di]
    win = torch.cat([conv_state, u], dim=1)                    # [B,dk,di]
    w = p["conv_w"].to(x.dtype)                                # [dk,di]
    u_c = (win * w[None]).sum(1, keepdim=True) + p["conv_b"].to(x.dtype)
    u_c = F.silu(u_c)
    conv_state.copy_(win[:, 1:])
    x_dbl = u_c @ p["x_proj"].to(x.dtype)
    dt = F.softplus(x_dbl[..., :dtr] @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype))
    Bm = x_dbl[:, 0, dtr:dtr + N].float()
    Cm = x_dbl[:, 0, dtr + N:].float()
    A = -torch.exp(p["A_log"].float())
    dt_f = dt[:, 0].float()                                    # [B,di]
    a = torch.exp(dt_f[..., None] * A)                         # [B,di,N]
    state = a * ssm_state + (dt_f * u_c[:, 0].float())[..., None] \
        * Bm[:, None, :]
    ssm_state.copy_(state)
    y = (state * Cm[:, None, :]).sum(-1)
    y = y[:, None, :].to(x.dtype) + p["D"].to(x.dtype) * u_c
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype), conv_state, ssm_state
