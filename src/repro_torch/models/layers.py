"""Shared model layers: norms, RoPE, sinusoidal positions, SwiGLU MLP,
init."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ wg.to(x.dtype))
    u = x @ wu.to(x.dtype)
    return (g * u) @ wd.to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] int.  Split halves (not
    interleaved pairs), in float32, cast back."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                # [dh/2]
    ang = positions[..., None].float() * freqs              # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal position embeddings [seq_len, d_model]
    (the encoder-decoder family): computed in numpy float64, then cast to
    float32, so they equal the reference's bit for bit."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d_model)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# --------------------------------------------------------------------------- #
# init helpers: normal draws in float32 from the caller's generator, on the
# generator's device
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, fan_in: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(0.02).to(dtype)
