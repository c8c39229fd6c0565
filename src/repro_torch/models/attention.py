"""GQA attention: RoPE, causal / sliding-window masks, flash-style blocked
evaluation for long sequences, and decode against (possibly rolling) KV
caches.

Plain PyTorch with the reference's arithmetic: scores in float32 whatever
the operands' dtype, masks as a ``NEG_INF`` bias (so a fully masked row
softmaxes to uniform, not NaN), probabilities cast to V's dtype before the
PV product.  No fused library attention.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models import flags
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def _mask_bias(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """[B, Sq, Sk] float32 additive bias from positions (pos < 0 = invalid)."""
    pq = pos_q[:, :, None]
    pk = pos_k[:, None, :]
    ok = pk >= 0
    if causal:
        ok = ok & (pq >= pk)
    if window > 0:
        ok = ok & (pq - pk < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def _sqrt_dh(dh: int) -> np.float32:
    """sqrt(dh) in float32, as the reference computes it."""
    return np.sqrt(np.float32(dh))


# --------------------------------------------------------------------------- #
# full (materialized-scores) attention: short sequences
# --------------------------------------------------------------------------- #
def attention_full(q, k, v, pos_q, pos_k, *, causal: bool = True,
                   window: int = 0) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,Hkv,dh] -> [B,Sq,H,dh]."""
    H, dh = q.shape[2], q.shape[3]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / float(_sqrt_dh(dh))
    scores = scores + _mask_bias(pos_q, pos_k, causal, window)[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# --------------------------------------------------------------------------- #
# flash-style blocked attention: long sequences
# --------------------------------------------------------------------------- #
def attention_flash(q, k, v, pos_q, pos_k, *, causal: bool = True,
                    window: int = 0, kv_block: int = 1024) -> torch.Tensor:
    """Online softmax over KV blocks of ``kv_block`` (a loop where the
    reference scans); K/V padded to whole blocks with ``pos_k = -1``."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    if Sk % kv_block != 0:
        pad = kv_block - Sk % kv_block
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = torch.nn.functional.pad(pos_k, (0, pad), value=-1)
        Sk += pad
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    qf = q.float()
    scale = float(np.float32(1.0) / _sqrt_dh(dh))

    o = torch.zeros((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for start in range(0, Sk, kv_block):
        blk = slice(start, start + kv_block)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, blk].float()) * scale
        s = s + _mask_bias(pos_q, pos_k[:, blk], causal, window)[:, None]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = (o * corr.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v[:, blk].float()))
        m = m_new
    o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


def attention(q, k, v, pos_q, pos_k, *, causal: bool = True, window: int = 0,
              kv_block: Optional[int] = None,
              use_flash: Optional[bool] = None) -> torch.Tensor:
    """The flash path when K is longer than ``kv_block`` (``flags.kv_block``
    by default), else full attention."""
    if kv_block is None:
        kv_block = flags.kv_block
    if use_flash is None:
        use_flash = k.shape[1] > kv_block
    if use_flash:
        return attention_flash(q, k, v, pos_q, pos_k, causal=causal,
                               window=window, kv_block=kv_block)
    return attention_full(q, k, v, pos_q, pos_k, causal=causal, window=window)


# --------------------------------------------------------------------------- #
# QKV projections
# --------------------------------------------------------------------------- #
def qkv_proj(x, p, rope_theta: float, positions
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D]; p has wq [D,H,dh], wk/wv [D,Hkv,dh]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(o, p) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


# --------------------------------------------------------------------------- #
# decode against a (rolling) KV cache
# --------------------------------------------------------------------------- #
def decode_attention(q, cache_k, cache_v, cache_pos, *,
                     window: int = 0) -> torch.Tensor:
    """q [B,1,H,dh]; cache_k/v [B,Sc,Hkv,dh]; cache_pos [B,Sc] (-1 empty).
    The cache holds roped keys with absolute positions, so their order in
    the buffer does not matter.  ``flags.decode_gqa`` 'repeat' repeats K/V
    to H heads; 'grouped' contracts [B,1,Hkv,G,dh] queries against the raw
    cache.  ``window`` is accepted as in the reference, which ignores it
    here too: a windowed cache rolls, so it holds only the window."""
    B, _, H, dh = q.shape
    Hkv = cache_k.shape[2]
    ok = cache_pos >= 0
    if flags.decode_gqa == "grouped" and H != Hkv:
        G = H // Hkv
        qg = q.reshape(B, 1, Hkv, G, dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache_k.float())
        s = s / float(_sqrt_dh(dh))
        s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(cache_v.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, cache_v)
        return o.reshape(B, 1, H, dh)
    k = _repeat_kv(cache_k, H)
    v = _repeat_kv(cache_v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / float(_sqrt_dh(dh))
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def cache_update(cache_k, cache_v, cache_pos, new_k, new_v, pos: int):
    """Write one token at slot ``pos % Sc`` (rolling for windowed caches).
    The reference returns updated copies; this writes the given tensors in
    place and returns them, so a step moves one token, not the cache."""
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = new_k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = new_v[:, 0].to(cache_v.dtype)
    cache_pos[:, slot] = pos
    return cache_k, cache_v, cache_pos
