"""GQA attention: RoPE, causal / sliding-window masks, flash-style blocked
evaluation for long sequences, and decode against (possibly rolling) KV
caches.

Plain PyTorch with the reference's arithmetic: scores in float32 whatever
the operands' dtype, masks as a ``NEG_INF`` bias (so a fully masked row
softmaxes to uniform, not NaN), probabilities cast to V's dtype before the
PV product.  No fused library attention.

On a mesh (``transformer.ShardCtx``) each attention runs on the rank's
shards through ``local_map``: ``attention_mesh`` on the rank's batch rows
and q heads ('head') or q rows ('seqq') with the K/V heads it reads, so no
product sees a dimension split over two mesh axes (DTensor folds batch
and heads into one ``bmm`` dimension, a ``_StridedShard`` that it cannot
cost on fake tensors); ``decode_attention_mesh`` on the rank's share of a
cache whose sequence is split, the softmax's max and sum and the PV
product's partial sums combined over the ranks that split it, as GSPMD
partitions the reference's reduction; ``cache_update_mesh`` writes the
new token on the rank that holds its slot.
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
def _decode_scores(q, cache_k, cache_pos) -> torch.Tensor:
    """Masked float32 scores of q [B,1,H,dh] against the cache:
    [B,H,1,Sc] ('repeat'), or [B,Hkv,G,1,Sc] ('grouped' with G > 1)."""
    B, _, H, dh = q.shape
    Hkv = cache_k.shape[2]
    ok = cache_pos >= 0
    if flags.decode_gqa == "grouped" and H != Hkv:
        qg = q.reshape(B, 1, Hkv, H // Hkv, dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache_k.float())
        s = s / float(_sqrt_dh(dh))
        return torch.where(ok[:, None, None, None, :], s, NEG_INF)
    k = _repeat_kv(cache_k, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s / float(_sqrt_dh(dh))
    return torch.where(ok[:, None, None, :], s, NEG_INF)


def _decode_out(p, cache_v, q_shape) -> torch.Tensor:
    """The PV product of ``_decode_scores``' probabilities: [B,1,H,dh]."""
    B, _, H, dh = q_shape
    if p.dim() == 5:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, cache_v)
        return o.reshape(B, 1, H, dh)
    return torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(cache_v, H))


def decode_attention(q, cache_k, cache_v, cache_pos, *,
                     window: int = 0) -> torch.Tensor:
    """q [B,1,H,dh]; cache_k/v [B,Sc,Hkv,dh]; cache_pos [B,Sc] (-1 empty).
    The cache holds roped keys with absolute positions, so their order in
    the buffer does not matter.  ``flags.decode_gqa`` 'repeat' repeats K/V
    to H heads; 'grouped' contracts [B,1,Hkv,G,dh] queries against the raw
    cache.  ``window`` is accepted as in the reference, which ignores it
    here too: a windowed cache rolls, so it holds only the window."""
    s = _decode_scores(q, cache_k, cache_pos)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    return _decode_out(p, cache_v, q.shape)


def cache_update(cache_k, cache_v, cache_pos, new_k, new_v, pos: int):
    """Write one token at slot ``pos % Sc`` (rolling for windowed caches).
    The reference returns updated copies; this writes the given tensors in
    place and returns them, so a step moves one token, not the cache."""
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = new_k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = new_v[:, 0].to(cache_v.dtype)
    cache_pos[:, slot] = pos
    return cache_k, cache_v, cache_pos


# --------------------------------------------------------------------------- #
# on a mesh
# --------------------------------------------------------------------------- #
def _kv_heads(k: torch.Tensor, n_heads: int, lo: int,
              n_local: int) -> torch.Tensor:
    """The K/V heads that q heads ``lo`` .. ``lo + n_local - 1`` of
    ``n_heads`` read (GQA groups of ``n_heads // Hkv``): a view where they
    are whole groups or lie in one group, else gathered."""
    if n_local == n_heads:
        return k
    g = n_heads // k.shape[2]
    if n_local % g == 0 or g % n_local == 0:
        return k.narrow(2, lo // g, max(1, n_local // g))
    idx = torch.arange(lo, lo + n_local, device=k.device) // g
    return k.index_select(2, idx)


def heads_mesh(x, ws, ctx, mode: str, q_first: bool = False,
               rope_theta: float = 0.0, positions=None):
    """``einsum('bsd,dhk->bshk', x, w)`` for each w of ``ws`` [D, H, dh] on
    each rank's shards of ``ctx.mesh`` (``qkv_proj``'s products, the first
    two roped where ``rope_theta > 0``, in its order): x's rows as they are
    split (batch over the data axes, in 'seqq' mode its sequence over
    `model`) against weights whole on those ranks, and with ``q_first`` in
    'head' mode the first one's heads over `model`.  DTensor would split a
    product's flattened heads x dh over `model` and then cannot unflatten
    it where `model` does not divide the heads (K/V's 8 at 16).  Each
    weight's gradient is a partial sum over the ranks that split x's rows;
    x's is one over `model` where the first one's heads split there, each
    rank taking 1 / `model` of the others' (``sharding.grad_scaled``)."""
    from repro_torch.parallel import sharding
    mesh, dp = ctx.mesh, ctx.dp
    seq = "model" if mode == "seqq" else None
    B, S = x.shape[:2]
    xs = sharding.placements(mesh, x.shape, (dp, seq, None))
    heads = ["model" if q_first and i == 0 and mode == "head" else None
             for i in range(len(ws))]
    wps = [sharding.placements(mesh, w.shape, (None, h, None))
           for w, h in zip(ws, heads)]
    outs = [sharding.placements(mesh, (B, S) + tuple(w.shape[1:]),
                                (dp, seq, h, None))
            for w, h in zip(ws, heads)]
    mdim = sharding.mesh_dim(mesh, "model")
    m = mesh.size(mdim) if heads[0] and outs[0][mdim].is_shard() else 1
    xg = sharding.partial_where(outs[0], 2, xs) if m > 1 else xs
    wgs = [sharding.partial_where_split(xs, w) for w in wps]
    roped = rope_theta > 0

    def run(x, *rest):
        xr = sharding.grad_scaled(x, 1.0 / m)
        out = [torch.einsum("bsd,dhk->bshk", x if i == 0 and m > 1 else xr,
                            w.to(x.dtype))
               for i, w in enumerate(rest[:len(ws)])]
        if roped:
            pos = rest[len(ws)]
            out[:2] = [apply_rope(o, pos, rope_theta) for o in out[:2]]
        return tuple(out)

    args = [x, *ws]
    ins, grads = [xs, *wps], [xg, *wgs]
    if roped:
        pp = sharding.placements(mesh, positions.shape, (dp, seq))
        args.append(sharding.place(positions, mesh, pp))
        ins.append(pp)
        grads.append(pp)
    return sharding.on_shards(mesh, run, tuple(outs), tuple(ins),
                              tuple(grads))(*args)


def attention_mesh(q, k, v, pos_q, pos_k, ctx, mode: str, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """``attention`` on each rank's shards of ``ctx.mesh``: its batch rows
    over the data axes and its q heads ('head') or q rows ('seqq') over
    `model`, against its batch rows of K/V, whole over `model` (in 'head'
    mode only the K/V heads its q heads read).  The result stays so
    placed; K's and V's gradients are partial sums over `model`."""
    from repro_torch.parallel import sharding
    mesh, dp = ctx.mesh, ctx.dp
    d = 2 if mode == "head" else 1
    spec = [dp, None, None, None]
    spec[d] = "model"
    qs = sharding.placements(mesh, q.shape, spec)
    pqs = sharding.placements(mesh, pos_q.shape,
                              (dp, "model" if d == 1 else None))
    kvs = sharding.placements(mesh, k.shape, (dp, None, None, None))
    pks = sharding.placements(mesh, pos_k.shape, (dp, None))
    kvg = sharding.partial_where(qs, d, kvs)
    H = q.shape[2]
    mdim = sharding.mesh_dim(mesh, "model")
    split = d == 2 and qs[mdim].is_shard()
    n_local = H // mesh.size(mdim) if split else H
    lo = mesh.get_local_rank("model") * n_local if split else 0

    def run(q, k, v, pq, pk):
        if d == 2:
            k = _kv_heads(k, H, lo, n_local)
            v = _kv_heads(v, H, lo, n_local)
        return attention(q, k, v, pq, pk, causal=causal, window=window)

    pos_q = sharding.place(pos_q, mesh, pqs)
    pos_k = sharding.place(pos_k, mesh, pks)
    return sharding.on_shards(mesh, run, (qs,), (qs, kvs, kvs, pqs, pks),
                              (qs, kvg, kvg, pqs, pks))(q, k, v, pos_q, pos_k)


def _cache_layout(cache_k):
    """(mesh dimensions that split the cache's batch, those that split its
    sequence) of a DTensor cache [B, Sc, ...]."""
    from torch.distributed.tensor import Shard
    pl = cache_k.placements
    return ([i for i, p in enumerate(pl) if p == Shard(0)],
            [i for i, p in enumerate(pl) if p == Shard(1)])


def _rows_only(mesh, rows):
    """``Shard(0)`` on the mesh dimensions ``rows``, ``Replicate``
    elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if i in rows else Replicate()
                 for i in range(mesh.ndim))


def decode_attention_mesh(q, cache_k, cache_v, cache_pos, *,
                          window: int = 0) -> torch.Tensor:
    """``decode_attention`` on the rank's share of a DTensor cache: q's
    batch rows as the cache's, its heads whole; where ranks split the
    cache's sequence, each takes its scores' max, the exp-sum and the PV
    product over its slots, and the max, the sums and the products are
    combined over those ranks (all-reduces of [B, H] and [B, 1, H, dh]);
    where none does, ``decode_attention`` itself on the rank's rows, the
    same bits as without a mesh.  The result [B,1,H,dh] has its rows as
    the cache's, whole elsewhere."""
    from repro_torch.parallel import sharding
    mesh = cache_k.device_mesh
    rows, seq = _cache_layout(cache_k)
    qs = _rows_only(mesh, rows)
    cs, ps = tuple(cache_k.placements), tuple(cache_pos.placements)

    def run(q, k, v, pos):
        if not seq:
            return decode_attention(q, k, v, pos, window=window)
        import torch.distributed._functional_collectives as funcol
        s = _decode_scores(q, k, pos)
        m = s.amax(-1, keepdim=True)
        for i in seq:
            m = funcol.all_reduce(m, "max", (mesh, i))
        e = torch.exp(s - m)
        total = e.sum(-1, keepdim=True)
        for i in seq:
            total = funcol.all_reduce(total, "sum", (mesh, i))
        o = _decode_out((e / total).to(v.dtype), v, q.shape)
        for i in seq:
            o = funcol.all_reduce(o, "sum", (mesh, i))
        return o.wait() if isinstance(o, funcol.AsyncCollectiveTensor) else o

    return sharding.on_shards(mesh, run, (qs,), (qs, cs, cs, ps))(
        sharding.place(q, mesh, qs), cache_k, cache_v, cache_pos)


def cache_update_mesh(cache_k, cache_v, cache_pos, new_k, new_v, pos: int):
    """``cache_update`` of DTensor caches: the rank whose share of the
    sequence holds slot ``pos % Sc`` writes the new token's K/V rows (its
    batch rows, as the cache's) into its local shards, in place; the
    others write nothing."""
    from repro_torch.parallel import sharding
    mesh = cache_k.device_mesh
    slot = pos % cache_k.shape[1]
    rows, seq = _cache_layout(cache_k)
    # this rank's share of the sequence: even shares (``safe_spec``), split
    # over the mesh dimensions ``seq`` major to minor, as DTensor splits
    coord, n_seq, idx = mesh.get_coordinate(), cache_k.shape[1], 0
    for i in seq:
        idx = idx * mesh.size(i) + coord[i]
        n_seq //= mesh.size(i)
    off = idx * n_seq
    # every rank takes its rows of the new token (a collective), one writes
    at = _rows_only(mesh, rows)
    news = [sharding.place(t, mesh, at).to_local() for t in (new_k, new_v)]
    if off <= slot < off + n_seq:
        for cache, new in zip((cache_k, cache_v), news):
            cache.to_local()[:, slot - off] = new[:, 0].to(cache.dtype)
        cache_pos.to_local()[:, slot - off] = pos
    return cache_k, cache_v, cache_pos
