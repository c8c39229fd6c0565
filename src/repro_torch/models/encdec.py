"""Encoder-decoder backbone (whisper-small).

The conv audio frontend is a stub, as in the reference: the encoder
consumes precomputed frame embeddings [B, S_enc, d_model].  Sinusoidal
positions stand in for Whisper's learned/sinusoidal tables.  The decoder
is a causal LM with per-layer cross-attention over the encoder output;
decode carries a self-attention cache, written in place and rolling at
``pos % dec_len``, plus static cross-attention K/V that ``prefill``
computes once.

Parameters keep the reference's tree and leaf names, stacked ``[L, ...]``
(``enc_layers.attn.wq`` is ``[Le, D, H, dh]``, ``dec_layers.xattn.wv``
``[Ld, D, H, dh]``), held by ``EncDecLM``.  Every attention here has H
key/value heads and no rope.  A loop over layers stands where the
reference scans, each layer under ``transformer.remat`` with
``cfg.remat`` (the reference's ``jax.checkpoint``).  ``param_specs`` and
``cache_specs`` give the reference's specs from the leaves' shapes alone.

``encode``, ``decode_train``, ``lm_loss``, ``prefill`` and ``decode_step``
take a ``ctx`` (``transformer.ShardCtx``) and place the reference's
constraints; each attention then runs on the rank's shards
(``attention.attention_mesh``), in 'seqq' mode where `model` does not
divide the heads (whisper's 12 at 16), its output projection through
``transformer._seqq_out_proj``; a decode step writes and reads the
caches on the ranks that hold their slots.  As in the reference,
``serving_layout`` does not replicate this family's batch.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (dense_init, embed_init, rms_norm,
                                       sinusoidal_pos, swiglu)
from repro_torch.models import flags
from repro_torch.models.transformer import (Params, ShardCtx, Tree, _attach,
                                            _ctx, _layer, _seqq_out_proj,
                                            _spec_of, _tree_of, _unstack,
                                            _xent, as_tree, dtype_of,
                                            head_logits, nest_tree, remat)
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (P, attn_mode, dp_axes, fsdp_axis,
                                           tp_size)

# decoder token length = encoder frames / TOKEN_RATIO for train/prefill
TOKEN_RATIO = 8


def dec_len_for(seq_len: int) -> int:
    return max(16, seq_len // TOKEN_RATIO)


def leaf_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter leaf by its dotted name, with its shape."""
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name}: a decoder-only config; use "
                         "repro_torch.models.transformer")
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    D, F, H, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    Vp = cfg.padded_vocab

    def attn(prefix, L):
        return {f"{prefix}.wq": (L, D, H, dh), f"{prefix}.wk": (L, D, H, dh),
                f"{prefix}.wv": (L, D, H, dh), f"{prefix}.wo": (L, H, dh, D)}

    def mlp(prefix, L):
        return {f"{prefix}.wg": (L, D, F), f"{prefix}.wu": (L, D, F),
                f"{prefix}.wd": (L, F, D)}

    return {
        "embed": (Vp, D),
        **attn("enc_layers.attn", Le), **mlp("enc_layers.mlp", Le),
        "enc_layers.ln1": (Le, D), "enc_layers.ln2": (Le, D),
        **attn("dec_layers.attn", Ld), **attn("dec_layers.xattn", Ld),
        **mlp("dec_layers.mlp", Ld),
        "dec_layers.ln1": (Ld, D), "dec_layers.ln2": (Ld, D),
        "dec_layers.ln3": (Ld, D),
        "enc_norm": (D,), "dec_norm": (D,), "lm_head": (Vp, D),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Tree:
    """Random parameters on ``gen``'s device, one leaf at a time (each drawn
    in float32, then cast to the config's dtype); norms are ones."""
    dt = dtype_of(cfg)
    D = cfg.d_model
    fan_in = {"wq": D, "wk": D, "wv": D, "wo": cfg.n_heads * cfg.head_dim,
              "wg": D, "wu": D, "wd": cfg.d_ff}
    flat = {}
    for name, shape in leaf_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in fan_in:
            flat[name] = dense_init(gen, shape, fan_in[leaf], dt)
        elif leaf in ("embed", "lm_head"):
            flat[name] = embed_init(gen, shape, dt)
        else:
            flat[name] = torch.ones(shape, dtype=dt, device=gen.device)
    return nest_tree(flat)


def param_specs(cfg: ArchConfig, mesh, fsdp_over_pod: bool = False,
                layout: str = "train") -> Tree:
    """The parameter tree's specs, from the leaves' shapes alone.
    whisper-small is ~240M params and its train layout also serves, so
    ``layout`` ('serve2d') changes nothing here, as in the reference."""
    fs = fsdp_axis(mesh, fsdp_over_pod)
    sp = _spec_of(leaf_shapes(cfg), mesh)

    def attn_sp(stack):  # whisper: 12 heads, not TP-divisible -> 'seqq'
        return {
            "wq": sp(f"{stack}.wq", None, fs, None, None),
            "wk": sp(f"{stack}.wk", None, fs, None, None),
            "wv": sp(f"{stack}.wv", None, fs, None, None),
            "wo": sp(f"{stack}.wo", None, None, None, fs),
        }

    def mlp_sp(stack):
        return {
            "wg": sp(f"{stack}.wg", None, fs, "model"),
            "wu": sp(f"{stack}.wu", None, fs, "model"),
            "wd": sp(f"{stack}.wd", None, "model", fs),
        }

    return {
        "embed": sp("embed", "model", fs),
        "enc_layers": {
            "attn": attn_sp("enc_layers.attn"),
            "mlp": mlp_sp("enc_layers.mlp"),
            "ln1": P(None, None), "ln2": P(None, None),
        },
        "dec_layers": {
            "attn": attn_sp("dec_layers.attn"),
            "xattn": attn_sp("dec_layers.xattn"),
            "mlp": mlp_sp("dec_layers.mlp"),
            "ln1": P(None, None), "ln2": P(None, None), "ln3": P(None, None),
        },
        "enc_norm": P(None),
        "dec_norm": P(None),
        "lm_head": sp("lm_head", "model", fs),
    }


class EncDecLM(nn.Module):
    """The parameters under the reference's names (``named_parameters``
    gives ``enc_layers.attn.wq`` ... ``lm_head``).  They do not require
    grad, so serving builds no autograd graph; the train step
    differentiates through detached aliases of the leaves that do."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        _attach(self, tree)

    def tree(self) -> Tree:
        return _tree_of(self)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _cross_kv(enc_out, lp, cfg: ArchConfig, ctx: ShardCtx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K/V [B, Se, H, dh] (no rope).
    Without a mesh they read enc_out through a view of their own, so the
    two gradients are summed before the other layers' are added, in one
    order on a mesh (one ``local_map`` a layer) or off it."""
    ap = lp["xattn"]
    if ctx.mesh is not None:
        return attn_mod.heads_mesh(enc_out, [ap["wk"], ap["wv"]], ctx,
                                   _mode(cfg, ctx))
    e = enc_out.view_as(enc_out)
    kx = torch.einsum("bsd,dhk->bshk", e, ap["wk"].to(e.dtype))
    vx = torch.einsum("bsd,dhk->bshk", e, ap["wv"].to(e.dtype))
    return kx, vx


def _cross_q(h, lp, cfg: ArchConfig, ctx: ShardCtx) -> torch.Tensor:
    ap = lp["xattn"]
    if ctx.mesh is not None:
        return attn_mod.heads_mesh(h, [ap["wq"]], ctx, _mode(cfg, ctx),
                                   True)[0]
    return torch.einsum("bsd,dhk->bshk", h, ap["wq"].to(h.dtype))


def _qkv(h, ap, pos, cfg: ArchConfig, ctx: ShardCtx):
    """Self-attention's q, k, v (no rope)."""
    if ctx.mesh is not None:
        return attn_mod.heads_mesh(h, [ap["wq"], ap["wk"], ap["wv"]], ctx,
                                   _mode(cfg, ctx), True)
    return attn_mod.qkv_proj(h, ap, 0.0, pos)


def _mlp(x, lp, norm: str, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, lp[norm], cfg.norm_eps)
    return x + swiglu(h, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])


def _mode(cfg: ArchConfig, ctx: ShardCtx) -> str:
    return attn_mode(cfg.n_heads, tp_size(ctx.mesh))


def _attend(q, k, v, pos_q, pos_k, causal: bool, ap, cfg: ArchConfig,
            ctx: ShardCtx) -> torch.Tensor:
    """Attention and its output projection (``ap``'s ``wo``): on a mesh on
    each rank's shards, 'seqq' where `model` does not divide the heads."""
    if ctx.mesh is None:
        o = attn_mod.attention(q, k, v, pos_q, pos_k, causal=causal)
        return attn_mod.out_proj(o, ap)
    mode = _mode(cfg, ctx)
    o = attn_mod.attention_mesh(q, k, v, pos_q, pos_k, ctx, mode,
                                causal=causal)
    if mode == "seqq":
        return _seqq_out_proj(o, ap["wo"], ctx)
    return attn_mod.out_proj(o, ap)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig,
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """frames [B, Se, D] -> enc_out [B, Se, D] in the model's dtype:
    non-causal self-attention (the blocked flash path past
    ``flags.kv_block`` frames)."""
    ctx = _ctx(ctx)
    p = as_tree(params)
    B, S, D = frames.shape
    dt = dtype_of(cfg)
    with ctx.scope():
        x = frames.to(dt) + sinusoidal_pos(S, D, frames.device)[None].to(dt)
        x = ctx.constrain(x, ctx.dp, None, None)
        pos = _positions(B, S, frames.device)
        for lp in _unstack(p["enc_layers"], cfg.n_enc_layers):
            x = remat(cfg.remat, _enc_layer, x, lp, pos, cfg, ctx)
        return rms_norm(x, p["enc_norm"], cfg.norm_eps)


def _enc_layer(x, lp, pos, cfg: ArchConfig, ctx: ShardCtx) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h = ctx.constrain(h, ctx.dp, "model", None)
    q, k, v = _qkv(h, lp["attn"], pos, cfg, ctx)
    x = x + _attend(q, k, v, pos, pos, False, lp["attn"], cfg, ctx)
    return _mlp(x, lp, "ln2", cfg)


def decode_train(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ArchConfig, ctx: Optional[ShardCtx] = None
                 ) -> torch.Tensor:
    """tokens [B, S], enc_out [B, Se, D] -> logits [B, S, Vp]: causal
    self-attention, cross-attention over ``enc_out``, then the MLP."""
    ctx = _ctx(ctx)
    p = as_tree(params)
    B, S = tokens.shape
    dt = dtype_of(cfg)
    with ctx.scope():
        x = p["embed"][tokens].to(dt)
        x = x + sinusoidal_pos(S, cfg.d_model, x.device)[None].to(dt)
        x = ctx.constrain(x, ctx.dp, None, None)
        pos = _positions(B, S, x.device)
        pos_e = _positions(B, enc_out.shape[1], x.device)
        for lp in _unstack(p["dec_layers"], cfg.n_layers):
            x = remat(cfg.remat, _dec_layer, x, lp, enc_out, pos, pos_e, cfg,
                      ctx)
        x = rms_norm(x, p["dec_norm"], cfg.norm_eps)
        return head_logits(x, p["lm_head"].to(dt), ctx)


def _dec_layer(x, lp, enc_out, pos, pos_e, cfg: ArchConfig,
               ctx: ShardCtx) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, lp["attn"], pos, cfg, ctx)
    x = x + _attend(q, k, v, pos, pos, True, lp["attn"], cfg, ctx)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    kx, vx = _cross_kv(enc_out, lp, cfg, ctx)
    x = x + _attend(_cross_q(h2, lp, cfg, ctx), kx, vx, pos, pos_e, False,
                    lp["xattn"], cfg, ctx)
    return _mlp(x, lp, "ln3", cfg)


def lm_loss(params: Params, batch, cfg: ArchConfig,
            ctx: Optional[ShardCtx] = None, scan_impl: str = "seq"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy; batch = {'frames', 'tokens', 'labels',
    'mask'}; aux is 0.  ``scan_impl`` is taken as the reference takes it
    and unused: the family has no SSM."""
    ctx = _ctx(ctx)
    enc_out = encode(params, batch["frames"], cfg, ctx)
    logits = decode_train(params, batch["tokens"], enc_out, cfg, ctx)
    with ctx.scope():
        logits = ctx.constrain(logits, ctx.dp, None, "model")
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return _xent(logits, batch, aux, cfg)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ArchConfig, batch: int, enc_len: int, dec_len: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """Leading Ld: a zero self cache of ``dec_len`` slots (default
    ``dec_len_for(enc_len)``) with positions -1, and zero cross K/V of
    ``enc_len`` frames, until ``prefill``'s fill them."""
    dt = dtype_of(cfg)
    Ld, H, dh = cfg.n_layers, cfg.n_heads, cfg.head_dim
    dec_len = dec_len or dec_len_for(enc_len)

    def zeros(S):
        return torch.zeros((Ld, batch, S, H, dh), dtype=dt, device=device)

    return {"k": zeros(dec_len), "v": zeros(dec_len),
            "pos": torch.full((Ld, batch, dec_len), -1, dtype=torch.int32,
                              device=device),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def cache_specs(cfg: ArchConfig, mesh, layout: str = "batch") -> Tree:
    """'batch': batch over the data axes, sequence over `model`; 'tp2d':
    batch replicated, sequence over both."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    if layout == "tp2d":
        both = tuple(dp) + ("model",)
        return {
            "k": P(None, None, both, None, None),
            "v": P(None, None, both, None, None),
            "pos": P(None, None, both),
            "xk": P(None, None, both, None, None),
            "xv": P(None, None, both, None, None),
        }
    return {
        "k": P(None, dpa, "model", None, None),
        "v": P(None, dpa, "model", None, None),
        "pos": P(None, dpa, "model"),
        "xk": P(None, dpa, "model", None, None),
        "xv": P(None, dpa, "model", None, None),
    }


@functools.lru_cache(maxsize=8)
def _pos_table(Sd: int, D: int, dt: torch.dtype, device) -> torch.Tensor:
    """``sinusoidal_pos(Sd, D)`` in the model's dtype, kept for the decode
    steps (read only)."""
    return sinusoidal_pos(Sd, D, device).to(dt)


def _pos_row(Sd: int, D: int, dt: torch.dtype, device, i: int) -> torch.Tensor:
    """Row ``i`` of ``_pos_table``; under a fake mode (the dry-run) the
    table is made anew, since its fake tensors must not outlive the mode
    in the kept table."""
    import torch._guards
    if torch._guards.detect_fake_mode() is not None:
        return sinusoidal_pos(Sd, D, device).to(dt)[i]
    return _pos_table(Sd, D, dt, device)[i]


def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos, cfg: ArchConfig,
                ctx: Optional[ShardCtx] = None):
    """token [B, 1], pos an int -> (logits [B, Vp], the cache with the self
    K/V written in place at ``pos % dec_len``: the reference returns a new
    one).  The position embedding wraps at ``pos % dec_len`` too.  Under
    ``ctx.mesh`` the cache's leaves are DTensors (a plain leaf is placed by
    ``cache_specs`` of ``flags.serving_layout`` first, and the placed cache
    is the one written and returned) and the logits a DTensor."""
    ctx = _ctx(ctx)
    p = as_tree(params)
    pos = int(pos)
    dt = dtype_of(cfg)
    B = token.shape[0]
    mesh = ctx.mesh
    with ctx.scope():
        if mesh is not None:
            cache = sharding.place_tree(cache, mesh, cache_specs(
                cfg, mesh, flags.serving_layout))
        x = p["embed"][token].to(dt)
        Sd = cache["k"].shape[2]
        x = x + _pos_row(Sd, cfg.d_model, dt, token.device, pos % Sd)
        x = ctx.constrain(x, ctx.dp, None, None)
        posv = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        Se = cache["xk"].shape[2]
        xpos = _positions(B, Se, x.device)
        if mesh is not None:    # as the cross K/V of one layer
            from torch.distributed.tensor import Shard
            xpos = sharding.place(xpos, mesh, tuple(
                Shard(q.dim - 1) if q.is_shard() else q
                for q in cache["xk"].placements))
        for i in range(cfg.n_layers):
            lp = _layer(p["dec_layers"], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = _qkv(h, lp["attn"], posv, cfg, ctx)
            if mesh is None:
                ck, cv, cp = attn_mod.cache_update(
                    cache["k"][i], cache["v"][i], cache["pos"][i], k, v, pos)
                o = attn_mod.decode_attention(q, ck, cv, cp)
            else:
                q = ctx.constrain(q, ctx.dp, None, None, None)
                ck, cv, cp = attn_mod.cache_update_mesh(
                    cache["k"][i], cache["v"][i], cache["pos"][i], k, v, pos)
                o = attn_mod.decode_attention_mesh(q, ck, cv, cp)
            x = x + attn_mod.out_proj(o, lp["attn"])
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            qx = _cross_q(h2, lp, cfg, ctx)
            if mesh is None:
                ox = attn_mod.decode_attention(qx, cache["xk"][i],
                                               cache["xv"][i], xpos)
            else:
                qx = ctx.constrain(qx, ctx.dp, None, None, None)
                ox = attn_mod.decode_attention_mesh(qx, cache["xk"][i],
                                                    cache["xv"][i], xpos)
            x = x + attn_mod.out_proj(ox, lp["xattn"])
            x = _mlp(x, lp, "ln3", cfg)
        x = rms_norm(x, p["dec_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,vd->bsv", x, p["lm_head"].to(dt))[:, 0]
        logits = ctx.constrain(logits, ctx.dp, "model")
    return logits, cache


def prefill(params: Params, frames: torch.Tensor, cfg: ArchConfig,
            ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode, then every decoder layer's cross-attention K/V: (enc_out
    [B, Se, D], xk, xv [Ld, B, Se, H, dh]), all in the model's dtype
    (DTensors under ``ctx.mesh``)."""
    ctx = _ctx(ctx)
    p = as_tree(params)
    enc_out = encode(p, frames, cfg, ctx)
    with ctx.scope():
        kv = [_cross_kv(enc_out, _layer(p["dec_layers"], i), cfg, ctx)
              for i in range(cfg.n_layers)]
        return (enc_out, torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]))
