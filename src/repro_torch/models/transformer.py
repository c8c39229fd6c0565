"""Decoder-only LM covering the dense / moe / hybrid / ssm / vlm families.

One parameterized block type; per-family composition:
  dense|vlm :  x += attn(ln1 x);  x += mlp(ln2 x)
  moe       :  x += attn(ln1 x);  x += moe(ln2 x)
  ssm       :  x += mamba(ln1 x)                       (attention-free)
  hybrid    :  x += (attn(ln1 x) + mamba(ln1 x)) / 2;  x += mlp(ln2 x)

Parameters keep the reference's tree and leaf names, stacked ``[L, ...]``
(``layers.attn.wq`` is ``[L, D, H, dh]``), held by ``DecoderLM`` as
``nn.Parameter``s; the functions here take that module or the nested dict
of its tensors.  A loop over layers stands where the reference scans;
with ``cfg.remat`` and grad enabled each layer runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
layer body in ``jax.checkpoint``, so its activations are recomputed in the
backward.  An encoder-decoder config raises ``ValueError`` here:
``models/encdec.py`` runs it, and ``registry.build_model`` dispatches on
``cfg.enc_dec``.  ``param_specs``, ``param_specs_serve2d`` and
``cache_specs`` give the reference's specs (``parallel/sharding.py``'s
``PartitionSpec``) from the leaves' shapes alone, building no parameter.

``ShardCtx`` carries a ``DeviceMesh`` through ``forward``, ``lm_loss`` and
``prefill`` and places the reference's activation constraints (the
embeddings, the attention modes 'head' and 'seqq', each layer's branch,
the logits) as DTensor placements.  Under a mesh the parameters and the
batch are DTensors (the train step places them by ``state_specs`` and
``batch_pspec``), and the plain tensors the forward makes itself
(positions, RoPE tables, masks) are taken as replicated on every rank
(``implicit_replication``, entered by ``ShardCtx.scope``).  The mamba
block's scan runs on each rank's shard (``models/ssm.py``), and so does a
moe layer's dispatch, by ``flags.moe_impl``: 'gather' (``moe_ffn`` of the
global batch) or 'ep' (per data shard; ``models/moe.py``).  With no mesh
``constrain`` returns its input and the forward is the mesh-less one.
``decode_step`` takes a ``ctx`` too (the dry-run's serve step): K/V
written and read on the ranks that hold the cache's slots
(``attention.cache_update_mesh``, ``decode_attention_mesh``), the mamba
caches as DTensors, each moe layer's dispatch on the gathered tokens
through ``local_map``, dropless; ``flags.serving_layout='tp2d'`` replicates
the batch (``force_dp_none``) against a cache whose sequence is split over
both mesh axes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import flags
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dense_init, embed_init, rms_norm, swiglu
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (P, attn_mode, dp_axes, fsdp_axis,
                                           safe_spec, tp_size)

Tree = Dict[str, Any]


@dataclasses.dataclass
class ShardCtx:
    """Threaded through forward passes to place activation constraints."""
    mesh: Any = None                # a DeviceMesh, or None
    force_dp_none: bool = False     # tp2d serving: batch replicated

    def constrain(self, x, *spec):
        if self.mesh is None:
            return x
        return sharding.constrain(x, self.mesh, spec)

    @property
    def dp(self):
        if self.mesh is None or self.force_dp_none:
            return None
        axes = dp_axes(self.mesh)
        return axes if len(axes) > 1 else axes[0]

    def scope(self):
        """Where the forward and its backward run: under a mesh, plain
        tensors count as replicated DTensors (every rank makes the same
        ones); with none, nothing changes."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding.replicating()


def check_family(cfg: ArchConfig) -> None:
    """Raise for a configuration that is not decoder-only."""
    if cfg.enc_dec:
        raise ValueError(f"{cfg.name}: an encoder-decoder config; use "
                         "repro_torch.models.encdec")


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def leaf_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter leaf by its dotted name, with its shape."""
    check_family(cfg)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Vp = cfg.padded_vocab
    shapes = {"embed": (Vp, D), "layers.ln1": (L, D)}
    if cfg.has_attn:
        shapes.update({
            "layers.attn.wq": (L, D, H, dh),
            "layers.attn.wk": (L, D, Hkv, dh),
            "layers.attn.wv": (L, D, Hkv, dh),
            "layers.attn.wo": (L, H, dh, D),
        })
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        shapes.update({
            "layers.moe.router": (L, D, E),
            "layers.moe.wg": (L, E, D, F),
            "layers.moe.wu": (L, E, D, F),
            "layers.moe.wd": (L, E, F, D),
            "layers.ln2": (L, D),
        })
    elif cfg.has_mlp:
        shapes.update({
            "layers.mlp.wg": (L, D, F),
            "layers.mlp.wu": (L, D, F),
            "layers.mlp.wd": (L, F, D),
            "layers.ln2": (L, D),
        })
    if cfg.has_ssm:
        di, N, dtr, dk = cfg.d_inner, cfg.ssm.d_state, cfg.dt_rank, cfg.ssm.d_conv
        shapes.update({
            "layers.ssm.in_proj": (L, D, 2 * di),
            "layers.ssm.conv_w": (L, dk, di),
            "layers.ssm.conv_b": (L, di),
            "layers.ssm.x_proj": (L, di, dtr + 2 * N),
            "layers.ssm.dt_proj": (L, dtr, di),
            "layers.ssm.dt_bias": (L, di),
            "layers.ssm.A_log": (L, di, N),
            "layers.ssm.D": (L, di),
            "layers.ssm.out_proj": (L, di, D),
        })
    shapes["final_norm"] = (D,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (Vp, D)
    return shapes


def flatten_tree(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(flatten_tree(val, f"{prefix}{key}."))
        else:
            flat[prefix + key] = val
    return flat


def nest_tree(flat: Dict[str, Any]) -> Tree:
    tree: Tree = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def init_params(cfg: ArchConfig, gen: torch.Generator) -> Tree:
    """Random parameters on ``gen``'s device, one leaf at a time (each drawn
    in float32, then cast to the config's dtype)."""
    dt = dtype_of(cfg)
    D, di = cfg.d_model, cfg.d_inner
    fan_in = {"wq": D, "wk": D, "wv": D, "wo": cfg.n_heads * cfg.head_dim,
              "wg": D, "wu": D, "wd": cfg.d_ff, "router": D, "in_proj": D,
              "conv_w": cfg.ssm.d_conv if cfg.has_ssm else 0, "x_proj": di,
              "dt_proj": cfg.dt_rank, "out_proj": di}
    flat = {}
    for name, shape in leaf_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "final_norm", "D"):
            flat[name] = torch.ones(shape, dtype=dt, device=gen.device)
        elif leaf in ("conv_b", "dt_bias"):
            flat[name] = torch.zeros(shape, dtype=dt, device=gen.device)
        elif leaf == "A_log":
            flat[name] = ssm_mod.a_log_init(shape, dt, gen.device)
        elif leaf in ("embed", "lm_head"):
            flat[name] = embed_init(gen, shape, dt)
        else:
            flat[name] = dense_init(gen, shape, fan_in[leaf], dt)
    return nest_tree(flat)


# --------------------------------------------------------------------------- #
# partition specs (mirror the parameter tree, from its shapes alone)
# --------------------------------------------------------------------------- #
def _spec_of(shapes: Dict[str, Tuple[int, ...]], mesh):
    """``sp(name, *axes)``: ``safe_spec`` of the leaf ``name``'s shape."""
    return lambda name, *axes: safe_spec(shapes[name], axes, mesh)


def param_specs(cfg: ArchConfig, mesh, fsdp_over_pod: bool = False,
                layout: str = "train") -> Tree:
    """The parameter tree's specs: TP on heads / FFN / experts / d_inner,
    ZeRO-3 FSDP over `data` (and `pod` with ``fsdp_over_pod``),
    vocab-sharded embeddings; ``layout='serve2d'`` gives
    ``param_specs_serve2d``."""
    if layout == "serve2d":
        return param_specs_serve2d(cfg, mesh)
    fs = fsdp_axis(mesh, fsdp_over_pod)
    tp = tp_size(mesh)
    mode = attn_mode(cfg.n_heads, tp) if cfg.has_attn else "none"
    sp = _spec_of(leaf_shapes(cfg), mesh)

    layers: Tree = {"ln1": sp("layers.ln1", None, None)}
    if cfg.has_attn:
        if mode == "head":
            layers["attn"] = {
                "wq": sp("layers.attn.wq", None, fs, "model", None),
                "wk": sp("layers.attn.wk", None, fs, None, None),
                "wv": sp("layers.attn.wv", None, fs, None, None),
                "wo": sp("layers.attn.wo", None, "model", None, fs),
            }
        else:  # 'seqq': weights replicated over model; seq dim shards compute
            layers["attn"] = {
                "wq": sp("layers.attn.wq", None, fs, None, None),
                "wk": sp("layers.attn.wk", None, fs, None, None),
                "wv": sp("layers.attn.wv", None, fs, None, None),
                "wo": sp("layers.attn.wo", None, None, None, fs),
            }
    if cfg.moe is not None:
        layers["moe"] = {
            "router": sp("layers.moe.router", None, fs, None),
            "wg": sp("layers.moe.wg", None, "model", fs, None),
            "wu": sp("layers.moe.wu", None, "model", fs, None),
            "wd": sp("layers.moe.wd", None, "model", None, fs),
        }
        layers["ln2"] = sp("layers.ln2", None, None)
    elif cfg.has_mlp:
        layers["mlp"] = {
            "wg": sp("layers.mlp.wg", None, fs, "model"),
            "wu": sp("layers.mlp.wu", None, fs, "model"),
            "wd": sp("layers.mlp.wd", None, "model", fs),
        }
        layers["ln2"] = sp("layers.ln2", None, None)
    if cfg.has_ssm:
        layers["ssm"] = {
            "in_proj": sp("layers.ssm.in_proj", None, fs, "model"),
            "conv_w": sp("layers.ssm.conv_w", None, None, "model"),
            "conv_b": sp("layers.ssm.conv_b", None, "model"),
            "x_proj": sp("layers.ssm.x_proj", None, "model", None),
            "dt_proj": sp("layers.ssm.dt_proj", None, None, "model"),
            "dt_bias": sp("layers.ssm.dt_bias", None, "model"),
            "A_log": sp("layers.ssm.A_log", None, "model", None),
            "D": sp("layers.ssm.D", None, "model"),
            "out_proj": sp("layers.ssm.out_proj", None, "model", fs),
        }

    specs = {
        "embed": sp("embed", "model", fs),
        "layers": layers,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = sp("lm_head", "model", fs)
    return specs


def param_specs_serve2d(cfg: ArchConfig, mesh) -> Tree:
    """Weight-stationary serving layout: every large weight sharded over
    BOTH mesh axes (the 256 ranks act as one 16x16 TP grid), the token
    batch replicated, so no parameter moves after load."""
    sp = _spec_of(leaf_shapes(cfg), mesh)

    layers: Tree = {"ln1": sp("layers.ln1", None, None)}
    if cfg.has_attn:
        layers["attn"] = {
            "wq": sp("layers.attn.wq", None, None, "data", "model"),
            "wk": sp("layers.attn.wk", None, "data", None, "model"),
            "wv": sp("layers.attn.wv", None, "data", None, "model"),
            "wo": sp("layers.attn.wo", None, "data", "model", None),
        }
    if cfg.moe is not None:
        layers["moe"] = {
            "router": sp("layers.moe.router", None, "data", None),
            "wg": sp("layers.moe.wg", None, "model", "data", None),
            "wu": sp("layers.moe.wu", None, "model", "data", None),
            "wd": sp("layers.moe.wd", None, "model", None, "data"),
        }
        layers["ln2"] = sp("layers.ln2", None, None)
    elif cfg.has_mlp:
        layers["mlp"] = {
            "wg": sp("layers.mlp.wg", None, "data", "model"),
            "wu": sp("layers.mlp.wu", None, "data", "model"),
            "wd": sp("layers.mlp.wd", None, "model", "data"),
        }
        layers["ln2"] = sp("layers.ln2", None, None)
    if cfg.has_ssm:
        layers["ssm"] = {
            "in_proj": sp("layers.ssm.in_proj", None, "data", "model"),
            "conv_w": sp("layers.ssm.conv_w", None, None, "model"),
            "conv_b": sp("layers.ssm.conv_b", None, "model"),
            "x_proj": sp("layers.ssm.x_proj", None, "model", None),
            "dt_proj": sp("layers.ssm.dt_proj", None, None, "model"),
            "dt_bias": sp("layers.ssm.dt_bias", None, "model"),
            "A_log": sp("layers.ssm.A_log", None, "model", None),
            "D": sp("layers.ssm.D", None, "model"),
            "out_proj": sp("layers.ssm.out_proj", None, "model", "data"),
        }
    specs = {
        "embed": sp("embed", "model", "data"),
        "layers": layers,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = sp("lm_head", "model", "data")
    return specs


class DecoderLM(nn.Module):
    """The parameters under the reference's names (``named_parameters``
    gives ``layers.attn.wq`` and so on).  They do not require grad, so
    serving builds no autograd graph; the train step differentiates
    through detached aliases of the leaves that do
    (``train/train_step.py``)."""

    def __init__(self, cfg: ArchConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        _attach(self, tree)

    def tree(self) -> Tree:
        return _tree_of(self)


def _attach(module: nn.Module, tree: Tree) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            sub = nn.Module()
            module.add_module(key, sub)
            _attach(sub, val)
        else:
            module.register_parameter(key, nn.Parameter(val, requires_grad=False))


def _tree_of(module: nn.Module) -> Tree:
    out: Tree = dict(module._parameters)
    for key, sub in module._modules.items():
        out[key] = _tree_of(sub)
    return out


Params = Union[DecoderLM, Tree]


def as_tree(params: Params) -> Tree:
    return params.tree() if isinstance(params, nn.Module) else params


def _layer(tree: Tree, i: int) -> Tree:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree: Tree, n: int) -> List[Tree]:
    """The ``n`` per-layer trees of ``[L, ...]`` leaves, by ``unbind``:
    views, whose gradients autograd stacks once per leaf."""
    flat = {k: v.unbind(0) for k, v in flatten_tree(tree).items()}
    return [nest_tree({k: v[i] for k, v in flat.items()}) for i in range(n)]


def _save_dots(ctx, op, *args, **kwargs):
    """``flags.remat_policy='dots'``: keep the outputs of products with no
    batch dimension (the reference's ``dots_with_no_batch_dims_saveable``)
    and recompute the rest.  ``x @ w`` reaches ``aten.mm`` (or ``addmm``);
    an einsum with no batch dimension (the QKV, output and head
    projections) reaches ``aten.bmm`` over a batch of one; attention's
    einsums are batched over (B, H) and are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    save = op in (aten.mm.default, aten.addmm.default) or (
        op is aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if save else \
        CheckpointPolicy.PREFER_RECOMPUTE


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``enabled``
    (``cfg.remat``) and grad is: its activations are recomputed in the
    backward, all of them (``flags.remat_policy`` 'nothing', the
    reference's default) or all but the products' ('dots').  Values are
    the same either way."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    if flags.remat_policy == "nothing":
        return checkpoint(fn, *args, use_reentrant=False)
    if flags.remat_policy == "dots":
        import functools

        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        return checkpoint(fn, *args, use_reentrant=False, context_fn=(
            functools.partial(create_selective_checkpoint_contexts,
                              _save_dots)))
    raise ValueError(f"flags.remat_policy must be 'nothing' or 'dots', got "
                     f"{flags.remat_policy!r}")


def _head(p: Tree, cfg: ArchConfig, dt: torch.dtype) -> torch.Tensor:
    return (p["embed"] if cfg.tie_embeddings else p["lm_head"]).to(dt)


# --------------------------------------------------------------------------- #
# forward (training / prefill)
# --------------------------------------------------------------------------- #
def _layer_fwd(x, lp, cfg: ArchConfig, positions, ctx: ShardCtx,
               scan_impl: str = "seq") -> Tuple[torch.Tensor, torch.Tensor]:
    """One block; returns (x, aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mode = attn_mode(cfg.n_heads, tp_size(ctx.mesh)) if (
        cfg.has_attn and ctx.mesh is not None) else "head"
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    branch = None
    if cfg.has_attn:
        # the attention branch reads h through a node of its own, so its
        # three projections' gradients are summed before the mamba
        # branch's is added, in one order on a mesh or off it
        h_attn = h.view_as(h) if cfg.has_ssm else h
        h_attn = ctx.constrain(h_attn, ctx.dp,
                               "model" if mode == "seqq" else None, None)
        if ctx.mesh is None:
            q, k, v = attn_mod.qkv_proj(h_attn, lp["attn"], cfg.rope_theta,
                                        positions)
        else:
            a = lp["attn"]
            q, k, v = attn_mod.heads_mesh(h_attn, [a["wq"], a["wk"], a["wv"]],
                                          ctx, mode, True, cfg.rope_theta,
                                          positions)
        if mode == "head":
            q = ctx.constrain(q, ctx.dp, None, "model", None)
        else:
            q = ctx.constrain(q, ctx.dp, "model", None, None)
            k = ctx.constrain(k, ctx.dp, None, None, None)
            v = ctx.constrain(v, ctx.dp, None, None, None)
        if ctx.mesh is None:
            o = attn_mod.attention(q, k, v, positions, positions,
                                   causal=True, window=cfg.attn_window)
        else:
            o = attn_mod.attention_mesh(q, k, v, positions, positions, ctx,
                                        mode, causal=True,
                                        window=cfg.attn_window)
        if mode == "seqq":
            branch = _seqq_out_proj(o, lp["attn"]["wo"], ctx)
        else:
            branch = attn_mod.out_proj(o, lp["attn"])
    if cfg.has_ssm:
        m = ssm_mod.mamba_block(h, lp["ssm"], cfg, scan_impl, ctx=ctx)
        branch = m if branch is None else (branch + m) * 0.5
    x = x + ctx.constrain(branch, ctx.dp, None, None)
    if cfg.moe is not None:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        moe_mod.check_impl(flags.moe_impl)
        if ctx.mesh is None:
            y, aux = moe_mod.moe_ffn(h2, lp["moe"], cfg.moe)
        elif flags.moe_impl == "ep":
            y, aux = moe_mod.moe_ffn_ep(h2, lp["moe"], cfg.moe, ctx.mesh)
        else:
            y, aux = moe_mod.moe_ffn_mesh(h2, lp["moe"], cfg.moe, ctx.mesh,
                                          ctx.dp)
        x = x + y
    elif cfg.has_mlp:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h2, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    return x, aux


def _seqq_out_proj(o, wo, ctx: ShardCtx):
    """The output projection in 'seqq' mode on a mesh, on each rank's
    shards: DTensor would shard its weight gradient over `model` along
    H * dh (a free split of the gathered o) and then cannot unflatten it to
    [H, dh] where `model` does not divide H.  So o's sequence is gathered,
    the weight gathered, each rank projects its rows, and the weight's
    gradient comes back a partial sum over the ranks that split the
    batch."""
    from torch.distributed.tensor import Replicate
    mesh = ctx.mesh
    os_ = sharding.placements(mesh, o.shape, (ctx.dp, None, None, None))
    out = sharding.placements(mesh, o.shape[:2] + wo.shape[-1:],
                              (ctx.dp, None, None))
    whole = (Replicate(),) * mesh.ndim
    run = sharding.on_shards(
        mesh, lambda o, wo: attn_mod.out_proj(o, {"wo": wo}), (out,),
        (os_, whole), (os_, sharding.partial_where(os_, 0, whole)))
    return run(o, wo)


def _ctx(ctx) -> ShardCtx:
    if ctx is None:
        return ShardCtx()
    if not isinstance(ctx, ShardCtx):
        raise ValueError(f"ctx must be a ShardCtx or None, not "
                         f"{type(ctx).__name__}")
    return ctx


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: Optional[ShardCtx] = None, scan_impl: str = "seq",
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,Vp], aux loss: the moe layers' sum, 0
    for the other families).  ``scan_impl`` ('seq' or 'chunked', the
    reference's two scans of the same recurrence) goes to the mamba
    block.  Under ``ctx.mesh`` the logits are a DTensor."""
    check_family(cfg)
    ctx = _ctx(ctx)
    p = as_tree(params)
    B, S = tokens.shape
    dt = dtype_of(cfg)
    with ctx.scope():
        x = p["embed"][tokens].to(dt)
        x = ctx.constrain(x, ctx.dp, None, None)
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in _unstack(p["layers"], cfg.n_layers):
            x, a = remat(cfg.remat, _layer_fwd, x, lp, cfg, positions, ctx,
                         scan_impl)
            aux = aux + a
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        logits = head_logits(x, _head(p, cfg, dt), ctx)
        logits = ctx.constrain(logits, ctx.dp, None, "model")
    return logits, aux


def head_logits(x, head, ctx: ShardCtx) -> torch.Tensor:
    """``einsum('bsd,vd->bsv', x, head)``; on a mesh on each rank's rows
    (over the data axes) and vocabulary rows of the head (over `model`,
    the head gathered over the data axes), the logits so placed: DTensor
    would gather the whole logits' gradient over the data ranks (a
    [B, S, V] all-gather, the dry-run found) to form the head's.  x's
    gradient is a partial sum over the `model` ranks, the head's over
    those that split the rows."""
    if ctx.mesh is None:
        return torch.einsum("bsd,vd->bsv", x, head)
    mesh = ctx.mesh
    xs = sharding.placements(mesh, x.shape, (ctx.dp, None, None))
    hs = sharding.placements(mesh, head.shape, ("model", None))
    out = sharding.placements(mesh, tuple(x.shape[:2]) + (head.shape[0],),
                              (ctx.dp, None, "model"))
    return sharding.on_shards(
        mesh, lambda x, h: torch.einsum("bsd,vd->bsv", x, h), (out,),
        (xs, hs), (sharding.partial_where(out, 2, xs),
                   sharding.partial_where_split(xs, hs)))(x, head)


def lm_loss(params: Params, batch, cfg: ArchConfig,
            ctx: Optional[ShardCtx] = None, scan_impl: str = "seq"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy; batch = {'tokens', 'labels', 'mask'}."""
    ctx = _ctx(ctx)
    logits, aux = forward(params, batch["tokens"], cfg, ctx, scan_impl)
    with ctx.scope():
        return _xent(logits, batch, aux, cfg)


def _xent(logits, batch, aux, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    labels = batch["labels"].long()[..., None]
    mask = batch.get("mask")
    if flags.xent_impl == "fused":
        # the shift in the logits' dtype, exp and sum in float32; no
        # gradient through the shift, as the reference stops it
        m = logits.detach().amax(-1)
        z = torch.exp((logits - m[..., None]).float()).sum(-1)
        lse = m.float() + torch.log(z)
        gold = logits.gather(-1, labels).float()
    else:
        lf = logits.float()
        lse = torch.logsumexp(lf, -1)
        gold = lf.gather(-1, labels)
    # the label's logit kept [B, S, 1] until it meets lse: on a mesh the
    # gather over vocab-sharded logits is a masked partial sum, which
    # DTensor reduces only at the shape it was gathered at
    nll = (lse[..., None] - gold)[..., 0]
    if mask is not None:
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
    else:
        loss = nll.mean()
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux}


# --------------------------------------------------------------------------- #
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------- #
def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.attn_window > 0:
        return min(cfg.attn_window, seq_len)
    return seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Leading L: zero K/V and positions -1 (attention), a zero conv
    window in the model's dtype and a zero float32 SSM state (mamba)."""
    check_family(cfg)
    dt = dtype_of(cfg)
    L = cfg.n_layers
    cache: Dict[str, torch.Tensor] = {}
    if cfg.has_attn:
        Sc = cache_len_for(cfg, seq_len)
        Hkv, dh = cfg.n_kv_heads, cfg.head_dim
        cache["k"] = torch.zeros((L, batch, Sc, Hkv, dh), dtype=dt, device=device)
        cache["v"] = torch.zeros((L, batch, Sc, Hkv, dh), dtype=dt, device=device)
        cache["pos"] = torch.full((L, batch, Sc), -1, dtype=torch.int32,
                                  device=device)
    if cfg.has_ssm:
        di, N, dk = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        cache["conv"] = torch.zeros((L, batch, dk - 1, di), dtype=dt,
                                    device=device)
        cache["ssm"] = torch.zeros((L, batch, di, N), dtype=torch.float32,
                                   device=device)
    return cache


def cache_specs(cfg: ArchConfig, mesh, layout: str = "batch") -> Tree:
    """KV cache sharding.

    'batch' - batch over data axes, sequence over model (flash-decode).
    'tp2d'  - batch replicated, sequence sharded over BOTH axes (pairs
    with param_specs_serve2d)."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    specs: Tree = {}
    if layout == "tp2d":
        both = tuple(dp) + ("model",)
        if cfg.has_attn:
            specs["k"] = P(None, None, both, None, None)
            specs["v"] = P(None, None, both, None, None)
            specs["pos"] = P(None, None, both)
        if cfg.has_ssm:
            specs["conv"] = P(None, None, None, both)
            specs["ssm"] = P(None, None, both, None)
        return specs
    if cfg.has_attn:
        specs["k"] = P(None, dpa, "model", None, None)
        specs["v"] = P(None, dpa, "model", None, None)
        specs["pos"] = P(None, dpa, "model")
    if cfg.has_ssm:
        specs["conv"] = P(None, dpa, None, "model")
        specs["ssm"] = P(None, dpa, "model", None)
    return specs


def _layer_decode(x, lp, cache_l, pos: int, cfg: ArchConfig,
                  ctx: ShardCtx) -> torch.Tensor:
    """x [B,1,D]; cache_l = the layer's cache views, written in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    branch = None
    if cfg.has_attn:
        posv = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                          device=x.device)
        if ctx.mesh is None:
            q, k, v = attn_mod.qkv_proj(h, lp["attn"], cfg.rope_theta, posv)
            ck, cv, cp = attn_mod.cache_update(cache_l["k"], cache_l["v"],
                                               cache_l["pos"], k, v, pos)
            o = attn_mod.decode_attention(q, ck, cv, cp,
                                          window=cfg.attn_window)
        else:
            a = lp["attn"]
            q, k, v = attn_mod.heads_mesh(
                h, [a["wq"], a["wk"], a["wv"]], ctx,
                attn_mode(cfg.n_heads, tp_size(ctx.mesh)), True,
                cfg.rope_theta, posv)
            q = ctx.constrain(q, ctx.dp, None, None, None)  # whole heads
            ck, cv, cp = attn_mod.cache_update_mesh(
                cache_l["k"], cache_l["v"], cache_l["pos"], k, v, pos)
            o = attn_mod.decode_attention_mesh(q, ck, cv, cp,
                                               window=cfg.attn_window)
        branch = attn_mod.out_proj(o, lp["attn"])
    if cfg.has_ssm:
        m, _, _ = ssm_mod.mamba_decode_step(h, lp["ssm"], cfg,
                                            cache_l["conv"], cache_l["ssm"])
        branch = m if branch is None else (branch + m) * 0.5
    x = x + branch
    if cfg.moe is not None:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        if ctx.mesh is None:
            y, _ = moe_mod.moe_ffn(h2, lp["moe"], cfg.moe, dropless=True)
        else:
            y, _ = moe_mod.moe_ffn_mesh(h2, lp["moe"], cfg.moe, ctx.mesh,
                                        ctx.dp, dropless=True)
        x = x + y
    elif cfg.has_mlp:
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + swiglu(h2, lp["mlp"]["wg"], lp["mlp"]["wu"], lp["mlp"]["wd"])
    return x


def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos, cfg: ArchConfig,
                ctx: Optional[ShardCtx] = None):
    """token [B,1], pos an int -> (logits [B,Vp], the cache, updated in
    place: the reference returns a new one).  Under ``ctx.mesh`` the
    logits are a DTensor and the cache's leaves DTensors (a plain leaf is
    placed by ``cache_specs`` of ``flags.serving_layout`` first, and the
    placed cache is the one written and returned); 'tp2d' replicates the
    batch (``force_dp_none``), as the reference does."""
    check_family(cfg)
    ctx = _ctx(ctx)
    if flags.serving_layout == "tp2d" and ctx.mesh is not None:
        ctx = dataclasses.replace(ctx, force_dp_none=True)
    p = as_tree(params)
    pos = int(pos)
    dt = dtype_of(cfg)
    with ctx.scope():
        if ctx.mesh is not None:
            cache = sharding.place_tree(cache, ctx.mesh, cache_specs(
                cfg, ctx.mesh, flags.serving_layout))
        x = p["embed"][token].to(dt)
        x = ctx.constrain(x, ctx.dp, None, None)
        for i in range(cfg.n_layers):
            x = _layer_decode(x, _layer(p["layers"], i), _layer(cache, i),
                              pos, cfg, ctx)
        x = rms_norm(x, p["final_norm"], cfg.norm_eps)
        logits = torch.einsum("bsd,vd->bsv", x, _head(p, cfg, dt))[:, 0]
        logits = ctx.constrain(logits, ctx.dp, "model")
    return logits, cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: Optional[ShardCtx] = None, scan_impl: str = "seq"):
    """Prefill = forward; the last position's logits (the serving engine
    fills its cache by teacher-forced decode steps)."""
    ctx = _ctx(ctx)
    logits, _ = forward(params, tokens, cfg, ctx, scan_impl)
    with ctx.scope():
        return logits[:, -1]
