"""A uniform model API over the ported families: ``build_model(cfg)``
returns a ModelAPI whose functions close over the config, dispatching on
``cfg.enc_dec`` as the reference does (``encdec`` for whisper-small,
``transformer`` for the decoder-only families).  ``loss``, ``prefill``
and ``decode_step`` keep the reference's signatures (``loss(p, b,
ctx=None, scan_impl='seq')``, ``prefill(p, b, ctx=None)``,
``decode_step(p, c, t, pos, ctx=None)``).  ``ctx``, the mesh context
(``transformer.ShardCtx``), runs all three on a mesh for every family
(the moe family by ``flags.moe_impl``, ``decode_step`` by
``flags.serving_layout``), as the reference's dry-run runs them
(``launch/dryrun.py``).  ``param_specs`` and ``cache_specs`` give the
family's specs for a ``DeviceMesh``; ``input_specs`` gives every step
input as a tensor on the ``meta`` device (shape and dtype, no storage),
the reference's ``ShapeDtypeStruct``, and ``batch_pspec`` their specs."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core.lsm import resolve_device
from repro_torch.models import encdec, flags, transformer
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.parallel.sharding import P, dp_axes, mesh_axes


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., nn.Module]
    param_specs: Callable[..., Any]
    loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_cache: Callable[..., Any]
    cache_specs: Callable[..., Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    prefill: Callable[..., Any]


def _family(cfg: ArchConfig):
    return encdec if cfg.enc_dec else transformer


def init_model(cfg: ArchConfig, seed: Union[int, torch.Generator],
               device=None) -> Union[DecoderLM, EncDecLM]:
    """Random parameters drawn from ``seed`` (an int, or a generator on
    ``device``) on ``device``: the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        if seed.device.type != dev.type:
            raise ValueError(f"the generator lies on {seed.device}, the "
                             f"parameters go to {dev}")
        gen = seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    module = EncDecLM if cfg.enc_dec else DecoderLM
    return module(cfg, _family(cfg).init_params(cfg, gen))


def build_model(cfg: ArchConfig) -> ModelAPI:
    fam = _family(cfg)
    inputs = "frames" if cfg.enc_dec else "tokens"    # what prefill takes

    def loss(p, b, ctx=None, scan_impl="seq"):
        return fam.lm_loss(p, b, cfg, ctx, scan_impl=scan_impl)

    def prefill(p, b, ctx=None):
        return fam.prefill(p, b[inputs], cfg, ctx)

    def decode_step(p, c, t, pos, ctx=None):
        return fam.decode_step(p, c, t, pos, cfg, ctx)

    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None: init_model(cfg, seed, device),
        param_specs=lambda mesh, **kw: fam.param_specs(cfg, mesh, **kw),
        loss=loss,
        init_cache=lambda batch, seq_len, device=None: fam.init_cache(
            cfg, batch, seq_len, device=resolve_device(device)),
        cache_specs=lambda mesh, layout="batch": fam.cache_specs(
            cfg, mesh, layout),
        decode_step=decode_step,
        prefill=prefill,
    )


# --------------------------------------------------------------------------- #
# abstract inputs per (arch x shape): the dry-run contract
# --------------------------------------------------------------------------- #
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """Stand-ins for the step function's data inputs: tensors on the
    ``meta`` device, which hold a shape and a dtype and no storage."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind == "train":
        if cfg.enc_dec:
            Sd = encdec.dec_len_for(S)
            return {
                "frames": _meta((B, S, cfg.d_model), transformer.dtype_of(cfg)),
                "tokens": _meta((B, Sd), tok),
                "labels": _meta((B, Sd), tok),
                "mask": _meta((B, Sd), torch.float32),
            }
        return {
            "tokens": _meta((B, S), tok),
            "labels": _meta((B, S), tok),
            "mask": _meta((B, S), torch.float32),
        }
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return {"frames": _meta((B, S, cfg.d_model),
                                    transformer.dtype_of(cfg))}
        return {"tokens": _meta((B, S), tok)}
    if shape.kind == "decode":
        # one new token against a seq_len-deep cache, built on 'meta'
        # (ModelAPI.init_cache takes only the card or the CPU)
        cache = _family(cfg).init_cache(cfg, B, S, device=torch.device("meta"))
        return {
            "cache": cache,
            "token": _meta((B, 1), tok),
            "pos": _meta((), tok),
        }
    raise ValueError(shape.kind)


def batch_pspec(cfg: ArchConfig, shape: ShapeCfg, mesh) -> Dict[str, Any]:
    """Specs matching input_specs (batch over data axes)."""
    dp = dp_axes(mesh)
    dpa = dp if len(dp) > 1 else dp[0]
    B = shape.global_batch
    sizes = mesh_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    bspec = dpa if B % dp_size == 0 and B >= dp_size else None
    if shape.kind == "train":
        if cfg.enc_dec:
            return {"frames": P(bspec, None, None), "tokens": P(bspec, None),
                    "labels": P(bspec, None), "mask": P(bspec, None)}
        return {"tokens": P(bspec, None), "labels": P(bspec, None),
                "mask": P(bspec, None)}
    if shape.kind == "prefill":
        if cfg.enc_dec:
            return {"frames": P(bspec, None, None)}
        return {"tokens": P(bspec, None)}
    if shape.kind == "decode":
        model = build_model(cfg)
        if flags.serving_layout == "tp2d":
            return {"cache": model.cache_specs(mesh, layout="tp2d"),
                    "token": P(None, None), "pos": P()}
        cspecs = model.cache_specs(mesh)
        if bspec is None:  # batch=1 (long_500k): drop batch sharding
            cspecs = {k: P(*(None if ax in (dpa,) or isinstance(ax, tuple)
                             else ax for ax in s))
                      for k, s in cspecs.items()}
        return {"cache": cspecs, "token": P(bspec, None), "pos": P()}
    raise ValueError(shape.kind)
