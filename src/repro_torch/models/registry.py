"""A uniform model API over the ported families: ``build_model(cfg)``
returns a ModelAPI whose functions close over the config, dispatching on
``cfg.enc_dec`` as the reference does (``encdec`` for whisper-small,
``transformer`` for the decoder-only families).  ``loss`` keeps the
reference's signature ``loss(p, b, ctx=None, scan_impl='seq')``; ``ctx``,
the reference's mesh context, is taken only as None.  The reference's
``param_specs``, ``cache_specs``, ``input_specs`` and ``batch_pspec`` are
mesh and dry-run code; they wait for ROADMAP §1 item 5(g)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lsm import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., nn.Module]
    loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_cache: Callable[..., Any]
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


def _no_mesh(ctx) -> None:
    if ctx is not None:
        raise ValueError("ctx, the reference's mesh context, has no meaning "
                         "on one card (ROADMAP §1 item 5(g)); pass None")


def build_model(cfg: ArchConfig) -> ModelAPI:
    fam = _family(cfg)
    inputs = "frames" if cfg.enc_dec else "tokens"    # what prefill takes

    def loss(p, b, ctx=None, scan_impl="seq"):
        _no_mesh(ctx)
        return fam.lm_loss(p, b, cfg, scan_impl)

    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None: init_model(cfg, seed, device),
        loss=loss,
        init_cache=lambda batch, seq_len, device=None: fam.init_cache(
            cfg, batch, seq_len, device=resolve_device(device)),
        decode_step=lambda p, c, t, pos: fam.decode_step(p, c, t, pos, cfg),
        prefill=lambda p, b: fam.prefill(p, b[inputs], cfg),
    )
