"""A uniform model API over the ported families: ``build_model(cfg)``
returns a ModelAPI whose functions close over the config.  The reference's
``param_specs``, ``cache_specs``, ``input_specs`` and ``batch_pspec`` are
mesh and dry-run code; they wait for ROADMAP §1 item 5(g)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lsm import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import DecoderLM


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., DecoderLM]
    loss: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]
    prefill: Callable[..., Any]


def init_model(cfg: ArchConfig, seed: Union[int, torch.Generator],
               device=None) -> DecoderLM:
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
    return DecoderLM(cfg, transformer.init_params(cfg, gen))


def build_model(cfg: ArchConfig) -> ModelAPI:
    transformer.check_family(cfg)
    return ModelAPI(
        cfg=cfg,
        init=lambda seed, device=None: init_model(cfg, seed, device),
        loss=lambda p, b: transformer.lm_loss(p, b, cfg),
        init_cache=lambda batch, seq_len, device=None: transformer.init_cache(
            cfg, batch, seq_len, resolve_device(device)),
        decode_step=lambda p, c, t, pos: transformer.decode_step(
            p, c, t, pos, cfg),
        prefill=lambda p, b: transformer.prefill(p, b["tokens"], cfg),
    )
