"""Shared set-up of the model differentials: reduced configs of both
packages, the reference's parameters from its own ``init`` and the port's
from ``params_from_reference``, token batches from a numpy seed, and the
flags set on both packages at once."""

import dataclasses
import functools

import jax
import numpy as np

from repro.configs import base as ref_base
from repro.models import flags as ref_flags
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import base
from repro_torch.models import flags
from repro_torch.models.weights import params_from_reference

DENSE = ["chameleon-34b", "deepseek-coder-33b", "glm4-9b", "llama3-405b",
         "llama3-8b"]
OTHER = ["falcon-mamba-7b", "granite-moe-1b-a400m", "hymba-1.5b",
         "phi3.5-moe-42b-a6.6b", "whisper-small"]
TOL = dict(rtol=1e-4, atol=1e-4)


def configs(arch, **replace):
    """(reference config, port config), both ``reduced()``."""
    return (dataclasses.replace(ref_base.get_config(arch).reduced(), **replace),
            dataclasses.replace(base.get_config(arch).reduced(), **replace))


@functools.lru_cache(maxsize=None)
def _ref_params(ref_cfg, seed):
    return ref_build_model(ref_cfg).init(jax.random.PRNGKey(seed))


def models(arch, seed=1, **replace):
    """(ref_cfg, cfg, reference params, the port's DecoderLM on the CPU)."""
    ref_cfg, cfg = configs(arch, **replace)
    ref_params = _ref_params(ref_cfg, seed)
    port = params_from_reference(cfg, jax.tree.map(np.asarray, ref_params),
                                 device="cpu")
    return ref_cfg, cfg, ref_params, port


def tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def set_flag(monkeypatch, name, value):
    monkeypatch.setattr(ref_flags, name, value)
    monkeypatch.setattr(flags, name, value)
