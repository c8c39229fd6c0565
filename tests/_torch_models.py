"""Shared set-up of the model differentials: reduced configs of both
packages, the reference's parameters from its own ``init`` and the port's
from ``params_from_reference``, token batches from a numpy seed, the
flags set on both packages at once, and both serving engines run on the
same requests."""

import dataclasses
import functools

import jax
import numpy as np

from repro.configs import base as ref_base
from repro.models import flags as ref_flags
from repro.models.registry import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.configs import base
from repro_torch.models import flags
from repro_torch.models.weights import params_from_reference
from repro_torch.serving.engine import Request, ServingEngine

DENSE = ["chameleon-34b", "deepseek-coder-33b", "glm4-9b", "llama3-405b",
         "llama3-8b"]
SSM = ["falcon-mamba-7b", "hymba-1.5b"]                    # ssm, hybrid
MOE = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
FAMILIES = SSM + MOE
OTHER = ["whisper-small"]
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


def requests(cls, cfg, n, prompt_len, max_new, seed):
    """``n`` requests of class ``cls``; ``prompt_len`` and ``max_new`` an int
    or a (low, high) range drawn per request."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = prompt_len if isinstance(prompt_len, int) else \
            int(rng.integers(*prompt_len))
        mnt = max_new if isinstance(max_new, int) else int(rng.integers(*max_new))
        prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=mnt))
    return out


def serve_both(arch, max_seq, n=10, prompt_len=8, max_new=8, seed=0,
               **replace):
    """Both engines (4 slots) on the same parameters and requests: the
    port's tokens must equal the reference's, request for request."""
    ref_cfg, cfg, ref_p, port = models(arch, **replace)
    want = RefEngine(ref_cfg, ref_p, batch_size=4, max_seq=max_seq).run(
        requests(RefRequest, ref_cfg, n, prompt_len, max_new, seed))
    engine = ServingEngine(cfg, port, batch_size=4, max_seq=max_seq,
                           device="cpu")
    got = engine.run(requests(Request, cfg, n, prompt_len, max_new, seed))
    assert got == want
    assert all(isinstance(t, int) for toks in got.values() for t in toks)
    return got, engine
