"""``ServingEngine`` on the port against the JAX package's on the CPU: the
same parameters and requests give the same tokens, request for request,
with the reference's slot, refill and stop rules (one ``pos`` shared by
all slots, refills over the predecessor's cache entries, empty slots
decoding their last token; ROADMAP §3)."""

import jax
import numpy as np
import pytest
import torch

from _torch_models import models
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.serving.engine import Request, ServingEngine


def _requests(cls, cfg, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = prompt_len if isinstance(prompt_len, int) else \
            int(rng.integers(*prompt_len))
        mnt = max_new if isinstance(max_new, int) else int(rng.integers(*max_new))
        prompt = rng.integers(1, cfg.vocab, plen).astype(np.int32)
        out.append(cls(rid=i, prompt=prompt, max_new_tokens=mnt))
    return out


def _serve_both(arch, max_seq, n=10, prompt_len=8, max_new=8, seed=0, **replace):
    ref_cfg, cfg, ref_p, port = models(arch, **replace)
    want = RefEngine(ref_cfg, ref_p, batch_size=4, max_seq=max_seq).run(
        _requests(RefRequest, ref_cfg, n, prompt_len, max_new, seed))
    engine = ServingEngine(cfg, port, batch_size=4, max_seq=max_seq,
                           device="cpu")
    got = engine.run(_requests(Request, cfg, n, prompt_len, max_new, seed))
    assert got == want
    assert all(isinstance(t, int) for toks in got.values() for t in toks)
    return got, engine


@pytest.mark.parametrize("arch", ["llama3-8b", "chameleon-34b"])
def test_engine_matches_reference_token_for_token(arch):
    """examples/htap_serve.py's run: 10 requests of 8-token prompts, 8 new
    tokens each, 4 slots, max_seq 48.  Three waves: slots refill at pos 15
    and 30, and the last wave leaves two slots empty."""
    got, engine = _serve_both(arch, max_seq=48)
    assert sorted(got) == list(range(10))
    assert all(len(v) == 8 for v in got.values())
    assert engine.steps == 45


def test_engine_cut_by_max_seq_matches_reference():
    """max_seq 24 stops the second wave part-way and the third never
    starts: both engines return the same partial outputs."""
    got, engine = _serve_both("llama3-8b", max_seq=24)
    assert engine.steps == 23
    lens = sorted(len(v) for v in got.values())
    assert lens == [1] * 4 + [8] * 4 and sorted(got) == list(range(8))


def test_engine_refills_at_staggered_positions_matches_reference():
    """Prompts of 2-9 tokens and 1-6 new tokens: slots finish and refill at
    different positions, each refill over its predecessor's cache."""
    got, _ = _serve_both("glm4-9b", max_seq=64, n=13, prompt_len=(2, 10),
                         max_new=(1, 7), seed=5)
    assert sorted(got) == list(range(13))


def test_engine_over_a_rolling_window_cache_matches_reference():
    """attn_window 8: the cache holds 8 slots and positions wrap past it."""
    got, _ = _serve_both("deepseek-coder-33b", max_seq=40, attn_window=8)
    assert sorted(got) == list(range(10))


def test_engine_refuses_parameters_on_another_device(monkeypatch):
    _, cfg, _, port = models("llama3-8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="parameters"):
        ServingEngine(cfg, port, device="cuda")
