"""``ServingEngine`` on the port against the JAX package's on the CPU: the
same parameters and requests give the same tokens, request for request,
with the reference's slot, refill and stop rules (one ``pos`` shared by
all slots, refills over the predecessor's cache entries, empty slots
decoding their last token; ROADMAP §3)."""

import pytest
import torch

from _torch_models import models, serve_both
from repro_torch.serving.engine import ServingEngine


@pytest.mark.parametrize("arch", ["llama3-8b", "chameleon-34b"])
def test_engine_matches_reference_token_for_token(arch):
    """examples/htap_serve.py's run: 10 requests of 8-token prompts, 8 new
    tokens each, 4 slots, max_seq 48.  Three waves: slots refill at pos 15
    and 30, and the last wave leaves two slots empty."""
    got, engine = serve_both(arch, max_seq=48)
    assert sorted(got) == list(range(10))
    assert all(len(v) == 8 for v in got.values())
    assert engine.steps == 45


def test_engine_cut_by_max_seq_matches_reference():
    """max_seq 24 stops the second wave part-way and the third never
    starts: both engines return the same partial outputs."""
    got, engine = serve_both("llama3-8b", max_seq=24)
    assert engine.steps == 23
    lens = sorted(len(v) for v in got.values())
    assert lens == [1] * 4 + [8] * 4 and sorted(got) == list(range(8))


def test_engine_refills_at_staggered_positions_matches_reference():
    """Prompts of 2-9 tokens and 1-6 new tokens: slots finish and refill at
    different positions, each refill over its predecessor's cache."""
    got, _ = serve_both("glm4-9b", max_seq=64, n=13, prompt_len=(2, 10),
                         max_new=(1, 7), seed=5)
    assert sorted(got) == list(range(13))


def test_engine_over_a_rolling_window_cache_matches_reference():
    """attn_window 8: the cache holds 8 slots and positions wrap past it."""
    got, _ = serve_both("deepseek-coder-33b", max_seq=40, attn_window=8)
    assert sorted(got) == list(range(10))


def test_engine_refuses_parameters_on_another_device(monkeypatch):
    _, cfg, _, port = models("llama3-8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="parameters"):
        ServingEngine(cfg, port, device="cuda")
