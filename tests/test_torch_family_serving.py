"""``ServingEngine`` on the port against the JAX package's on the CPU for
the moe, ssm and hybrid families: the same parameters and requests give
the same tokens, request for request, with the reference's slot, refill
and stop rules (one ``pos`` shared by all slots; a refilled slot goes on
from its predecessor's K/V entries, conv window and SSM state; empty
slots decode their last token; ROADMAP §3)."""

import pytest

from _torch_models import FAMILIES, serve_both


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_reference_token_for_token(arch):
    """examples/htap_serve.py's run (hymba-1.5b is its model): 10 requests
    of 8-token prompts, 8 new tokens each, 4 slots, max_seq 48; slots
    refill at pos 15 and 30, and the last wave leaves two slots empty."""
    got, engine = serve_both(arch, max_seq=48)
    assert sorted(got) == list(range(10))
    assert all(len(v) == 8 for v in got.values())
    assert engine.steps == 45


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_refills_at_staggered_positions_matches_reference(arch):
    """Prompts of 2-9 tokens and 1-6 new tokens: slots finish and refill at
    different positions, each refill over its predecessor's state."""
    got, _ = serve_both(arch, max_seq=64, n=13, prompt_len=(2, 10),
                        max_new=(1, 7), seed=5)
    assert sorted(got) == list(range(13))
