"""``ServingEngine`` serving the encoder-decoder on the port against the JAX
package's on the CPU (whisper-small ``reduced()``): the same parameters
and requests give the same tokens, request for request, with the
reference's traps kept (ROADMAP §3): no ``prefill``, so zero cross K/V;
``enc_len = max_seq``; a self cache of ``dec_len_for(max_seq)`` slots that
rolls as the position embedding wraps; one ``pos`` shared by every slot.
And the port's serving launcher, ``repro_torch.launch.serve.main``, on
the CPU for whisper-small and a decoder-only architecture.
"""

import pytest

from _torch_models import serve_both
from repro_torch.launch import serve
from repro_torch.models.encdec import dec_len_for

ARCH = "whisper-small"


def test_engine_matches_reference_token_for_token():
    """10 requests of 8-token prompts, 8 new tokens each, 4 slots, max_seq
    40: a self cache of 16 slots rolls from pos 16; slots refill at pos 15
    and 30, and max_seq cuts the third wave after 2 new tokens."""
    got, engine = serve_both(ARCH, max_seq=40)
    assert dec_len_for(40) == 16 and engine.steps == 39
    assert sorted(got) == list(range(10))
    assert [len(got[i]) for i in range(10)] == [8] * 8 + [2] * 2


@pytest.mark.parametrize("max_seq", [64, 200])
def test_engine_refills_at_staggered_positions_matches_reference(max_seq):
    """Prompts of 2-9 tokens and 1-6 new tokens: slots finish and refill at
    different positions, each refill over its predecessor's self cache,
    past dec_len_for(max_seq) (16 and 25 slots)."""
    got, engine = serve_both(ARCH, max_seq=max_seq, n=13, prompt_len=(2, 10),
                             max_new=(1, 7), seed=5)
    assert sorted(got) == list(range(13))
    assert engine.steps > dec_len_for(max_seq)


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
def test_launcher_serves_on_the_cpu(capsys, arch):
    """``main(argv)`` with the reference's flags and ``--device cpu``: every
    request served with its new tokens, and the reference's ``[serve]``
    line printed."""
    got = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "6", "--batch", "4", "--max-seq", "48",
                      "--new-tokens", "5"])
    assert sorted(got) == list(range(6))
    assert all(len(v) == 5 for v in got.values())
    assert all(isinstance(t, int) for v in got.values() for t in v)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[serve] {arch}-reduced: 6 requests, 30 tokens, ")
    assert line.endswith(" tok/s)")

