"""The port's ``decode_step`` held against the JAX package's on the CPU,
step by step under both ``decode_gqa`` paths (logits and the k / v caches
within rtol = atol = 1e-4, positions exactly), and the port's own
decode-matches-forward check within the reference test's 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import DENSE, TOL, configs, models, set_flag, tokens
from repro.models.registry import build_model as ref_build_model
from repro_torch.models import transformer
from repro_torch.models.registry import build_model

STEPS = 12


@pytest.mark.parametrize("gqa", ["repeat", "grouped"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_reference(monkeypatch, arch, gqa):
    set_flag(monkeypatch, "decode_gqa", gqa)
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(p, c, t, pos))
    tok = tokens(cfg, 3, STEPS, seed=11)
    # a cache longer than the steps: its tail keeps position -1
    ref_cache = ref_model.init_cache(3, STEPS + 4)
    cache = model.init_cache(3, STEPS + 4, device="cpu")
    for t in range(STEPS):
        want, ref_cache = step(ref_p, ref_cache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
        got, cache = model.decode_step(port, cache,
                                       torch.from_numpy(tok[:, t:t + 1]), t)
        assert got.shape == (3, cfg.padded_vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(ref_cache[name]), **TOL)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert (cache["pos"][:, :, STEPS:] == -1).all()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Teacher-forced decode gives the forward's next-token logits at every
    position (the port's own parameters from its own init)."""
    _, cfg = configs(arch)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 12
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    full, _ = transformer.forward(params, tok, cfg)
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_grouped_and_repeat_decode_agree(monkeypatch):
    """The two GQA evaluations of one decode attention agree on the port."""
    _, cfg = configs("llama3-8b")
    rng = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, cfg.n_heads, cfg.head_dim), generator=rng)
    k, v = (torch.randn((2, 9, cfg.n_kv_heads, cfg.head_dim), generator=rng)
            for _ in range(2))
    pos = torch.tensor([[0, 1, 2, -1, 4, 5, -1, 7, 8]] * 2, dtype=torch.int32)
    outs = []
    for gqa in ("repeat", "grouped"):
        set_flag(monkeypatch, "decode_gqa", gqa)
        outs.append(transformer.attn_mod.decode_attention(q, k, v, pos))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
