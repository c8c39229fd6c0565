"""The port's ``decode_step`` for the moe, ssm and hybrid families held
against the JAX package's on the CPU, ``reduced()`` in float32, step by
step under both ``decode_gqa`` paths: logits and every cache leaf (k, v,
the conv window and the SSM state) within rtol = atol = 1e-4, positions
exactly; the port's own decode-matches-forward check within the
reference test's 2e-4; and hymba past its sliding window (reduced window
32, 40 positions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import FAMILIES, TOL, configs, models, set_flag, tokens
from repro.models import transformer as ref_tf
from repro.models.registry import build_model as ref_build_model
from repro_torch.models import transformer
from repro_torch.models.registry import build_model


def _decode_both(ref_cfg, cfg, ref_p, port, tok, cache_len, full=None):
    """Teacher-forced decode on both packages; each step's logits and cache
    leaves compared, and the logits against ``full`` (the port's forward)
    where given.  Returns the port's last cache."""
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(p, c, t, pos))
    B, S = tok.shape
    ref_cache = ref_model.init_cache(B, cache_len)
    cache = model.init_cache(B, cache_len, device="cpu")
    assert sorted(cache) == sorted(ref_cache)
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == ref_cache[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(ref_cache[name].dtype)
    for t in range(S):
        want, ref_cache = step(ref_p, ref_cache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
        got, cache = model.decode_step(port, cache,
                                       torch.from_numpy(tok[:, t:t + 1]), t)
        assert got.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("k", "v", "conv", "ssm"):
            if name in cache:
                np.testing.assert_allclose(cache[name].numpy(),
                                           np.asarray(ref_cache[name]), **TOL)
        if "pos" in cache:
            assert np.array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
        if full is not None:
            np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                       rtol=2e-4, atol=2e-4)
    return cache


@pytest.mark.parametrize("gqa", ["repeat", "grouped"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_reference(monkeypatch, arch, gqa):
    set_flag(monkeypatch, "decode_gqa", gqa)
    ref_cfg, cfg, ref_p, port = models(arch)
    cache = _decode_both(ref_cfg, cfg, ref_p, port, tokens(cfg, 3, 10, 11),
                         cache_len=14)
    if "pos" in cache:                  # a cache longer than the steps
        assert (cache["pos"][:, :, 10:] == -1).all()
    if "ssm" in cache:
        assert cache["ssm"].dtype == torch.float32
        assert cache["conv"].dtype == torch.float32 and \
            cache["conv"].shape[2] == cfg.ssm.d_conv - 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """Teacher-forced decode gives the forward's next-token logits at every
    position (the port's own parameters from its own init)."""
    _, cfg = configs(arch)
    model = build_model(cfg)
    params = model.init(1, device="cpu")
    B, S = 2, 12
    tok = torch.from_numpy(tokens(cfg, B, S, seed=2))
    full, _ = transformer.forward(params, tok, cfg)
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_hybrid_past_its_window_matches_reference():
    """hymba reduced: window 32 at 40 positions.  The forward's banded mask
    against the reference's, then decode over the rolling 32-slot cache
    against the reference's step and the forward, while the SSM state
    carries the whole sequence."""
    ref_cfg, cfg, ref_p, port = models("hymba-1.5b")
    assert cfg.attn_window == 32
    tok = tokens(cfg, 2, 40, seed=8)
    want, _ = ref_tf.forward(ref_p, jnp.asarray(tok), ref_cfg)
    full, _ = transformer.forward(port, torch.from_numpy(tok), cfg)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)
    cache = _decode_both(ref_cfg, cfg, ref_p, port, tok, cache_len=40,
                         full=full)
    assert cache["k"].shape[2] == 32
    assert sorted(np.unique(cache["pos"].numpy()).tolist()) == list(range(8, 40))
