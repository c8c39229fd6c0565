"""The port's encoder-decoder ``decode_step`` (whisper-small ``reduced()``,
float32) on the CPU: the reference's ``test_decode_matches_forward``
encoder-decoder arm (``tests/test_models_smoke.py``) on the port, decode
logits within 2e-4 of ``decode_train`` after ``prefill`` fills the cross
K/V; and the port's step against the JAX package's, step for step past
the self cache's ``dec_len`` slots, where the cache rolls and the
position embedding wraps: logits and the self cache within rtol = atol =
1e-4, cache positions exactly, with the cross K/V prefilled and with them
left zero, as ``ServingEngine`` leaves them (ROADMAP §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import TOL, configs, models, tokens
from repro.models.registry import build_model as ref_build_model
from repro_torch.models import encdec
from repro_torch.models.registry import build_model

ARCH = "whisper-small"


def _frames(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("seed", [1, 3])
def test_decode_matches_decode_train(seed):
    """The port's own parameters: encode 16 frames, prefill the cross K/V
    into a cache of 16 frames (dec_len 16), then 12 teacher-forced decode
    steps, each within 2e-4 of ``decode_train``'s logits there."""
    _, cfg = configs(ARCH)
    model = build_model(cfg)
    params = model.init(seed, device="cpu")
    B, S = 2, 12
    frames = torch.from_numpy(_frames(cfg, B, 16, seed + 1))
    tok = torch.from_numpy(tokens(cfg, B, S, seed + 2))
    enc_out = encdec.encode(params, frames, cfg)
    full = encdec.decode_train(params, tok, enc_out, cfg)
    cache = model.init_cache(B, 16, device="cpu")
    assert cache["k"].shape[2] == encdec.dec_len_for(16) == 16
    _, cache["xk"], cache["xv"] = model.prefill(params, {"frames": frames})
    for t in range(S):
        lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
        assert lg.shape == (B, cfg.padded_vocab)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)
    assert (cache["pos"][:, :, :S] == torch.arange(S, dtype=torch.int32)).all()
    assert (cache["pos"][:, :, S:] == -1).all()


@pytest.mark.parametrize("prefilled", [True, False])
def test_decode_step_matches_reference_past_dec_len(prefilled):
    """24 teacher-forced steps over a cache of enc_len 40 (dec_len 16): from
    step 16 on, each step overwrites slot pos % 16 and adds the position
    embedding of pos % 16.  The port's logits and self cache equal the
    reference's at every step; with ``prefilled`` False the cross K/V stay
    zero, as in the engine."""
    ref_cfg, cfg, ref_p, port = models(ARCH)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    B, S, Se = 3, 24, 40
    tok = tokens(cfg, B, S, seed=5)
    ref_cache = ref_model.init_cache(B, Se)
    cache = model.init_cache(B, Se, device="cpu")
    assert sorted(cache) == sorted(ref_cache) == ["k", "pos", "v", "xk", "xv"]
    for name, leaf in cache.items():
        assert tuple(leaf.shape) == ref_cache[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(ref_cache[name].dtype)
    assert cache["k"].shape[2] == 16 and cache["xk"].shape[2] == Se
    if prefilled:
        frames = _frames(cfg, B, Se, seed=6)
        _, ref_cache["xk"], ref_cache["xv"] = ref_model.prefill(
            ref_p, {"frames": jnp.asarray(frames)})
        _, cache["xk"], cache["xv"] = model.prefill(
            port, {"frames": torch.from_numpy(frames)})
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(p, c, t, pos))
    for t in range(S):
        want, ref_cache = step(ref_p, ref_cache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
        got, cache = model.decode_step(port, cache,
                                       torch.from_numpy(tok[:, t:t + 1]), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for name in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(ref_cache[name]), **TOL)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    # the last 16 positions, each in its slot pos % 16
    assert sorted(cache["pos"][0, 0].tolist()) == list(range(S - 16, S))
    if not prefilled:
        assert not cache["xk"].any() and not cache["xv"].any()


def test_zero_cross_kv_adds_nothing():
    """Over zero cross K/V the cross-attention is a uniform softmax over
    zero values: a step gives the same logits whatever the query, so the
    engine's decoder runs as if it had no encoder."""
    _, cfg, _, port = models(ARCH)
    model = build_model(cfg)
    tok = torch.from_numpy(tokens(cfg, 2, 1, seed=7))
    tree = port.tree()
    other = {**tree, "dec_layers": {**tree["dec_layers"], "xattn": {
        **tree["dec_layers"]["xattn"],
        "wq": 3 * tree["dec_layers"]["xattn"]["wq"]}}}
    a, _ = model.decode_step(port, model.init_cache(2, 40, device="cpu"), tok, 0)
    b, _ = model.decode_step(other, model.init_cache(2, 40, device="cpu"), tok, 0)
    assert torch.equal(a, b)
