"""The port's dense decoder (``repro_torch.models``) held against the JAX
package's on the CPU, for the dense and vlm architectures (the moe, ssm
and hybrid ones in test_torch_moe.py and test_torch_ssm.py), all
``reduced()`` in float32: forward logits, ``lm_loss`` under both
``xent_impl``s, ``prefill``, the flash path and a sliding window, each
within rtol = atol = 1e-4 of the reference run on the same parameters
(the reference's own ``init``, converted by ``params_from_reference``).
The decode step is held in ``test_torch_model_decode.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import DENSE, OTHER, TOL, configs, models, set_flag, tokens
from repro.models import transformer as ref_tf
from repro.models.registry import build_model as ref_build_model
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_reference(arch):
    ref_cfg, cfg, ref_p, port = models(arch)
    tok = tokens(cfg, 2, 16, seed=3)
    want, ref_aux = ref_tf.forward(ref_p, jnp.asarray(tok), ref_cfg)
    got, aux = transformer.forward(port, torch.from_numpy(tok), cfg)
    assert got.shape == (2, 16, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert float(aux) == float(ref_aux) == 0.0


@pytest.mark.parametrize("xent", ["onehot", "fused"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_matches_reference(monkeypatch, arch, xent):
    set_flag(monkeypatch, "xent_impl", xent)
    ref_cfg, cfg, ref_p, port = models(arch)
    tok = tokens(cfg, 2, 17, seed=4)
    mask = (np.random.default_rng(5).random((2, 16)) < 0.8).astype(np.float32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:], "mask": mask}
    for b in (batch, {k: v for k, v in batch.items() if k != "mask"}):
        want, want_parts = ref_build_model(ref_cfg).loss(
            ref_p, {k: jnp.asarray(v) for k, v in b.items()})
        got, parts = build_model(cfg).loss(
            port, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(got), float(want), **TOL)
        assert sorted(parts) == sorted(want_parts) == ["aux", "loss"]
        for name in parts:
            np.testing.assert_allclose(float(parts[name]),
                                       float(want_parts[name]), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    ref_cfg, cfg, ref_p, port = models(arch)
    tok = tokens(cfg, 3, 10, seed=6)
    want = ref_build_model(ref_cfg).prefill(ref_p, {"tokens": jnp.asarray(tok)})
    got = build_model(cfg).prefill(port, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [32, 29])
@pytest.mark.parametrize("arch", DENSE)
def test_flash_path_matches_reference_flash(monkeypatch, arch, S):
    """kv_block 8 < S: both packages take the blocked online softmax (S 29
    pads the last block with pos_k = -1)."""
    set_flag(monkeypatch, "kv_block", 8)
    ref_cfg, cfg, ref_p, port = models(arch)
    calls = []
    flash = transformer.attn_mod.attention_flash
    monkeypatch.setattr(transformer.attn_mod, "attention_flash",
                        lambda *a, **k: calls.append(k) or flash(*a, **k))
    tok = tokens(cfg, 2, S, seed=7)
    want, _ = ref_tf.forward(ref_p, jnp.asarray(tok), ref_cfg)
    got, _ = transformer.forward(port, torch.from_numpy(tok), cfg)
    assert [c["kv_block"] for c in calls] == [8] * cfg.n_layers
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_sliding_window_matches_reference(arch):
    """attn_window 4: the forward's banded mask, and decode over a rolling
    cache of 4 slots, step by step."""
    ref_cfg, cfg, ref_p, port = models(arch, attn_window=4)
    tok = tokens(cfg, 2, 12, seed=8)
    want, _ = ref_tf.forward(ref_p, jnp.asarray(tok), ref_cfg)
    got, _ = transformer.forward(port, torch.from_numpy(tok), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(p, c, t, pos))
    ref_cache = ref_model.init_cache(2, 12)
    cache = model.init_cache(2, 12, device="cpu")
    assert cache["k"].shape[2] == ref_cache["k"].shape[2] == 4
    for t in range(12):
        want_t, ref_cache = step(ref_p, ref_cache, jnp.asarray(tok[:, t:t + 1]),
                                 jnp.int32(t))
        got_t, cache = model.decode_step(port, cache,
                                         torch.from_numpy(tok[:, t:t + 1]), t)
        np.testing.assert_allclose(_np(got_t), np.asarray(want_t), **TOL)
        np.testing.assert_allclose(_np(got_t), np.asarray(want)[:, t], **TOL)
        assert np.array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_reference_round_trips_every_leaf(arch):
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_flat = transformer.flatten_tree(jax.tree.map(np.asarray, ref_p))
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(ref_flat) == sorted(transformer.leaf_shapes(cfg))
    for name, want in ref_flat.items():
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), want), name
        assert not got[name].requires_grad


def test_params_from_reference_keeps_bfloat16_bits():
    ref_cfg, cfg = configs("llama3-8b", dtype="bfloat16")
    ref_p = jax.tree.map(np.asarray,
                         ref_build_model(ref_cfg).init(jax.random.PRNGKey(2)))
    port = params_from_reference(cfg, ref_p, device="cpu")
    for name, want in transformer.flatten_tree(ref_p).items():
        got = dict(port.named_parameters())[name]
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16)), name


def test_params_from_reference_checks_leaves_and_shapes():
    ref_cfg, cfg, ref_p, _ = models("llama3-8b")
    tree = jax.tree.map(np.asarray, ref_p)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        params_from_reference(cfg, missing, device="cpu")
    extra = dict(tree, layers=dict(tree["layers"], bias=np.zeros(3)))
    with pytest.raises(ValueError, match="layers.bias"):
        params_from_reference(cfg, extra, device="cpu")
    bad = dict(tree, final_norm=np.ones(cfg.d_model + 1, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    """The encoder-decoder runs through ``models/encdec.py``:
    ``build_model`` dispatches on ``cfg.enc_dec`` and gives every entry
    point (test_torch_encdec.py holds them against the reference).  The
    decoder-only functions of ``transformer`` raise for its config, naming
    ``encdec``, and compute nothing else."""
    _, cfg = configs(arch)
    model = build_model(cfg)
    for name in ("init", "loss", "init_cache", "decode_step", "prefill"):
        assert callable(getattr(model, name))
    assert sorted(model.init_cache(1, 16, device="cpu")) == \
        ["k", "pos", "v", "xk", "xv"]
    tok = torch.zeros((1, 2), dtype=torch.int64)
    for call in (lambda: transformer.leaf_shapes(cfg),
                 lambda: transformer.forward({}, tok, cfg),
                 lambda: transformer.init_cache(cfg, 1, 4, torch.device("cpu")),
                 lambda: transformer.decode_step({}, {}, tok[:, :1], 0, cfg),
                 lambda: transformer.init_params(cfg, torch.Generator())):
        with pytest.raises(ValueError, match="encdec"):
            call()
    with pytest.raises(ValueError, match="leaves missing"):
        params_from_reference(cfg, {}, device="cpu")


def test_init_draws_from_the_seed_on_the_device(monkeypatch):
    """``init`` takes a seed or a generator; the same seed gives the same
    parameters; a generator on another device raises."""
    _, cfg = configs("glm4-9b")
    model = build_model(cfg)
    a, b = model.init(5, device="cpu"), model.init(5, device="cpu")
    c = model.init(torch.Generator().manual_seed(6), device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not torch.equal(pa["layers.attn.wq"], pc["layers.attn.wq"])
    for name, shape in transformer.leaf_shapes(cfg).items():
        assert tuple(pa[name].shape) == shape and pa[name].device.type == "cpu"
    assert torch.equal(pa["layers.ln1"], torch.ones(cfg.n_layers, cfg.d_model))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator"):
        model.init(torch.Generator(), device="cuda")
