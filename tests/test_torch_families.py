"""The port's moe, ssm and hybrid families held against the JAX package's on
the CPU, all ``reduced()`` in float32 on the reference's parameters
(converted by ``params_from_reference``): forward logits and ``aux``,
``lm_loss`` under both ``xent_impl``s, ``prefill``, each within rtol = atol
= 1e-4; ``params_from_reference`` leaf for leaf, bf16 bits included; and
every decoder-only config's leaves at its published widths.
The decode step is held in ``test_torch_family_decode.py``, the engine in
``test_torch_family_serving.py``, the blocks in ``test_torch_ssm.py`` and
``test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import (DENSE, FAMILIES, MOE, TOL, configs, models,
                           set_flag, tokens)
from repro.models import transformer as ref_tf
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_and_aux_match_reference(arch):
    ref_cfg, cfg, ref_p, port = models(arch)
    tok = tokens(cfg, 2, 16, seed=3)
    want, ref_aux = ref_tf.forward(ref_p, jnp.asarray(tok), ref_cfg)
    got, aux = transformer.forward(port, torch.from_numpy(tok), cfg)
    assert got.shape == (2, 16, cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(ref_aux), **TOL)
    # the moe layers' load-balance + z-loss, summed; 0 without experts
    assert (float(aux) > 0) == (arch in MOE)


@pytest.mark.parametrize("xent", ["onehot", "fused"])
@pytest.mark.parametrize("arch", FAMILIES)
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_matches_reference(arch):
    """An odd prompt length (11): the scan's chunk divides it."""
    ref_cfg, cfg, ref_p, port = models(arch)
    tok = tokens(cfg, 3, 11, seed=6)
    want = ref_build_model(ref_cfg).prefill(ref_p, {"tokens": jnp.asarray(tok)})
    got = build_model(cfg).prefill(port, {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_round_trips_every_leaf(arch):
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_flat = transformer.flatten_tree(jax.tree.map(np.asarray, ref_p))
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(ref_flat) == sorted(transformer.leaf_shapes(cfg))
    for name, want in ref_flat.items():
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), want), name
        assert not got[name].requires_grad


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_keeps_bfloat16_bits(arch):
    ref_cfg, cfg = configs(arch, dtype="bfloat16")
    ref_p = jax.tree.map(np.asarray,
                         ref_build_model(ref_cfg).init(jax.random.PRNGKey(2)))
    port = dict(params_from_reference(cfg, ref_p, device="cpu")
                .named_parameters())
    flat = transformer.flatten_tree(ref_p)
    assert sorted(port) == sorted(flat)
    for name, want in flat.items():
        assert port[name].dtype == torch.bfloat16
        assert np.array_equal(port[name].view(torch.int16).numpy(),
                              want.view(np.int16)), name


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_draws_every_leaf_at_its_shape(arch):
    """The port's own ``init``: the reference's leaves and shapes, the same
    seed the same parameters, in the config's dtype."""
    _, cfg = configs(arch)
    model = build_model(cfg)
    a, b = (dict(model.init(7, device="cpu").named_parameters())
            for _ in range(2))
    assert sorted(a) == sorted(transformer.leaf_shapes(cfg))
    for name, shape in transformer.leaf_shapes(cfg).items():
        assert tuple(a[name].shape) == shape, name
        assert a[name].dtype == torch.float32
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_every_decoder_only_config_builds_at_its_published_widths(arch):
    """``build_model`` takes all nine decoder-only configs, and their leaves
    hold ``param_count()``'s parameters plus the ones it leaves out: the
    norms and the SSM's two biases (no tensor is allocated)."""
    cfg = get_config(arch)
    assert build_model(cfg).cfg is cfg
    shapes = transformer.leaf_shapes(cfg)
    held = sum(int(np.prod(s)) for s in shapes.values())
    L, D = cfg.n_layers, cfg.d_model
    norms = L * D * (1 + ("layers.ln2" in shapes)) + D
    biases = 2 * L * cfg.d_inner
    assert held == cfg.param_count()[0] + norms + biases
