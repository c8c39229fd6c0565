"""The port's ``moe_ffn`` (``repro_torch.models.moe``) held against the JAX
package's on the CPU, ``reduced()`` in float32: outputs and aux loss with
and without ``dropless``, within rtol = atol = 1e-4; a capacity that
drops assignments (the reference drops, and the port drops the same
ones); router ties (the port picks the reference's experts, lower index
first); the capacity rules ('gather' and 'ep'); the combine giving the
same bits on a rerun; and a ``moe_impl`` other than 'gather' or 'ep'
raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import MOE, TOL, models, set_flag
from repro.configs.base import MoECfg as RefMoECfg
from repro.models import moe as ref_moe
from repro_torch.configs.base import MoECfg
from repro_torch.models import moe, transformer


def _layer0(ref_p, port):
    ref_l = jax.tree.map(lambda a: a[0], ref_p["layers"]["moe"])
    return ref_l, transformer._layer(port.tree()["layers"], 0)["moe"]


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _both(ref_cfg, cfg, cf):
    return (dataclasses.replace(ref_cfg.moe, capacity_factor=cf),
            dataclasses.replace(cfg.moe, capacity_factor=cf))


def _recording(monkeypatch):
    """Record each call of ``moe.dispatch``: (gate_idx, order, slot, keep)."""
    calls = []
    dispatch = moe.dispatch

    def record(gate_idx, C, E):
        out = dispatch(gate_idx, C, E)
        calls.append((gate_idx, *out))
        return out

    monkeypatch.setattr(moe, "dispatch", record)
    return calls


@pytest.mark.parametrize("dropless,cf", [(True, 4.0), (False, 4.0),
                                         (False, 1.25)])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, dropless, cf):
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_l, lp = _layer0(ref_p, port)
    rm, pm = _both(ref_cfg, cfg, cf)
    x = _x(cfg, 2, 12, seed=1)
    want, want_aux = ref_moe.moe_ffn(jnp.asarray(x), ref_l, rm, dropless)
    got, aux = moe.moe_ffn(torch.from_numpy(x), lp, pm, dropless)
    assert got.shape == x.shape and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_capacity_half_drops_what_the_reference_drops(monkeypatch, arch):
    """capacity_factor 0.5 over 16 tokens: C = 4 slots for 8 assignments an
    expert on average.  The tokens whose reference output differs from its
    dropless output are the tokens the port drops an assignment of, there
    is at least one, and the outputs agree."""
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_l, lp = _layer0(ref_p, port)
    rm, pm = _both(ref_cfg, cfg, 0.5)
    x = _x(cfg, 2, 8, seed=2)
    T, k = 16, cfg.moe.top_k
    assert moe.capacity(pm, T, dropless=False) == 4
    want, _ = ref_moe.moe_ffn(jnp.asarray(x), ref_l, rm)
    full, _ = ref_moe.moe_ffn(jnp.asarray(x), ref_l, rm, dropless=True)
    ref_hit = np.abs(np.asarray(want) - np.asarray(full)).reshape(T, -1) \
        .max(-1) > 1e-6
    calls = _recording(monkeypatch)
    got, _ = moe.moe_ffn(torch.from_numpy(x), lp, pm)
    (_, order, slot, keep), = calls
    t_sorted = torch.arange(T).repeat_interleave(k)[order]
    port_hit = np.zeros(T, bool)
    port_hit[t_sorted[~keep].numpy()] = True
    assert int((~keep).sum()) > 0 and ref_hit.any()
    assert np.array_equal(port_hit, ref_hit)
    assert bool((slot[~keep] == cfg.moe.n_experts * 4).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_pick_the_reference_experts(monkeypatch, top_k):
    """Router columns 0, 2 and 3 equal (small integers, so every token's
    logits tie exactly) and above column 1: both packages take the lowest
    indices among the tied experts, as ``jax.lax.top_k`` does."""
    E, D, F = 4, 8, 16
    rng = np.random.default_rng(3)
    col = rng.integers(1, 3, D).astype(np.float32)
    router = np.stack([col, col - 4, col, col], axis=1)
    p = {"router": router,
         "wg": rng.normal(size=(E, D, F)).astype(np.float32),
         "wu": rng.normal(size=(E, D, F)).astype(np.float32),
         "wd": rng.normal(size=(E, F, D)).astype(np.float32)}
    x = rng.integers(0, 2, (2, 3, D)).astype(np.float32)
    x[..., 0] = 1.0
    want, _ = ref_moe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v)
                                                for k, v in p.items()},
                              RefMoECfg(E, top_k), dropless=True)
    calls = _recording(monkeypatch)
    got, _ = moe.moe_ffn(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()},
                         MoECfg(E, top_k), dropless=True)
    gate_idx = calls[0][0]
    assert gate_idx.tolist() == [[0, 2][:top_k]] * 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_capacity_rule():
    """C: capacity_factor x T x k / E rounded half up, then up to a multiple
    of 4, at least 4 and at most T; T when dropless."""
    cfg = MoECfg(32, 8, 1.25)
    assert moe.capacity(cfg, 128, dropless=False) == 40
    assert moe.capacity(cfg, 128, dropless=True) == 128
    assert moe.capacity(MoECfg(16, 2, 1.25), 6, dropless=False) == 4
    assert moe.capacity(MoECfg(4, 2, 4.0), 3, dropless=False) == 3
    assert moe.capacity(MoECfg(16, 2, 8.0), 100, dropless=False) == 100
    assert moe.capacity(MoECfg(4, 2, 1.0), 13, dropless=False) == 8


def test_capacity_rule_ep():
    """'ep' (the reference's ``moe_ffn_ep``): 2 x capacity_factor x T x k / E
    rounded half up, at least 4, at most T, with no multiple of 4; E / k
    gives T."""
    assert moe.capacity_ep(MoECfg(4, 2, 0.5), 32) == 16
    assert moe.capacity_ep(MoECfg(32, 8, 1.25), 4096) == 2560
    assert moe.capacity_ep(MoECfg(32, 8, 1.25), 100) == 63
    assert moe.capacity_ep(MoECfg(16, 2, 1.25), 6) == 4
    assert moe.capacity_ep(MoECfg(32, 8, 4.0), 2048) == 2048


@pytest.mark.parametrize("impl", ["scatter", "", "EP"])
def test_an_unknown_moe_impl_raises(monkeypatch, impl):
    _, cfg, _, port = models("granite-moe-1b-a400m")
    tok = torch.zeros((1, 4), dtype=torch.long)
    for ok in moe.IMPLS:
        set_flag(monkeypatch, "moe_impl", ok)
        transformer.forward(port, tok, cfg)
    set_flag(monkeypatch, "moe_impl", impl)
    with pytest.raises(ValueError, match="moe_impl"):
        transformer.forward(port, tok, cfg)


@pytest.mark.parametrize("arch", MOE)
def test_combine_gives_the_same_bits_on_a_rerun(arch):
    _, cfg, _, port = models(arch)
    lp = transformer._layer(port.tree()["layers"], 1)["moe"]
    x = torch.from_numpy(_x(cfg, 4, 1, seed=4))
    a, _ = moe.moe_ffn(x, lp, cfg.moe, dropless=True)
    b, _ = moe.moe_ffn(x.clone(), lp, cfg.moe, dropless=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", MOE)
def test_bfloat16_layer_close_to_the_reference(arch):
    """In bf16 (the published dtype) on the same bits: the router, the
    combine's adds in expert order and the expert FFN round as the
    reference's do, within a few bf16 steps."""
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_l, lp = _layer0(ref_p, port)
    ref_l = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ref_l)
    lp = {k: v.to(torch.bfloat16) for k, v in lp.items()}
    x = _x(cfg, 2, 6, seed=5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = ref_moe.moe_ffn(xb, ref_l, ref_cfg.moe, dropless=True)
    got, _ = moe.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), lp, cfg.moe,
                         dropless=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
