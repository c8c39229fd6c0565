"""The port's mamba block (``repro_torch.models.ssm``) held against the JAX
package's on the CPU, ``reduced()`` in float32: the full-sequence block
against both of the reference's scans ('seq' and 'chunked') at lengths
that are not a multiple of 32, the causal conv, the decode step with its
conv window and SSM state; the block reaching the scan through the
``ssm_scan`` kernel wrapper once per layer (on the CPU the wrapper runs
its plain version); the constant leaves of ``init`` bit for bit; and a
``d_inner`` the kernel does not take raising its ``ValueError``.  Within
rtol = atol = 1e-4 (2e-4 for decode against the full sequence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import SSM, TOL, configs, models, tokens
from repro.models import ssm as ref_ssm
from repro.models.registry import build_model as ref_build_model
from repro_torch.kernels import ssm_scan as scan_kernel
from repro_torch.models import ssm, transformer
from repro_torch.models.registry import build_model


def _layer0(ref_p, port):
    ref_l = jax.tree.map(lambda a: a[0], ref_p["layers"]["ssm"])
    return ref_l, transformer._layer(port.tree()["layers"], 0)["ssm"]


def _x(cfg, B, L, seed):
    return np.random.default_rng(seed).normal(
        size=(B, L, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("L", [37, 45])
@pytest.mark.parametrize("scan_impl", ["seq", "chunked"])
def test_mamba_block_matches_both_reference_scans(scan_impl, L):
    ref_cfg, cfg, ref_p, port = models("falcon-mamba-7b")
    ref_l, lp = _layer0(ref_p, port)
    x = _x(cfg, 2, L, seed=L)
    want = ref_ssm.mamba_block(jnp.asarray(x), ref_l, ref_cfg, scan_impl)
    got = ssm.mamba_block(torch.from_numpy(x), lp, cfg)
    assert got.shape == (2, L, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_conv_matches_reference():
    _, cfg = configs("falcon-mamba-7b")
    rng = np.random.default_rng(1)
    dk, di = cfg.ssm.d_conv, cfg.d_inner
    x = rng.normal(size=(2, 13, di)).astype(np.float32)
    w = rng.normal(size=(dk, di)).astype(np.float32)
    b = rng.normal(size=(di,)).astype(np.float32)
    want = ref_ssm._conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._conv1d_causal(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: the first output sees only the first input and the padding
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0] * w[-1] + b, **TOL)


@pytest.mark.parametrize("arch", SSM)
def test_mamba_decode_step_matches_reference_and_the_block(arch):
    """Step by step from zero states: the output, the conv window and the
    SSM state against the reference's step, and the outputs against the
    full-sequence block (the scan kernel's plain version)."""
    ref_cfg, cfg, ref_p, port = models(arch)
    ref_l, lp = _layer0(ref_p, port)
    B, L = 2, 9
    x = _x(cfg, B, L, seed=2)
    di, N, dk = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    ref_conv = jnp.zeros((B, dk - 1, di), jnp.float32)
    ref_state = jnp.zeros((B, di, N), jnp.float32)
    conv = torch.zeros((B, dk - 1, di))
    state = torch.zeros((B, di, N))
    full = ssm.mamba_block(torch.from_numpy(x), lp, cfg)
    for t in range(L):
        want, ref_conv, ref_state = ref_ssm.mamba_decode_step(
            jnp.asarray(x[:, t:t + 1]), ref_l, ref_cfg, ref_conv, ref_state)
        got, c, s = ssm.mamba_decode_step(torch.from_numpy(x[:, t:t + 1]),
                                          lp, cfg, conv, state)
        assert c is conv and s is state        # written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(ref_conv), **TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), **TOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)
    assert state.dtype == torch.float32


@pytest.mark.parametrize("arch", SSM)
def test_forward_reaches_the_scan_through_its_wrapper(monkeypatch, arch):
    """forward, prefill and the loss each call
    ``repro_torch.kernels.ssm_scan.ssm_scan`` once per layer with the
    block's operands; replacing the wrapper changes the result, so no other
    scan runs."""
    _, cfg, _, port = models(arch)
    calls = []
    wrapper = scan_kernel.ssm_scan

    def record(u, dt, A, Bm, Cm, chunk):
        calls.append((tuple(u.shape), tuple(A.shape), tuple(Bm.shape), chunk))
        return wrapper(u, dt, A, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(scan_kernel, "ssm_scan", record)
    tok = torch.from_numpy(tokens(cfg, 2, 12, seed=3))
    model = build_model(cfg)
    want, _ = transformer.forward(port, tok, cfg)
    di, N = cfg.d_inner, cfg.ssm.d_state
    assert calls == [((2, 12, di), (di, N), (2, 12, N), 4)] * cfg.n_layers
    model.prefill(port, {"tokens": tok[:, :7]})
    assert calls[cfg.n_layers:] == [((2, 7, di), (di, N), (2, 7, N), 1)] * \
        cfg.n_layers
    model.loss(port, {"tokens": tok, "labels": tok})
    assert len(calls) == 3 * cfg.n_layers

    monkeypatch.setattr(scan_kernel, "ssm_scan", lambda u, *a, **k: (
        torch.zeros(u.shape), None))
    got, _ = transformer.forward(port, tok, cfg)
    assert not torch.allclose(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SSM)
def test_init_constant_leaves_equal_the_reference(arch, dtype):
    """``A_log`` (log 1..N, every channel), ``D`` (ones), ``conv_b`` and
    ``dt_bias`` (zeros) of the port's own ``init`` equal the reference's
    ``init``, bit for bit, in float32 and bf16."""
    ref_cfg, cfg = configs(arch, dtype=dtype)
    ref_p = jax.tree.map(np.asarray,
                         ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    port = dict(build_model(cfg).init(0, device="cpu").named_parameters())
    view = np.int16 if dtype == "bfloat16" else np.int32
    tview = torch.int16 if dtype == "bfloat16" else torch.int32
    for leaf in ("A_log", "D", "conv_b", "dt_bias"):
        want = ref_p["layers"]["ssm"][leaf]
        got = port[f"layers.ssm.{leaf}"]
        assert tuple(got.shape) == want.shape
        assert np.array_equal(got.view(tview).numpy(), want.view(view)), leaf


def test_log_f32_is_the_reference_log_at_the_state_indices():
    n = np.arange(1, 4097, dtype=np.float32)
    got = ssm.log_f32(n)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32),
                          np.asarray(jnp.log(jnp.asarray(n))).view(np.int32))
    np.testing.assert_allclose(got, np.log(n.astype(np.float64)), rtol=1e-6)


def test_d_inner_the_kernel_does_not_take_raises():
    """d_model 48: d_inner 96 is not a multiple of the kernel's 128 lanes;
    the forward raises the kernel's ValueError, it does not fall back."""
    _, cfg = configs("falcon-mamba-7b")
    cfg = dataclasses.replace(cfg, d_model=48)
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="D % 128"):
        transformer.forward(params, torch.zeros((1, 4), dtype=torch.int64), cfg)
