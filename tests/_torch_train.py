"""Shared set-up of the training differentials: one reduced float32 state
drawn by the reference's ``make_train_state``, carried into the port by
``state_from_reference``, one token batch from a numpy seed, and the
reference's train step (jitted) and gradients (``jax.value_and_grad`` of
its loss, accumulated over microbatches as its step accumulates them) for
each step variant."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import configs
from repro.models.registry import build_model as ref_build_model
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.train_step import make_train_state as ref_train_state
from repro.train.train_step import make_train_step as ref_train_step
from repro_torch.models.registry import build_model
from repro_torch.models.weights import state_from_reference
from repro_torch.train import tree as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import make_train_step

OPT = dict(lr=1e-3, warmup_steps=0)


@pytest.fixture(scope="module")
def one_thread():
    """PyTorch on one intra-op thread for the module's tests: the reduced
    models' ops are tiny, and with several test workers a pool per worker
    oversubscribes the cores; the count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
# the step variants: microbatches 1 and 2, and the bf16 gradient cast
VARIANTS = {"mb1": {}, "mb2": {"num_microbatches": 2},
            "bf16": {"grad_compression": "bf16"}}
# the reference's own microbatch tolerance for updated parameters
# (tests/test_train.py::test_microbatch_accumulation_equivalent)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
# ... except where AdamW's first step normalises a gradient element near
# zero: g / (|g| + eps) turns a gradient difference within GRAD_TOL into
# an update difference of up to 2 lr where |g| is a few eps.  Such an
# element may lie up to 2 lr off if its reference gradient is under
# NEAR_ZERO (1,000 eps).
NEAR_ZERO = 1e3 * 1e-8
# gradients: float32 on both sides, sums taken in other orders; within
# 1e-4 of each leaf's largest magnitude
GRAD_TOL = 1e-4


def batch_of(cfg, seed, B=4, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32),
             "mask": np.ones((B, S), np.float32)}
    if cfg.enc_dec:
        batch["frames"] = rng.normal(size=(B, 24, cfg.d_model)).astype(
            np.float32)
    return batch


def _ref_grads(ref_model, params, batch, n_mb):
    vg = jax.jit(jax.value_and_grad(ref_model.loss, has_aux=True))
    parts = [{k: v[i * len(v) // n_mb:(i + 1) * len(v) // n_mb]
              for k, v in batch.items()} for i in range(n_mb)]
    if n_mb == 1:
        (loss, _), g = vg(params, batch)
        return float(loss), jax.tree.map(np.asarray, g)
    loss, acc = np.float32(0), None
    for part in parts:
        (l, _), g = vg(params, {k: jnp.asarray(v) for k, v in part.items()})
        g = jax.tree.map(lambda x: np.asarray(x, np.float32), g)
        acc = g if acc is None else jax.tree.map(np.add, acc, g)
        loss = loss + np.float32(l)
    inv = np.float32(1.0 / n_mb)
    return float(loss * inv), jax.tree.map(lambda x: x * inv, acc)


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(port cfg, the reference's initial state as numpy, the batch, per
    variant: (the reference's new state as numpy, its metrics, its loss
    and gradients or None))."""
    ref_cfg, cfg = configs(arch, dtype="float32")
    model = ref_build_model(ref_cfg)
    ocfg = RefAdamW(**OPT)
    state = ref_train_state(model, ocfg, jax.random.PRNGKey(0))
    batch = batch_of(ref_cfg, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name, kw in VARIANTS.items():
        new, metrics = jax.jit(ref_train_step(model, ocfg, **kw))(state, jbatch)
        grads = out["mb1"][2] if name == "bf16" else _ref_grads(
            model, state["params"], batch, kw.get("num_microbatches", 1))
        out[name] = (jax.tree.map(np.asarray, new),
                     {k: float(v) for k, v in metrics.items()}, grads)
    return cfg, jax.tree.map(np.asarray, state), batch, out


def port_step(arch, variant):
    """The port's (new state, metrics, (loss, gradients) or None) from the
    reference's initial state on the CPU."""
    cfg, state, batch, _ = reference(arch)
    kw = VARIANTS[variant]
    step = make_train_step(build_model(cfg), AdamWConfig(**OPT), **kw)
    st = state_from_reference(cfg, state, device="cpu")
    grads = None
    if variant != "bf16":
        loss, _, g = step.grads(st["params"], batch)
        grads = float(loss), g
    new, metrics = step(st, batch)
    return new, {k: float(v) for k, v in metrics.items()}, grads


def check_against_reference(arch, variant):
    """Loss and every metric within 1e-5 relative, every gradient leaf
    within GRAD_TOL of its largest magnitude (the bf16 cast's gradients
    are not compared), every leaf of the new state (parameters, both
    moments, the step) within PARAM_TOL but AdamW's normalised near-zero
    gradient elements (NEAR_ZERO), within 2 lr."""
    _, _, _, ref = reference(arch)
    check_step(port_step(arch, variant), ref[variant])


def check_step(got, want):
    """``check_against_reference``'s comparison of the port's (new state,
    metrics, (loss, gradients) or None) with the reference's (new state
    as numpy, metrics, (loss, gradients as numpy))."""
    want_state, want_m, want_g = want
    got_state, got_m, got_g = got
    assert sorted(got_m) == sorted(want_m)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    if got_g is not None:
        np.testing.assert_allclose(got_g[0], want_g[0], rtol=1e-5)
        paths, want = T.flatten(want_g[1])
        got = T.leaves(got_g[1])
        assert len(got) == len(want)
        for path, g, w in zip(paths, got, want):
            assert g.dtype.itemsize == w.dtype.itemsize, path
            err = np.abs(g.float().numpy() - w.astype(np.float32)).max()
            assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (path, err)
    ref_grads = dict(zip(*T.flatten(want_g[1])))
    paths, want = T.flatten(want_state)
    got = T.leaves(got_state)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        g = g.numpy()
        off = ~np.isclose(g, w, **PARAM_TOL)
        if path[0] == "params" and off.any():
            near = np.abs(ref_grads[path[1:]][off]) < NEAR_ZERO
            assert near.all() and np.abs(g - w)[off].max() <= \
                2 * OPT["lr"], ("__".join(path), np.abs(g - w)[off].max())
            continue
        np.testing.assert_allclose(g, w, **PARAM_TOL, err_msg="__".join(path))
