"""The training substrate on the port, on the CPU: ``tests/test_train.py``'s
eight cases (optimization progress, microbatch-accumulation equivalence,
checkpoint round trip, keep-last, a restore onto another device than the
template's, the fault-tolerant loop with injected failures, straggler
detection, the bf16 gradient cast), the loop's restart from
``init_state`` before the first checkpoint, ``apply_updates`` and the
schedule against the reference's, serving left graph-free, and
``tests/test_system.py::test_store_to_train_step_integration`` with the
port's TokenStore.  llama3-8b reduced, as the reference's tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401
from repro.train import optimizer as ref_opt
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.models.registry import build_model
from repro_torch.runtime.fault import FailureInjector, StepMonitor
from repro_torch.train import tree as T
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         init_opt_state, schedule)
from repro_torch.train.train_step import make_train_state, make_train_step

pytestmark = pytest.mark.usefixtures("one_thread")
CFG = get_config("llama3-8b").reduced()


def batch_of(seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab, (B, S + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
            "mask": torch.ones((B, S), dtype=torch.float32)}


def _state(ocfg, seed=0):
    return make_train_state(build_model(CFG), ocfg, seed, device="cpu")


def test_loss_decreases_over_steps():
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = make_train_state(model, ocfg, 0, device="cpu")
    step = make_train_step(model, ocfg)
    batch = batch_of(0)
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss_total"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatch_accumulation_equivalent():
    """n_mb=1 and n_mb=4 must produce (nearly) identical updates."""
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state0 = make_train_state(model, ocfg, 0, device="cpu")
    batch = batch_of(1, B=8)
    s1, m1 = make_train_step(model, ocfg, num_microbatches=1)(state0, batch)
    s4, m4 = make_train_step(model, ocfg, num_microbatches=4)(state0, batch)
    np.testing.assert_allclose(float(m1["loss_total"]), float(m4["loss_total"]),
                               rtol=1e-5)
    for a, b in zip(T.leaves(s1["params"]), T.leaves(s4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_checkpoint_roundtrip(tmp_path):
    state = _state(AdamWConfig(), 3)
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state, meta={"arch": CFG.name})
    step, restored = ckpt.restore(d, state, device="cpu")
    assert step == 7
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_keep_last(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.arange(4)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, keep_last=2)
    assert ckpt.all_steps(d) == [4, 5]


def test_checkpoint_restores_onto_another_device(tmp_path):
    """The reference's elastic case re-shards onto a mesh (ROADMAP §1 item
    5(g)); on one card a restore goes to the device asked for, whatever
    device the template lies on (here 'meta': only its structure counts)."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tree)
    template = T.map_tree(lambda t: t.to("meta"), tree)
    step, restored = ckpt.restore(d, template, device="cpu")
    assert step == 1
    for k in tree:
        assert restored[k].device.type == "cpu"
        assert torch.equal(restored[k], tree[k])


@pytest.mark.parametrize("fails", [(7, 13), (3, 7, 13)])
def test_fault_tolerant_loop_restores(tmp_path, fails):
    """(7, 13): the reference's case, a restore from the checkpoints of
    steps 5 and 10; (3, 7, 13) adds a failure before the first checkpoint,
    where the loop restarts from ``init_state``, which a step writing in
    place would have turned into a trained state by then."""
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    init = make_train_state(model, ocfg, 0, device="cpu")
    kept = [t.clone() for t in T.leaves(init)]
    step = make_train_step(model, ocfg)
    inj = FailureInjector(fail_at_steps=fails)
    log = []
    res = run(step, init, lambda s: batch_of(s % 3),
              LoopConfig(total_steps=16, ckpt_dir=str(tmp_path / "ck"),
                         ckpt_every=5, async_ckpt=True),
              injector=inj, log_every=100, logger=log.append)
    assert res.restarts == len(fails)
    assert int(res.state["step"]) == 16
    assert ("[loop] no checkpoint yet; restarting from init" in log) == \
        (fails[0] < 5)
    # init_state is never written
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(init), kept))
    # deterministic replay: a failure-free run over the same stream ends
    # at the same loss
    res2 = run(make_train_step(model, ocfg), _state(ocfg),
               lambda s: batch_of(s % 3),
               LoopConfig(total_steps=16, ckpt_dir=str(tmp_path / "ck2"),
                          ckpt_every=100, async_ckpt=False),
               log_every=100, logger=lambda s: None)
    np.testing.assert_allclose(res.metrics_history[-1]["loss_total"],
                               res2.metrics_history[-1]["loss_total"],
                               rtol=1e-4)


def test_loop_resumes_from_the_latest_checkpoint(tmp_path):
    """A second run over a directory with checkpoints starts from the
    newest one (the cold restart path) and ends where one run would."""
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(model, ocfg)
    d = str(tmp_path / "ck")
    run(step, _state(ocfg), lambda s: batch_of(s % 3),
        LoopConfig(total_steps=4, ckpt_dir=d, ckpt_every=2, async_ckpt=False),
        logger=lambda s: None)
    log = []
    res = run(step, _state(ocfg), lambda s: batch_of(s % 3),
              LoopConfig(total_steps=6, ckpt_dir=d, ckpt_every=2,
                         async_ckpt=False), logger=log.append)
    assert log[0] == "[loop] resumed from step 4"
    assert len(res.metrics_history) == 2
    whole = run(step, _state(ocfg), lambda s: batch_of(s % 3),
                LoopConfig(total_steps=6, ckpt_dir=str(tmp_path / "one"),
                           ckpt_every=100, async_ckpt=False),
                logger=lambda s: None)
    np.testing.assert_allclose(res.metrics_history[-1]["loss_total"],
                               whole.metrics_history[-1]["loss_total"],
                               rtol=1e-6)


def test_straggler_detection():
    mon = StepMonitor(alpha=0.5, straggler_factor=2.0, warmup=2)
    for i in range(10):
        flagged = mon.record(i, 0.1)
        assert not flagged
    assert mon.record(11, 0.5)  # 5x the EWMA
    assert mon.stragglers == [11]
    assert abs(mon.ewma - 0.1) < 1e-6  # straggler did not poison the EWMA


def test_grad_compression_hook_runs():
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device="cpu")
    step = make_train_step(model, ocfg, grad_compression="bf16")
    _, _, grads = step.grads(state["params"], batch_of(0))
    assert all(g.dtype == torch.bfloat16 for g in T.leaves(grads))
    state2, m = step(state, batch_of(0))
    assert np.isfinite(float(m["loss_total"]))
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, ocfg, grad_compression="fp8")


def test_train_state_keeps_the_reference_leaf_names():
    """make_train_state's leaves, by checkpoint name, shape and dtype, are
    the reference's make_train_state's (moments in moment_dtype)."""
    from repro.configs.base import get_config as ref_get_config
    from repro.models.registry import build_model as ref_build
    from repro.train.train_step import make_train_state as ref_state

    for mdt in ("float32", "bfloat16"):
        want = ref_state(ref_build(ref_get_config("hymba-1.5b").reduced()),
                         ref_opt.AdamWConfig(moment_dtype=mdt),
                         jax.random.PRNGKey(0))
        got = make_train_state(build_model(get_config("hymba-1.5b").reduced()),
                               AdamWConfig(moment_dtype=mdt), 0, device="cpu")
        want = {"__".join(str(k.key) for k in p): (tuple(v.shape), v.dtype.name)
                for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
        paths, leaves = T.flatten(got)
        got = {"__".join(p): (tuple(v.shape), str(v.dtype).split(".")[-1])
               for p, v in zip(paths, leaves)}
        assert got == want
        assert list(got) == list(want)       # the reference's leaf order


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance between two float32 arrays in units in the
    last place (as ordered integers)."""
    ia, ib = (x.astype(np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("clip", [100.0, 0.5])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 3, 150])
def test_apply_updates_matches_the_reference(clip, mdt, step):
    """Identical float32 parameters, gradients and moments: the port's
    ``apply_updates`` against the reference's.  The element-wise update is
    the reference's operation for operation, so with the clip off (100 >
    the norm) every leaf and lr agree within 2 float32 ulps (bit for bit
    here) and the norm within 2 (XLA and PyTorch sum the squares in their
    own order).  With the clip on (0.5) the norm's ulp reaches the clip
    factor, and through it the moments: within 4 ulps."""
    ocfg = dict(lr=3e-3, warmup_steps=5, total_steps=300, weight_decay=0.1,
                grad_clip=clip, moment_dtype=mdt)
    rng = np.random.default_rng(step)
    shapes = {"a": (3, 7), "b": {"c": (5,), "d": (2, 3, 4)}}

    def mk(scale):
        return T.map_tree(lambda s: (rng.normal(size=s) * scale).astype(
            np.float32), shapes)

    params, grads = mk(1.0), mk(3.0)
    mu, nu = mk(0.1), T.map_tree(np.abs, mk(0.01))
    cast = lambda t: T.map_tree(lambda x: x.astype(jnp.dtype(mdt)), t)
    opt = {"mu": cast(mu), "nu": cast(nu)}
    want = ref_opt.apply_updates(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, opt), jnp.int32(step),
        ref_opt.AdamWConfig(**ocfg))
    tt = lambda t: T.map_tree(lambda x: torch.from_numpy(
        np.asarray(x, np.float32)).to(getattr(torch, mdt)), t)
    got = apply_updates(T.map_tree(torch.from_numpy, params),
                        T.map_tree(torch.from_numpy, grads),
                        {"mu": tt(opt["mu"]), "nu": tt(opt["nu"])},
                        torch.tensor(step, dtype=torch.int32),
                        AdamWConfig(**ocfg))
    assert _ulps(got[2]["lr"].numpy(), np.asarray(want[2]["lr"])) <= 2
    assert _ulps(got[2]["grad_norm"].numpy(),
                 np.asarray(want[2]["grad_norm"])) <= 2
    for g, w in zip(T.leaves(got[0]), jax.tree.leaves(want[0])):
        assert g.dtype == torch.float32
        assert _ulps(g.numpy(), np.asarray(w)) <= 2
    for k in ("mu", "nu"):
        for g, w in zip(T.leaves(got[1][k]), jax.tree.leaves(want[1][k])):
            assert str(g.dtype).split(".")[-1] == mdt
            assert _ulps(g.float().numpy(), np.asarray(w, np.float32)) <= \
                (2 if clip > 1 else 4)


def test_schedule_matches_the_reference():
    ocfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    steps = [0, 1, 50, 99, 100, 101, 400, 999, 1000, 5000]
    want = [np.asarray(ref_opt.schedule(jnp.int32(s),
                                        ref_opt.AdamWConfig(**ocfg)))
            for s in steps]
    got = [schedule(torch.tensor(s, dtype=torch.int32),
                    AdamWConfig(**ocfg)).numpy() for s in steps]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert _ulps(g, w) <= 2


def test_init_opt_state_is_zero_in_the_moment_dtype():
    params = {"w": torch.ones((2, 3), dtype=torch.bfloat16)}
    opt = init_opt_state(params, AdamWConfig(moment_dtype="bfloat16"))
    assert opt["mu"]["w"].dtype == torch.bfloat16
    assert not opt["nu"]["w"].any()


def test_train_step_is_functional_and_serving_stays_graph_free():
    """The step leaves its input state as it was and returns tensors that
    do not require grad; after it, the model's prefill and decode build no
    autograd graph, and a DecoderLM's parameters still require none."""
    model = build_model(CFG)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device="cpu")
    kept = [t.clone() for t in T.leaves(state)]
    new, m = make_train_step(model, ocfg)(state, batch_of(2))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(state), kept))
    assert not any(t.requires_grad for t in T.leaves(new))
    assert not any(v.requires_grad for v in m.values())
    tok = batch_of(3)["tokens"]
    logits = model.prefill(new["params"], {"tokens": tok})
    assert logits.grad_fn is None and not logits.requires_grad
    cache = model.init_cache(4, 8, device="cpu")
    out, _ = model.decode_step(new["params"], cache, tok[:, :1], 0)
    assert out.grad_fn is None
    assert not any(p.requires_grad for p in model.init(0, device="cpu")
                   .parameters())


def test_loss_takes_the_reference_signature():
    """``loss(p, b, ctx=None, scan_impl='seq')``; a mesh context raises."""
    model = build_model(CFG)
    params = model.init(0, device="cpu")
    b = batch_of(4)
    a, _ = model.loss(params, b)
    c, _ = model.loss(params, b, None, "chunked")
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="ctx"):
        model.loss(params, b, object())


def test_remat_recomputes_and_keeps_the_gradients():
    """cfg.remat (True in every config) wraps each layer in
    torch.utils.checkpoint while grad is enabled; the gradients equal the
    ones without remat."""
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(CFG, remat=remat)
        model = build_model(cfg)
        state = make_train_state(model, AdamWConfig(), 0, device="cpu")
        out.append(make_train_step(model, AdamWConfig()).grads(
            state["params"], batch_of(5)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(T.leaves(out[0][2]), T.leaves(out[1][2])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_store_to_train_step_integration():
    """TokenStore batches feed a real train step and the loss drops."""
    from repro_torch.core.opd import Predicate as Pred
    from repro_torch.pipeline.tokenstore import TokenStore, TokenStoreConfig

    cfg = CFG
    store = TokenStore(TokenStoreConfig(file_bytes=64 * 1024), device="cpu")
    rng = np.random.default_rng(0)
    # learnable structure: repeated n-grams
    motif = rng.integers(0, cfg.vocab, 16)
    for i in range(400):
        reps = np.tile(motif, 20)
        store.put_sample(i, reps.astype(np.int32), b"web/high")
    batches = list(store.batches(Pred("prefix", b"web/high"), 4, 32,
                                 max_batches=8))
    assert batches
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=2e-3, warmup_steps=0)
    state = make_train_state(model, ocfg, 0, device="cpu")
    step = make_train_step(model, ocfg)
    losses = []
    for s in range(10):
        state, m = step(state, batches[s % len(batches)])
        losses.append(float(m["loss_total"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    reference's flags, TokenStore batches, the loop with checkpoints."""
    from repro_torch.launch import train

    res = train.main(["--arch", "hymba-1.5b", "--reduced", "--steps", "3",
                      "--ckpt", str(tmp_path), "--ckpt-every", "2",
                      "--microbatches", "2", "--device", "cpu"])
    assert int(res.state["step"]) == 3 and len(res.metrics_history) == 3
    assert ckpt.all_steps(str(tmp_path)) == [2, 3]
    out = capsys.readouterr().out
    assert "[train] hymba-1.5b-reduced" in out
    assert "[train] finished at step 3" in out
