"""Checkpoints of a state on a mesh, on the CPU.  On a 4-rank gloo group
(``_torch_mesh.spawn``): a reduced hymba-1.5b state, one step into
training on the (2, 2) mesh, is saved (every rank gathers, rank 0 alone
writes) and restored onto (2, 2), onto (4, 1) through ``spec_tree`` (the
elastic re-shard) and with no mesh, each leaf bit for bit; the training
loop's restart on the (2, 2) mesh replays a failure-free run bit for bit.
In this process, on a one-rank group: the reference's
``tests/test_train.py::test_checkpoint_elastic_reshard``."""

import os

import pytest
import torch
import torch.distributed as dist

from _torch_mesh import cpu_mesh, gathered, spawn
from repro_torch.checkpoint import ckpt
from repro_torch.parallel.sharding import P, is_dtensor
from repro_torch.train import tree as T

ARCH = "hymba-1.5b"
LOOP_ARCH = "falcon-mamba-7b"


def _batch(cfg, seed, B=4, S=16):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": torch.ones((B, S), dtype=torch.float32)}


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(T.leaves(a), T.leaves(b)))


def _worker(rank, world, directory):
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (make_train_state,
                                              make_train_step, state_specs)

    out = {}
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    m22, m41 = cpu_mesh((2, 2)), cpu_mesh((4, 1))
    step = make_train_step(model, ocfg, m22)
    state, _ = step(make_train_state(model, ocfg, 0, device="cpu"),
                    _batch(cfg, 0))
    whole = gathered(state)
    d = os.path.join(directory, "ck")
    ckpt.save(d, 1, state)
    # only rank 0 writes: each rank saves into a directory of its own
    ckpt.save(os.path.join(directory, f"rank{rank}"), 1, state)
    out["written"] = os.path.isdir(os.path.join(directory, f"rank{rank}"))

    _, r22 = ckpt.restore(d, state, mesh=m22,
                          spec_tree=state_specs(model, m22))
    out["r22_local"] = all(
        x.placements == y.placements and torch.equal(x.to_local(),
                                                      y.to_local())
        for x, y in zip(T.leaves(state), T.leaves(r22)))
    spec41 = state_specs(model, m41)
    _, r41 = ckpt.restore(d, state, mesh=m41, spec_tree=spec41)
    out["r41_placed"] = [tuple(x.placements) for x in T.leaves(r41)]
    out["r41_shapes"] = [tuple(x.to_local().shape) for x in T.leaves(r41)]
    out["r41"] = gathered(r41)
    _, plain = ckpt.restore(d, state, device="cpu")
    out["plain_is_plain"] = not any(is_dtensor(x) for x in T.leaves(plain))
    out["plain"] = plain
    out["whole"] = whole

    # the loop's restart on the mesh against a failure-free run
    lcfg = get_config(LOOP_ARCH).reduced()
    lmodel = build_model(lcfg)
    lstep = make_train_step(lmodel, ocfg, m22, num_microbatches=2)
    init = make_train_state(lmodel, ocfg, 0, device="cpu")
    runs = []
    for name, fails in (("clean", ()), ("faulty", (3,))):
        res = run(lstep, init, lambda s: _batch(lcfg, s % 3),
                  LoopConfig(total_steps=4, ckpt_dir=os.path.join(
                      directory, name), ckpt_every=2),
                  injector=FailureInjector(fail_at_steps=fails),
                  log_every=100, logger=lambda s: None)
        runs.append((res.restarts, gathered(res.state),
                     [m["loss_total"] for m in res.metrics_history]))
    out["runs"] = runs
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(_worker, 4, str(tmp_path_factory.mktemp("mesh_ckpt")),
                 timeout=300)


def test_only_rank_0_writes(ranks):
    assert [r["written"] for r in ranks] == [True, False, False, False]


def test_restore_onto_the_same_mesh_is_bit_for_bit(ranks):
    assert all(r["r22_local"] for r in ranks)


def test_restore_onto_4x1_reshards_bit_for_bit(ranks):
    """Each leaf placed by its (4, 1) spec, each rank's part the size the
    spec gives, the whole leaf the saved one."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.parallel.sharding import named
    from repro_torch.train.train_step import state_specs

    from _torch_mesh import fake_world
    with fake_world(4):
        mesh = cpu_mesh((4, 1))
        specs = T.leaves(state_specs(build_model(get_config(ARCH).reduced()),
                                     mesh))
        want = [named(mesh, s) for s in specs]
    whole = T.leaves(ranks[0]["whole"])
    for r in ranks:
        assert r["r41_placed"] == want
        assert _same(r["r41"], ranks[0]["whole"])
    for spec, leaf, local in zip(specs, whole, ranks[0]["r41_shapes"]):
        split = [4 if e == "data" else 1 for e in spec]
        split += [1] * (leaf.dim() - len(split))
        assert local == tuple(n // k for n, k in zip(leaf.shape, split))


def test_restore_without_a_mesh_is_bit_for_bit(ranks):
    for r in ranks:
        assert r["plain_is_plain"] and _same(r["plain"], ranks[0]["whole"])


def test_loop_restart_on_a_mesh_replays_bit_for_bit(ranks):
    for r in ranks:
        (n0, clean, l0), (n1, faulty, l1) = r["runs"]
        assert (n0, n1) == (0, 1)
        assert int(clean["step"]) == int(faulty["step"]) == 4
        assert _same(faulty, clean)
        assert l1[-1] == l0[-1]


def test_checkpoint_elastic_reshard(tmp_path):
    """The reference's case: save unsharded, restore onto a mesh through
    ``spec_tree``."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = cpu_mesh((1, 1))
        tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
        d = str(tmp_path / "ck")
        ckpt.save(d, 1, tree)
        step, restored = ckpt.restore(d, tree, mesh=mesh,
                                      spec_tree={"w": P(None, None)})
        assert step == 1 and is_dtensor(restored["w"])
        assert torch.equal(restored["w"].full_tensor(), tree["w"])
    finally:
        dist.destroy_process_group()
