"""The encoder-decoder (reduced whisper-small, float32) under ``ShardCtx``:

* on a one-rank gloo (1, 1) mesh in-process, bit for bit the mesh-less
  path: ``lm_loss`` and every gradient, ``prefill``'s encoder output and
  cross K/V, and STEPS decode steps against that cache under
  ``serving_layout`` 'batch' and 'tp2d' (logits and every cache leaf);
* on a 4-rank gloo (2, 2) mesh against the reference under its
  ``ShardCtx`` on 4 forced host devices: one AdamW step at 1 and 2
  microbatches (``tests/_torch_mesh_train.py``: the loss, the metrics,
  every gradient and every leaf of the new state) with the published
  head layout's 4 heads ('head' mode at `model` 2) and with 3 heads
  ('seqq' mode, as whisper's 12 heads at `model` 16), and ``prefill``
  then STEPS decode steps under both layouts
  (``tests/_torch_mesh_serve.py``), all within ``tests/_torch_train.py``'s
  tolerances."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_mesh import cpu_mesh
from _torch_mesh_serve import ENC, STEPS, check_case
from _torch_mesh_serve import run_cases as run_serve
from _torch_mesh_train import MICROBATCHES
from _torch_mesh_train import run_cases as run_train
from _torch_mesh_train import want_of
from _torch_models import models, set_flag, tokens
from _torch_train import PARAM_TOL, check_step, one_thread  # noqa: F401
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ShardCtx
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P, whole
from repro_torch.train import tree as T

pytestmark = pytest.mark.usefixtures("one_thread")
ARCH = "whisper-small"
LAYOUTS = ["batch", "tp2d"]
TRAIN_CASES = {"head": [ARCH, {}], "seqq": [ARCH, {"n_heads": 3}]}
SERVE_CASES = {f"{ARCH}/{layout}": [ARCH, layout] for layout in LAYOUTS}


@pytest.fixture(scope="module")
def mesh():
    """The (1, 1) mesh on a one-rank gloo group (an in-process store),
    destroyed with the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield cpu_mesh((1, 1))
    finally:
        dist.destroy_process_group()


def _batch(cfg, B=2, S=16):
    tok = torch.from_numpy(tokens(cfg, B, S + 1, 3)).long()
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.normal(size=(B, ENC, cfg.d_model))
                              .astype(np.float32))
    return {"frames": frames, "tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": torch.ones((B, S), dtype=torch.float32)}


def _loss_and_grads(model, tree, batch, ctx=None):
    paths, leaves = T.flatten(tree)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with (ctx or ShardCtx()).scope():
        loss, metrics = model.loss(T.unflatten(paths, live), batch, ctx)
        grads = torch.autograd.grad(loss, live)
    return loss, metrics, grads


def _on_mesh(model, tree, mesh, batch):
    params = sharding.place_tree(tree, mesh, model.param_specs(mesh))
    placed = sharding.place_tree(batch, mesh, {
        k: P("data", *([None] * (v.dim() - 1))) for k, v in batch.items()})
    return params, placed


def test_mesh_loss_and_prefill_are_the_meshless_ones_bit_for_bit(mesh):
    _, cfg, _, port = models(ARCH)
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), port.tree())
    batch = _batch(cfg)
    params, placed = _on_mesh(model, tree, mesh, batch)
    ctx = ShardCtx(mesh)

    l0, m0, g0 = _loss_and_grads(model, tree, batch)
    l1, m1, g1 = _loss_and_grads(model, params, placed, ctx)
    assert torch.equal(whole(l1), l0)
    assert all(torch.equal(whole(m1[k]), m0[k]) for k in m0)
    for path, a, b in zip(T.flatten(tree)[0], g0, g1):
        assert sharding.is_dtensor(b), path
        assert torch.equal(whole(b), a), path

    want = model.prefill(tree, {"frames": batch["frames"]})
    got = model.prefill(params, {"frames": placed["frames"]}, ctx)
    for a, b in zip(want, got):
        assert sharding.is_dtensor(b)
        assert torch.equal(whole(b), a)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_decode_is_the_meshless_decode_bit_for_bit(mesh, monkeypatch,
                                                        layout):
    set_flag(monkeypatch, "serving_layout", layout)
    _, cfg, _, port = models(ARCH)
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), port.tree())
    batch = _batch(cfg)
    params, placed = _on_mesh(model, tree, mesh, batch)
    ctx = ShardCtx(mesh)
    toks = batch["tokens"][:, :STEPS]
    caches = []
    for p, frames, c in ((tree, batch["frames"], None),
                         (params, placed["frames"], ctx)):
        cache = model.init_cache(2, ENC, device="cpu")
        _, cache["xk"], cache["xv"] = model.prefill(p, {"frames": frames}, c)
        logits = []
        for t in range(STEPS):
            lg, cache = model.decode_step(p, cache, toks[:, t:t + 1], t, c)
            logits.append(whole(lg))
        caches.append((logits, cache))
    (want, want_cache), (got, got_cache) = caches
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for name, leaf in got_cache.items():
        assert sharding.is_dtensor(leaf), name
        assert torch.equal(whole(leaf), whole(want_cache[name])), name


@pytest.fixture(scope="module")
def train_results(tmp_path_factory):
    return run_train(TRAIN_CASES, str(tmp_path_factory.mktemp("mesh_encdec")))


@pytest.mark.parametrize("n_mb", MICROBATCHES)
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_step_on_a_2x2_mesh_matches_the_reference(train_results, case, n_mb):
    data, ranks = train_results
    tag = f"{case}/mb{n_mb}"
    check_step(ranks[0][tag], want_of(data, tag))
    for other in ranks[1:]:
        assert other[tag] == ranks[0][tag][1]


@pytest.fixture(scope="module")
def serve_results(tmp_path_factory):
    return run_serve(SERVE_CASES, str(tmp_path_factory.mktemp("mesh_serve")))


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_prefill_and_decode_on_a_2x2_mesh_match_the_reference(serve_results,
                                                             case):
    data, got = serve_results
    check_case(data, got[case], case, PARAM_TOL)
