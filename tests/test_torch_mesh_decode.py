"""``decode_step`` under ``ShardCtx`` for the dense, ssm, hybrid and moe
families (reduced llama3-8b, falcon-mamba-7b, hymba-1.5b and
granite-moe-1b-a400m, float32) under ``serving_layout`` 'batch' and 'tp2d':

* on a one-rank gloo (1, 1) mesh in-process, STEPS decode steps from the
  same parameters and cache bit for bit the mesh-less steps: every
  step's logits and every leaf of the cache after them;
* on a 4-rank gloo (2, 2) mesh against the reference's ``decode_step``
  jitted under its ``ShardCtx`` on 4 forced host devices
  (``tests/_torch_mesh_serve.py``): every step's logits and the final
  cache within ``tests/_torch_train.py``'s parameter tolerance, the
  cache's positions exactly.  Under 'batch' the cache's batch lies over
  `data` and its sequence over `model`; under 'tp2d' the batch is
  replicated and the sequence split over both, so each step's softmax
  combines the ranks' maxima and sums (``decode_attention_mesh``)."""

import pytest
import torch
import torch.distributed as dist

from _torch_mesh import cpu_mesh
from _torch_mesh_serve import S_CACHE, STEPS, check_case, run_cases
from _torch_models import models, set_flag, tokens
from _torch_train import PARAM_TOL, one_thread  # noqa: F401
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ShardCtx
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import whole
from repro_torch.train import tree as T

pytestmark = pytest.mark.usefixtures("one_thread")
ARCHS = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b", "granite-moe-1b-a400m"]
LAYOUTS = ["batch", "tp2d"]
CASES = {f"{arch}/{layout}": [arch, layout] for arch in ARCHS
         for layout in LAYOUTS}


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


def _steps(model, params, cache, toks, ctx=None):
    out = []
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t,
                                          ctx)
        out.append(whole(logits))
    return out, cache


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_is_the_meshless_decode_bit_for_bit(mesh, monkeypatch,
                                                        arch, layout):
    set_flag(monkeypatch, "serving_layout", layout)
    _, cfg, _, port = models(arch)
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), port.tree())
    p_layout = "serve2d" if layout == "tp2d" else "train"
    on_mesh = sharding.place_tree(tree, mesh,
                                  model.param_specs(mesh, layout=p_layout))
    toks = torch.from_numpy(tokens(cfg, 2, STEPS, 5)).long()
    want, want_cache = _steps(model, tree, model.init_cache(
        2, S_CACHE, device="cpu"), toks)
    got, got_cache = _steps(model, on_mesh, model.init_cache(
        2, S_CACHE, device="cpu"), toks, ShardCtx(mesh))
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert sorted(want_cache) == sorted(got_cache)
    for name, leaf in got_cache.items():
        assert sharding.is_dtensor(leaf), name
        assert torch.equal(whole(leaf), want_cache[name]), name


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(CASES, str(tmp_path_factory.mktemp("mesh_decode")))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_on_a_2x2_mesh_matches_the_reference(results, case):
    data, got = results
    check_case(data, got[case], case, PARAM_TOL)
