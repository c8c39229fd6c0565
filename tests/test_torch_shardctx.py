"""``ShardCtx`` on a one-rank gloo (1, 1) mesh on the CPU: the forward, the
loss, every gradient and ``prefill`` of each reduced decoder-only
architecture bit for bit the mesh-less path, from the reference's
parameters (``models/weights.py``); the moe family under
``moe_impl='gather'`` at the published capacity_factor (1.25) and at 0.5,
which drops, and under 'ep' at capacity_factor E / k, where neither path
drops.  With no mesh ``constrain`` hands back its input;
``remat_policy='dots'`` keeps the products' outputs and gives the
gradients of 'nothing'; a moe layer under a ``moe_impl`` other than
'gather' or 'ep' raises.  The encoder-decoder and ``decode_step`` on a
mesh: tests/test_torch_mesh_encdec.py and tests/test_torch_mesh_decode.py."""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_mesh import cpu_mesh
from _torch_models import DENSE, MOE, SSM, models, set_flag, tokens
from _torch_train import one_thread  # noqa: F401
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import ShardCtx
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P, whole
from repro_torch.train import tree as T

pytestmark = pytest.mark.usefixtures("one_thread")
ARCHS = DENSE + SSM


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
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "mask": torch.ones((B, S), dtype=torch.float32)}


def _loss_and_grads(model, tree, batch, ctx=None):
    paths, leaves = T.flatten(tree)
    live = [t.detach().requires_grad_(True) for t in leaves]
    with (ctx or ShardCtx()).scope():
        loss, metrics = model.loss(T.unflatten(paths, live), batch, ctx)
        grads = torch.autograd.grad(loss, live)
    return loss, metrics, grads


def _moe_cases():
    cases = []
    for arch in MOE:
        moe = models(arch)[1].moe
        cases += [(arch, "gather", 1.25), (arch, "gather", 0.5),
                  (arch, "ep", moe.n_experts / moe.top_k)]
    return cases


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_path_is_the_meshless_path_bit_for_bit(mesh, arch):
    _, cfg, _, port = models(arch)
    _check_mesh_path(mesh, cfg, port)


@pytest.mark.parametrize("arch,impl,cf", _moe_cases())
def test_moe_mesh_path_is_the_meshless_path_bit_for_bit(mesh, monkeypatch,
                                                       arch, impl, cf):
    _, cfg, _, port = models(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    set_flag(monkeypatch, "moe_impl", impl)
    _check_mesh_path(mesh, cfg, port)


def _check_mesh_path(mesh, cfg, port):
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), port.tree())
    on_mesh = sharding.place_tree(tree, mesh, model.param_specs(mesh))
    ctx = ShardCtx(mesh)
    batch = _batch(cfg)
    placed = sharding.place_tree(batch, mesh, {k: P("data", None)
                                               for k in batch})

    want, want_aux = transformer.forward(tree, batch["tokens"], cfg)
    got, aux = transformer.forward(on_mesh, placed["tokens"], cfg, ctx)
    assert sharding.is_dtensor(got)
    assert torch.equal(whole(got), want)
    assert torch.equal(whole(aux), want_aux)

    l0, m0, g0 = _loss_and_grads(model, tree, batch)
    l1, m1, g1 = _loss_and_grads(model, on_mesh, placed, ctx)
    assert torch.equal(whole(l1), l0)
    assert all(torch.equal(whole(m1[k]), m0[k]) for k in m0)
    for path, a, b in zip(T.flatten(tree)[0], g0, g1):
        assert sharding.is_dtensor(b), path
        assert torch.equal(whole(b), a), path

    want = model.prefill(tree, {"tokens": batch["tokens"]})
    got = model.prefill(on_mesh, {"tokens": placed["tokens"]}, ctx)
    assert torch.equal(whole(got), want)


def test_constrain_without_a_mesh_is_the_input():
    x = torch.randn(2, 3, 4)
    ctx = ShardCtx()
    assert ctx.constrain(x, ctx.dp, None, "model") is x
    assert ctx.dp is None


def test_constrain_on_a_mesh_places_and_keeps_the_values(mesh):
    x = torch.randn(4, 6)
    ctx = ShardCtx(mesh)
    y = ctx.constrain(x, ctx.dp, "model")
    assert sharding.is_dtensor(y) and ctx.dp == "data"
    assert torch.equal(y.full_tensor(), x)
    assert ctx.constrain(y, ctx.dp, "model") is y      # already so placed
    assert ShardCtx(mesh, force_dp_none=True).dp is None


class _Products(TorchDispatchMode):
    """Counts the products run while it is on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_products(model, tree, batch):
    paths, leaves = T.flatten(tree)
    live = [t.detach().requires_grad_(True) for t in leaves]
    loss, _ = model.loss(T.unflatten(paths, live), batch)
    with _Products() as count:
        grads = torch.autograd.grad(loss, live)
    return grads, count.n


@pytest.mark.parametrize("arch", ["llama3-8b", "hymba-1.5b"])
def test_remat_dots_saves_products_and_keeps_the_gradients(monkeypatch,
                                                          arch):
    """'dots' recomputes fewer products in the backward than 'nothing'
    (its saved ones are not run again) and gives the same gradients, bit
    for bit; an unknown policy raises."""
    _, cfg, _, port = models(arch)
    assert cfg.remat
    model = build_model(cfg)
    tree = T.map_tree(lambda t: t.detach(), port.tree())
    batch = _batch(cfg)
    set_flag(monkeypatch, "remat_policy", "nothing")
    want, n_nothing = _backward_products(model, tree, batch)
    set_flag(monkeypatch, "remat_policy", "dots")
    got, n_dots = _backward_products(model, tree, batch)
    assert n_dots < n_nothing
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    set_flag(monkeypatch, "remat_policy", "everything")
    with pytest.raises(ValueError, match="remat_policy"):
        _backward_products(model, tree, batch)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m"])
def test_ctx_on_the_moe_family_and_the_encdec_raises(mesh, monkeypatch,
                                                     arch):
    """The moe family on a mesh raises for a ``moe_impl`` it does not
    have (the encoder-decoder on a mesh: tests/test_torch_mesh_encdec.py)."""
    _, cfg, _, port = models(arch)
    model = build_model(cfg)
    batch = _batch(cfg)
    set_flag(monkeypatch, "moe_impl", "scatter")
    with pytest.raises(ValueError, match="moe_impl"):
        model.loss(port, batch, ShardCtx(mesh))
    with pytest.raises(ValueError, match="moe_impl"):
        model.prefill(port, batch, ShardCtx(mesh))
    with pytest.raises(ValueError, match="moe_impl"):
        transformer.forward(port, batch["tokens"], cfg, ShardCtx(mesh))
