"""The port's sharding rules, elastic mesh derivation and mesh builders
(``repro_torch.parallel.sharding``, ``runtime.elastic``, ``launch.mesh``)
on the CPU, over fake process groups (``tests/_torch_mesh.py``): no card
and no address needed.  ``tests/test_sharding.py``'s first four cases run
here against the port, its meshes ``DeviceMesh``es."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as RefP
from torch.distributed.tensor import Replicate, Shard

from _torch_mesh import fake_world, port_mesh
from repro_torch.configs.base import all_archs
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import encdec, transformer
from repro_torch.models.registry import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (P, attn_mode, compat_make_mesh,
                                           mesh_axes, named, safe_spec,
                                           tree_shardings)
from repro_torch.runtime.elastic import derive_mesh_shape, make_elastic_mesh


@pytest.fixture
def world512():
    with fake_world(512):
        yield


# --------------------------------------------------------------------------- #
# tests/test_sharding.py's first four cases, on the port
# --------------------------------------------------------------------------- #
def test_safe_spec_drops_nondivisible(world512):
    fm = port_mesh("16x16")
    sp = safe_spec((1600, 128), ("model", None), fm)
    assert sp == P("model", None)          # 1600 % 16 == 0
    sp = safe_spec((25, 64), ("model", "data"), fm)
    assert sp == P(None, "data")           # 25 % 16 != 0 -> dropped
    sp = safe_spec((1600,), (("data", "model"),), fm)
    assert sp == P(None)                   # 1600 % 256 != 0 -> dropped
    sp = safe_spec((4096,), (("data", "model"),), fm)
    assert sp == P(("data", "model"))      # 4096 % 256 == 0


def test_attn_mode_per_arch():
    modes = {name: attn_mode(cfg.n_heads, 16)
             for name, cfg in all_archs().items() if cfg.has_attn}
    assert modes["llama3-8b"] == "head"
    assert modes["llama3-405b"] == "head"
    assert modes["deepseek-coder-33b"] == "seqq"   # 56 heads
    assert modes["hymba-1.5b"] == "seqq"           # 25 heads
    assert modes["whisper-small"] == "seqq"        # 12 heads


def test_derive_mesh_shape():
    assert derive_mesh_shape(256, tp=16) == ((16, 16), ("data", "model"))
    assert derive_mesh_shape(512, tp=16, pods=2) == \
        ((2, 16, 16), ("pod", "data", "model"))
    # elastic: losing one host row still yields a valid mesh
    assert derive_mesh_shape(240, tp=16) == ((15, 16), ("data", "model"))
    with pytest.raises(ValueError):
        derive_mesh_shape(250, tp=16)
    with pytest.raises(ValueError):
        derive_mesh_shape(48, tp=16, pods=2)   # 3 rows over 2 pods


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_param_specs_divisible_everywhere(world512, arch):
    """Every spec for every arch evenly divides its dim on the production
    mesh (the dry-run depends on this), from the shapes alone."""
    cfg = all_archs()[arch]
    mesh = port_mesh("16x16")
    sizes = mesh_axes(mesh)
    fam = encdec if cfg.enc_dec else transformer
    shapes = fam.leaf_shapes(cfg)
    model = build_model(cfg)
    for layout in (("train",) if cfg.enc_dec else ("train", "serve2d")):
        specs = transformer.flatten_tree(model.param_specs(mesh, layout=layout))
        assert specs.keys() == shapes.keys(), (arch, layout)
        for name, spec in specs.items():
            for dim, ax in zip(shapes[name], spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                size = int(np.prod([sizes[a] for a in axes]))
                assert dim % size == 0, (arch, layout, name, spec)


# --------------------------------------------------------------------------- #
# the spec type and the placements
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("entries", [
    (), (None,), ("model", None), (None, ("data", "model")),
    (("pod", "data"), None, "model"), (("data",),), ((),), (["a", "b"],),
])
def test_spec_tuple_equals_the_references(entries):
    assert tuple(P(*entries)) == tuple(RefP(*entries))
    assert P(*entries) == tuple(RefP(*entries))


def test_spec_rejects_what_is_not_an_axis():
    with pytest.raises(TypeError):
        P(1)
    with pytest.raises(TypeError):
        P(("data", 2))


def test_mesh_is_read_in_one_place(world512):
    assert mesh_axes(port_mesh("2x16x16")) == {"pod": 2, "data": 16,
                                              "model": 16}
    assert list(mesh_axes(port_mesh("4x2"))) == ["data", "model"]


@pytest.mark.parametrize("spec, want", [
    (P(), (Replicate(), Replicate(), Replicate())),
    (P(None, "model"), (Replicate(), Replicate(), Shard(1))),
    (P("model", ("pod", "data")), (Shard(1), Shard(1), Shard(0))),
    (P(None, None, ("pod", "data", "model")), (Shard(2), Shard(2), Shard(2))),
    (P(("data", "model")), (Replicate(), Shard(0), Shard(0))),
])
def test_named_gives_one_placement_a_mesh_dimension(world512, spec, want):
    assert named(port_mesh("2x16x16"), spec) == want


@pytest.mark.parametrize("spec", [P(("model", "data")), P(("data", "pod")),
                                  P(None, ("model", "pod"))])
def test_axes_out_of_mesh_order_raise(world512, spec):
    with pytest.raises(ValueError, match="mesh order"):
        named(port_mesh("2x16x16"), spec)


def test_an_axis_twice_or_unknown_raises(world512):
    with pytest.raises(ValueError, match="splits dimensions"):
        named(port_mesh("16x16"), P("data", "data"))
    with pytest.raises(ValueError, match="no mesh axis"):
        named(port_mesh("16x16"), P("pod"))


def test_tree_shardings_keeps_the_tree(world512):
    mesh = port_mesh("16x16")
    tree = {"a": P("model", "data"), "b": {"c": P(), "d": P(None, "model")}}
    assert tree_shardings(mesh, tree) == {
        "a": (Shard(1), Shard(0)),
        "b": {"c": (Replicate(), Replicate()),
              "d": (Replicate(), Shard(1))}}


# --------------------------------------------------------------------------- #
# the mesh builders
# --------------------------------------------------------------------------- #
def test_make_elastic_mesh_rounds_down_to_tp():
    """250 healthy ranks at tp 16: a (15, 16) mesh over the first 240."""
    with fake_world(250):
        mesh = make_elastic_mesh(tp=16, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (15, 16)
        assert torch.equal(mesh.mesh, torch.arange(240).reshape(15, 16))


def test_make_elastic_mesh_over_given_ranks(world512):
    ranks = list(range(0, 512, 2))                 # every other rank
    mesh = make_elastic_mesh(tp=16, pods=2, ranks=ranks, device_type="cpu")
    assert tuple(mesh.shape) == (2, 8, 16)
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert torch.equal(mesh.mesh.flatten(), torch.tensor(ranks))


@pytest.mark.parametrize("multi_pod, shape", [(False, (16, 16)),
                                              (True, (2, 16, 16))])
def test_make_production_mesh(world512, multi_pod, shape):
    mesh = launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod
                                   else ("data", "model"))


@pytest.mark.parametrize("world, multi_pod", [(250, False), (256, True),
                                              (8, False)])
def test_make_production_mesh_names_the_world_it_found(world, multi_pod):
    with fake_world(world):
        with pytest.raises(ValueError, match=f"this one has {world}"):
            launch_mesh.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")


def test_single_pod_on_256_ranks():
    with fake_world(256):
        mesh = launch_mesh.make_production_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (16, 16)


def test_mesh_builders_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        launch_mesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        compat_make_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_elastic_mesh(tp=1, device_type="cpu")


def test_compat_make_mesh_takes_the_first_ranks(world512):
    mesh = compat_make_mesh((4, 2), ("data", "model"), device_type="cpu")
    assert tuple(mesh.shape) == (4, 2)
    assert torch.equal(mesh.mesh, torch.arange(8).reshape(4, 2))
    with pytest.raises(ValueError, match="512 ranks"):
        compat_make_mesh((2, 512), ("data", "model"), device_type="cpu")


def test_make_host_mesh_over_the_group():
    with fake_world(1):
        mesh = launch_mesh.make_host_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    with fake_world(4):
        assert tuple(launch_mesh.make_host_mesh(device_type="cpu").shape) \
            == (4, 1)


def test_make_host_mesh_starts_a_one_rank_group(monkeypatch):
    """No group: a one-rank group on an in-process store (the fake backend
    stands in for gloo here, which would look up the host's address)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    calls = []
    real = dist.init_process_group

    def record(backend, store, rank, world_size):
        calls.append((backend, type(store), rank, world_size))
        real("fake", store=FakeStore(), rank=rank, world_size=world_size)

    monkeypatch.setattr(dist, "init_process_group", record)
    assert not dist.is_initialized()
    try:
        mesh = launch_mesh.make_host_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
    assert calls == [("gloo", dist.HashStore, 0, 1)]


def test_axis_constants():
    assert sharding.SINGLE_POD_AXES == ("data", "model")
    assert sharding.MULTI_POD_AXES == ("pod", "data", "model")
