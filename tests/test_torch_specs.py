"""The port's spec functions against the reference's, on the CPU: every
spec tree equal to the reference's, compared as tuples leaf by leaf, for
the ten architectures at their published widths, the four mesh shapes of
``tests/_torch_mesh.py``, both parameter and cache layouts, both
``fsdp_over_pod`` and both ``serving_layout`` values; ``input_specs`` on
the ``meta`` device against the reference's ShapeDtypeStructs; and the
specs' placements on a fake (16, 16) and (2, 16, 16) mesh, each local
shard the size its spec gives.  The port's meshes are ``DeviceMesh``es on
one 512-rank fake process group; the reference's are stand-ins with the
same names and sizes.  Nothing here builds a full-size parameter."""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import distribute_tensor

from _torch_mesh import MESHES, WORLD, RefMesh, fake_world, port_mesh
from repro.configs import base as ref_base
from repro.models import flags as ref_flags
from repro.models import registry as ref_registry
from repro.train import optimizer as ref_optimizer
from repro.train import train_step as ref_train_step
from repro_torch.configs import base
from repro_torch.models import encdec, flags, registry, transformer
from repro_torch.parallel.sharding import P, mesh_axes, tree_shardings
from repro_torch.train import optimizer, train_step
from repro_torch.train.optimizer import AdamWConfig

ARCHS = sorted(base.all_archs())
MESH_NAMES = list(MESHES)


@pytest.fixture(scope="module")
def meshes():
    """name -> (the port's DeviceMesh, the reference's stand-in)."""
    with fake_world(WORLD):
        yield {name: (port_mesh(name), RefMesh(name)) for name in MESHES}


def leaves(tree, prefix=""):
    """Dotted leaf name -> leaf, over nested dicts."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


def flat(tree):
    """Dotted leaf name -> the spec as a tuple."""
    return {k: tuple(v) for k, v in leaves(tree).items()}


def models(arch):
    """(the port's ModelAPI, the reference's), over full-size configs."""
    return (registry.build_model(base.get_config(arch)),
            ref_registry.build_model(ref_base.get_config(arch)))


def leaf_names(cfg):
    fam = encdec if cfg.enc_dec else transformer
    return set(fam.leaf_shapes(cfg))


@pytest.mark.parametrize("fsdp_over_pod", [False, True])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_state_and_opt_specs_match_the_reference(meshes, arch,
                                                      mesh_name,
                                                      fsdp_over_pod):
    """param_specs in both layouts, state_specs and opt_specs."""
    mesh, ref_mesh = meshes[mesh_name]
    model, ref_model = models(arch)
    for layout in ("train", "serve2d"):
        got = flat(model.param_specs(mesh, fsdp_over_pod=fsdp_over_pod,
                                     layout=layout))
        want = flat(ref_model.param_specs(ref_mesh,
                                          fsdp_over_pod=fsdp_over_pod,
                                          layout=layout))
        assert got == want, layout
        assert set(got) == leaf_names(model.cfg)
    got = flat(train_step.state_specs(model, mesh, fsdp_over_pod))
    want = flat(ref_train_step.state_specs(ref_model, ref_mesh, fsdp_over_pod))
    assert got == want and got["step"] == ()
    pspecs = model.param_specs(mesh, fsdp_over_pod=fsdp_over_pod)
    ref_pspecs = ref_model.param_specs(ref_mesh, fsdp_over_pod=fsdp_over_pod)
    assert flat(optimizer.opt_specs(pspecs)) == flat(
        ref_optimizer.opt_specs(ref_pspecs))


@pytest.mark.parametrize("layout", ["batch", "tp2d"])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(meshes, arch, mesh_name, layout):
    mesh, ref_mesh = meshes[mesh_name]
    model, ref_model = models(arch)
    got = flat(model.cache_specs(mesh, layout=layout))
    assert got == flat(ref_model.cache_specs(ref_mesh, layout=layout))
    # one spec a cache leaf, each as long as the leaf has dimensions
    cache = registry.input_specs(model.cfg, base.SHAPES["decode_32k"])["cache"]
    assert got.keys() == cache.keys()
    assert all(len(got[k]) == cache[k].dim() for k in got)


@pytest.mark.parametrize("serving_layout", ["batch", "tp2d"])
@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspec_matches_the_reference(monkeypatch, meshes, arch,
                                           mesh_name, serving_layout):
    """Every SHAPES kind (train, prefill, decode at batch 128 and 1)."""
    assert flags.serving_layout == ref_flags.serving_layout == "batch"
    monkeypatch.setattr(flags, "serving_layout", serving_layout)
    monkeypatch.setattr(ref_flags, "serving_layout", serving_layout)
    mesh, ref_mesh = meshes[mesh_name]
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    for name, shape in base.SHAPES.items():
        got = flat(registry.batch_pspec(cfg, shape, mesh))
        want = flat(ref_registry.batch_pspec(ref_cfg, ref_base.SHAPES[name],
                                             ref_mesh))
        assert got == want, name
        assert all(isinstance(s, P) for s in
                   leaves(registry.batch_pspec(cfg, shape, mesh)).values())


@pytest.mark.parametrize("shape_name", list(base.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_on_meta_match_the_reference(arch, shape_name):
    """Shapes and dtypes of every step input, with no storage: llama3-405b's
    decode cache alone would take over a terabyte."""
    got = leaves(registry.input_specs(base.get_config(arch),
                                             base.SHAPES[shape_name]))
    want = leaves(ref_registry.input_specs(
        ref_base.get_config(arch), ref_base.SHAPES[shape_name]))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert isinstance(t, torch.Tensor) and t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


def test_input_specs_reject_an_unknown_kind(meshes):
    cfg = base.get_config("llama3-8b")
    bad = base.ShapeCfg("x", 8, 2, "serve")
    with pytest.raises(ValueError):
        registry.input_specs(cfg, bad)
    with pytest.raises(ValueError):
        registry.batch_pspec(cfg, bad, meshes["16x16"][0])


# --------------------------------------------------------------------------- #
# the specs as placements: local shards on a fake mesh
# --------------------------------------------------------------------------- #
def _check_local_sizes(mesh, tensors, specs, placements):
    sizes = mesh_axes(mesh)
    for name, x in tensors.items():
        local = distribute_tensor(x, mesh, placements[name]).to_local()
        want = list(x.shape)
        for d, ax in enumerate(specs[name]):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                want[d] //= int(np.prod([sizes[a] for a in axes]))
        assert list(local.shape) == want, (name, specs[name])


@pytest.mark.parametrize("mesh_name, fsdp_over_pod", [("16x16", False),
                                                      ("2x16x16", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_leaves_distribute_to_their_spec_sizes(meshes, arch,
                                                       mesh_name,
                                                       fsdp_over_pod):
    """Every leaf of the reduced architecture, both layouts, through
    ``tree_shardings``: each local shard is ``dim / prod(axis sizes)``
    (safe_spec never emits a spec that does not divide)."""
    mesh = meshes[mesh_name][0]
    cfg = base.get_config(arch).reduced()
    model = registry.build_model(cfg)
    params = leaves(model.init(0, device="cpu").tree())
    sharded = 0
    for layout in ("train", "serve2d"):
        spec_tree = model.param_specs(mesh, fsdp_over_pod=fsdp_over_pod,
                                      layout=layout)
        _check_local_sizes(mesh, params, leaves(spec_tree),
                           leaves(tree_shardings(mesh, spec_tree)))
        sharded += sum(any(a is not None for a in s)
                       for s in leaves(spec_tree).values())
    assert sharded > 0


def test_train_state_distributes_to_its_spec_sizes(meshes):
    mesh = meshes["16x16"][0]
    cfg = base.get_config("hymba-1.5b").reduced()
    model = registry.build_model(cfg)
    state = train_step.make_train_state(model, AdamWConfig(), 0, device="cpu")
    spec_tree = train_step.state_specs(model, mesh)
    tensors = leaves(state)
    assert tensors.keys() == leaves(spec_tree).keys()
    _check_local_sizes(mesh, tensors, leaves(spec_tree),
                       leaves(tree_shardings(mesh, spec_tree)))
