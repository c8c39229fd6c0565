"""Checkpoints carried between the packages, on the CPU: the port keeps
the reference's layout (``step_XXXXXXXX/manifest.json`` and one ``.npy`` a
leaf named by its path joined with ``__``), so a float32 train state saved
by either restores in the other bit for bit, and a bf16 one saved by the
reference restores in the port bit for bit.  The reference cannot restore
its own bf16 checkpoints (its ``restore`` hands the raw ``|V2`` fields to
``jnp.asarray``; ROADMAP §3); the port reads them by the manifest's dtype
and writes bf16 leaves in the same bytes."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from _torch_train import one_thread  # noqa: F401
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs.base import get_config as ref_get_config
from repro.models.registry import build_model as ref_build
from repro.train.optimizer import AdamWConfig as RefAdamW
from repro.train.train_step import make_train_state as ref_state
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.models.weights import state_from_reference
from repro_torch.train import tree as T

pytestmark = pytest.mark.usefixtures("one_thread")
ARCH = "hymba-1.5b"


def _ref_state(dtype, moments="float32", step=0):
    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), dtype=dtype)
    state = ref_state(ref_build(cfg), RefAdamW(moment_dtype=moments),
                      jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    # moments that are not zero, in their own dtype
    state["opt"] = jax.tree.map(
        lambda x: (rng.normal(size=x.shape) * 0.01).astype(x.dtype),
        jax.tree.map(np.asarray, state["opt"]))
    state["step"] = np.int32(step)
    return get_config(ARCH).reduced(), jax.tree.map(np.asarray, state)


def _bits(x) -> np.ndarray:
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _same(port_tree, ref_tree):
    paths, got = T.flatten(port_tree)
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert [tuple(str(k.key) for k in p) for p, _ in want] == paths
    for g, (_, w) in zip(got, want):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy().view(np.uint16),
                                  _bits(w))
        else:
            assert str(g.dtype).split(".")[-1] == w.dtype.name
            assert g.shape == w.shape
            assert np.array_equal(g.numpy(), w)


def test_float32_state_saved_by_the_reference_restores_in_the_port(tmp_path):
    cfg, state = _ref_state("float32", step=7)
    ref_ckpt.save(str(tmp_path), 7, state, meta={"arch": ARCH})
    template = state_from_reference(cfg, state, device="cpu")
    step, got = ckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 7
    _same(got, state)


def test_float32_state_saved_by_the_port_restores_in_the_reference(tmp_path):
    cfg, state = _ref_state("float32", step=3)
    port = state_from_reference(cfg, state, device="cpu")
    ckpt.save(str(tmp_path), 3, port)
    step, got = ref_ckpt.restore(str(tmp_path), state)
    assert step == 3
    _same(port, jax.tree.map(np.asarray, got))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_bf16_state_saved_by_the_reference_restores_in_the_port(tmp_path,
                                                               moments):
    cfg, state = _ref_state("bfloat16", moments, step=11)
    ref_ckpt.save(str(tmp_path), 11, state)
    template = state_from_reference(cfg, state, device="cpu")
    step, got = ckpt.restore(str(tmp_path), template, device="cpu")
    assert step == 11
    _same(got, state)


def test_bf16_checkpoint_is_written_as_the_reference_writes_it(tmp_path):
    """The same bf16 state through both packages' ``save``: the same
    manifest and the same bytes in every ``.npy`` (the bf16 leaves as raw
    '<V2' fields)."""
    cfg, state = _ref_state("bfloat16", "bfloat16", step=2)
    ref_ckpt.save(str(tmp_path / "ref"), 2, state)
    ckpt.save(str(tmp_path / "port"), 2,
              state_from_reference(cfg, state, device="cpu"))
    dirs = [tmp_path / d / "step_00000002" for d in ("ref", "port")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    assert any(v["dtype"] == "bfloat16"
               for v in manifests[0]["leaves"].values())
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1]))
    for name in os.listdir(dirs[0]):
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()


def test_the_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """ROADMAP §3: ``np.load`` gives the bf16 leaves back as ``|V2`` and the
    reference's ``jnp.asarray`` refuses them."""
    _, state = _ref_state("bfloat16", step=1)
    ref_ckpt.save(str(tmp_path), 1, state)
    with pytest.raises(TypeError):
        ref_ckpt.restore(str(tmp_path), state)
