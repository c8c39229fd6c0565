"""The port's dry-run (``repro_torch.launch.dryrun``) on fake process
groups, on the CPU:

* ``model_flops``, ``default_microbatches`` and ``applicability`` equal the
  reference's for every architecture x shape;
* the reference's mini cell (``tests/test_dryrun_small.py``): reduced
  llama3-8b, ``ShapeCfg("mini_train", 64, 8, "train")`` at 2 microbatches
  on a (4, 2) mesh of 8 fake ranks: FLOPs and collectives counted (the
  data-parallel gradient reduce among them, as ``CommDebugMode`` counts
  them), every record field present;
* the mini cell's train step without a mesh counts exactly the matmul
  FLOPs of a hand count from the config;
* ``run_cell`` on a fake (4, 2) mesh runs a reduced config of each family
  under train, prefill and decode (both serving layouts), the SSM
  families' scans counted by the custom ops' formulas;
* the scan's custom ops: fake shapes equal the plain versions' outputs,
  their FLOP formula equals the plain versions' operations counted op by
  op, and ``FlopCounterMode`` takes it.

The reference's dry-run module sets ``XLA_FLAGS`` to 512 host devices when
it is imported (``src/repro/launch/dryrun.py:1-2``); the fixture that
imports it restores the variable, so a JAX started later in the same
worker is not affected."""

import os

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_train import one_thread  # noqa: F401
from repro.configs import base as ref_base
from repro_torch.configs import base
from repro_torch.configs.base import SHAPES, ShapeCfg, get_config
from repro_torch.kernels import ssm_scan as scan
from repro_torch.launch import card, dryrun

pytestmark = pytest.mark.usefixtures("one_thread")
CARD = "NVIDIA H100 80GB HBM3"
MINI = ShapeCfg("mini_train", 64, 8, "train")
FIELDS = ("arch", "shape", "mesh", "kind", "variant", "ok", "card",
          "trace_s", "mesh_shape", "chips", "rates", "flops_per_device",
          "flops_by_op", "bytes_unfused", "arg_bytes_per_device",
          "collectives", "collective_count", "comm_counts", "terms",
          "dominant", "model_flops_total", "model_flops_per_chip",
          "useful_flop_ratio", "roofline_frac")
FAMILIES = ["llama3-8b", "falcon-mamba-7b", "hymba-1.5b",
            "granite-moe-1b-a400m", "whisper-small"]
KINDS = {"train": ("train", {}), "prefill": ("prefill", {}),
         "decode": ("decode", {}),
         "decode_tp2d": ("decode", {"serving_layout": "tp2d"})}


@pytest.fixture(scope="module")
def ref_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.fixture
def mesh_4x2():
    with dryrun.fake_world(8):
        yield DeviceMesh("cpu", torch.arange(8).reshape(4, 2),
                         mesh_dim_names=("data", "model"))


@pytest.mark.parametrize("arch", sorted(base.all_archs()))
def test_cell_arithmetic_is_the_reference(ref_dryrun, arch):
    cfg, ref_cfg = get_config(arch), ref_base.get_config(arch)
    for name in sorted(SHAPES):
        shape, ref_shape = SHAPES[name], ref_base.SHAPES[name]
        assert dryrun.model_flops(cfg, shape) == \
            ref_dryrun.model_flops(ref_cfg, ref_shape)
        assert dryrun.default_microbatches(cfg, shape) == \
            ref_dryrun.default_microbatches(ref_cfg, ref_shape)
        assert base.applicability(cfg, shape) == \
            ref_base.applicability(ref_cfg, ref_shape)


def test_mini_cell_on_eight_fake_ranks(mesh_4x2):
    cfg = get_config("llama3-8b").reduced()
    rec = dryrun.run_cell("llama3-8b", MINI, "4x2",
                          {"analysis_microbatches": 2}, CARD, cfg=cfg,
                          mesh=mesh_4x2)
    assert rec["ok"] and not rec.get("skipped")
    assert set(FIELDS) <= set(rec), set(FIELDS) - set(rec)
    assert rec["chips"] == 8 and rec["mesh_shape"] == {"data": 4, "model": 2}
    assert rec["variant"]["analysis_microbatches"] == 2
    assert rec["flops_per_device"] > 0 and rec["bytes_unfused"] > 0
    assert rec["arg_bytes_per_device"] > 0
    assert rec["collective_count"] > 0
    # the gradients' reduce over the data ranks
    assert rec["collectives"]["reduce-scatter"]["count"] + \
        rec["collectives"].get("all-reduce", {"count": 0})["count"] > 0
    assert sum(rec["comm_counts"].values()) == rec["collective_count"]
    assert rec["rates"] == {"peak_flops": 989e12, "hbm_Bps": 3.35e12,
                            "link_Bps": 450e9}
    assert rec["dominant"] in rec["terms"]
    assert 0 < rec["roofline_frac"] <= 1


def _hand_count(cfg, shape: ShapeCfg) -> int:
    """The train step's matmul FLOPs: each layer's QKV, scores, PV, output
    and MLP products run forward and twice in the backward (both
    operands' gradients), and again before that under remat but for the
    layer's last product, the MLP's down projection, which the backward
    does not need (``torch.utils.checkpoint`` stops its recompute early);
    the head's product once forward and twice backward."""
    T, B, S = shape.global_batch * shape.seq_len, shape.global_batch, \
        shape.seq_len
    D, F, H, Hkv, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    layer = (2 * T * D * (H + 2 * Hkv) * dh       # q, k, v
             + 2 * 2 * B * H * S * S * dh          # scores, PV
             + 2 * T * H * dh * D                  # output
             + 3 * 2 * T * D * F)                  # gate, up, down
    recompute = layer - 2 * T * F * D if cfg.remat else 0
    head = 2 * T * D * cfg.padded_vocab
    return cfg.n_layers * (3 * layer + recompute) + 3 * head


def test_mini_cell_without_a_mesh_counts_the_hand_count():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer
    from repro_torch.models.registry import build_model, input_specs
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = get_config("llama3-8b").reduced()
    ocfg = AdamWConfig()
    with FakeTensorMode():
        shapes = transformer.leaf_shapes(cfg)
        params = transformer.nest_tree({k: torch.empty(s)
                                        for k, s in shapes.items()})
        state = {"params": params, "opt": init_opt_state(params, ocfg),
                 "step": torch.zeros((), dtype=torch.int32)}
        batch = {k: torch.empty(tuple(v.shape), dtype=v.dtype)
                 for k, v in input_specs(cfg, MINI).items()}
        step = make_train_step(build_model(cfg), ocfg, num_microbatches=2)
        with FlopCounterMode(display=False) as count:
            step(state, batch)
    assert count.get_total_flops() == _hand_count(cfg, MINI)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_on_a_fake_4x2_mesh(mesh_4x2, arch, kind):
    shape_kind, variant = KINDS[kind]
    cfg = get_config(arch).reduced()
    rec = dryrun.run_cell(arch, ShapeCfg("mini", 64, 8, shape_kind), "4x2",
                          variant, CARD, cfg=cfg, mesh=mesh_4x2)
    assert rec["ok"] and rec["flops_per_device"] > 0, rec
    assert rec["collective_count"] > 0
    if cfg.has_ssm and shape_kind != "decode":
        assert rec["flops_by_op"]["repro_torch.ssm_scan"] > 0
        assert ("repro_torch.ssm_scan_bwd" in rec["flops_by_op"]) == \
            (shape_kind == "train")


def test_skipped_cells_are_the_reference_skips(mesh_4x2):
    rec = dryrun.run_cell("llama3-8b", "long_500k", "4x2", {}, CARD,
                          mesh=mesh_4x2)
    assert rec["ok"] and rec["skipped"]
    assert rec["reason"] == base.applicability(get_config("llama3-8b"),
                                               SHAPES["long_500k"])[1]


def test_the_card_is_named_or_found():
    assert dryrun.default_card(CARD) == CARD
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--card"):
            dryrun.default_card(None)
    with pytest.raises(KeyError):
        dryrun.rates_of("TPU v5e")
    assert card.rate(card.BF16_RATE, CARD) == 989e12


# --------------------------------------------------------------------------- #
# the scan's custom ops
# --------------------------------------------------------------------------- #
def _operands(bt=2, length=32, d=128, n=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (f(bt, length, d), torch.from_numpy(
        rng.uniform(0.01, 0.1, (bt, length, d)).astype(np.float32)),
        -torch.from_numpy(rng.uniform(0.5, 2, (d, n)).astype(np.float32)),
        f(bt, length, n), f(bt, length, n))


class _Ops(TorchDispatchMode):
    """The arithmetic of the ops run under it: an elementwise op's output
    elements, a sum's input elements."""
    ELEMENTWISE = {"mul", "add", "sub", "div", "exp", "neg", "mul_", "add_"}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if name in self.ELEMENTWISE:
            self.n += out.numel()
        elif name == "sum":
            self.n += args[0].numel()
        return out


def test_scan_flop_formula_is_the_plain_versions_arithmetic():
    u, dt, A, B, C = _operands()
    with _Ops() as fwd:
        y, _ = scan.ssm_scan_plain(u, dt, A, B, C)
    with _Ops() as bwd:
        scan.ssm_scan_bwd_plain(u, dt, A, B, C, y)
    assert fwd.n == scan.scan_flops(u.shape, A.shape)
    assert bwd.n == scan.scan_flops(u.shape, A.shape, backward=True)


def test_scan_ops_fake_shapes_and_flop_counts():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    ops = _operands()
    want = scan.ssm_scan(*ops)
    want_bwd = scan.ssm_scan_bwd(*ops, want[0])
    mode = FakeTensorMode()
    fake = [mode.from_tensor(t) for t in ops]
    with mode, FlopCounterMode(display=False) as count:
        got = scan.ssm_scan(*fake)
        got_bwd = scan.ssm_scan_bwd(*fake, got[0])
    for g, w in zip(got + got_bwd, want + want_bwd):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    assert count.get_total_flops() == (
        scan.scan_flops(ops[0].shape, ops[2].shape)
        + scan.scan_flops(ops[0].shape, ops[2].shape, backward=True))


def test_strided_shard_arithmetic_is_dtensors():
    """``dryrun._strided_shard`` (sizes and offsets from the shapes alone)
    gives what ``_StridedShard.local_shard_size_and_offset`` gives from its
    index tensor, in every offset mode, even and uneven splits."""
    from torch.distributed.tensor.placement_types import (
        _StridedShard, _StridedShardOffsetMode)
    for size in (0, 1, 5, 16, 17, 63, 64, 100):
        for sf in (1, 2, 3, 4, 8):
            for chunks in (1, 2, 3, 4, 16):
                p = _StridedShard(0, split_factor=sf)
                for rank in range(chunks):
                    for mode in _StridedShardOffsetMode:
                        assert dryrun._strided_shard(
                            p, size, chunks, rank, mode) == \
                            p.local_shard_size_and_offset(size, chunks, rank,
                                                          mode)
