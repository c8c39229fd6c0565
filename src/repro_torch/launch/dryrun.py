"""Multi-pod dry-run and roofline on fake meshes, the port of
``repro/launch/dryrun.py``.

For every (architecture x input shape x mesh) cell:

1. build the step: ``make_train_step``'s train step, ``prefill`` or
   ``decode_step``, under ``ShardCtx`` on the production mesh, (16, 16) or
   (2, 16, 16), over a fake process group of 256 or 512 ranks (backend
   'fake': no device, and no collective moves a byte);
2. place its parameters, optimizer state, batch and cache by the
   reference's specs (``param_specs``, ``state_specs``, ``batch_pspec``) as
   DTensors whose local shards are fake tensors (``FakeTensorMode``: a
   shape and a dtype, no storage);
3. trace the step once.  The trace running through proves the
   distribution coherent: every placement divides, every redistribution
   has a rule.  A dispatch mode below DTensor (``Counter``) sees each local
   op of this process, rank 0: its FLOPs by ``torch.utils.flop_counter``'s
   formulas (the scan's custom ops by their own, ``kernels/ssm_scan.py``),
   the bytes it reads and writes (``bytes_unfused``: every op's inputs
   read and outputs written once, an upper bound, as nothing fuses), and
   each collective with its group, its bytes by the reference's ring
   model; ``CommDebugMode`` counts the collectives by kind beside it;
4. write one JSON record: argument bytes per device (exact, from the local
   shapes), the roofline on the card's rates (``launch/card.py``: dense
   bf16, HBM, NVLink), ``dominant``, ``useful_flop_ratio`` and
   ``roofline_frac`` as the reference gives them.

What the reference computes that has no meaning here (ROADMAP §3): XLA's
HLO and its parse, ``compile_s``, ``hlo_bytes``, ``flops_rolled_raw``, the
L=1 / L=2 extrapolation (the layers are a Python loop that the trace sees
at full depth) and ``memory_analysis``' temp bytes.  The step is traced at
``analysis_microbatches`` (default 1), as the reference analyses it; the
record carries the microbatches of the step itself beside it.  Nothing
here touches a card: ``--card`` names the card whose rates the roofline
takes (default ``torch.cuda.get_device_name()``; with no card one must be
named).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k --mesh single --card "NVIDIA H100 80GB HBM3"
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --card "NVIDIA H100 80GB HBM3"
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeCfg, all_archs,
                                      applicability, get_config)
from repro_torch.launch import card as card_rates
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, flags, transformer
from repro_torch.models.registry import batch_pspec, build_model, input_specs
from repro_torch.models.transformer import ShardCtx
from repro_torch.parallel import sharding

WORLD = 512     # the fake group's ranks: (2, 16, 16); one pod takes 256


# --------------------------------------------------------------------------- #
# the reference's cell arithmetic
# --------------------------------------------------------------------------- #
def default_microbatches(cfg: ArchConfig, shape: ShapeCfg) -> int:
    if shape.kind != "train":
        return 1
    per_dp = max(1, shape.global_batch // 16)
    if cfg.d_model >= 8192:
        want = 16
    elif cfg.d_model >= 4096:
        want = 8
    else:
        want = 4
    n = min(want, per_dp)
    while shape.global_batch % n:
        n -= 1
    return max(1, n)


def apply_variant_flags(variant: Dict[str, Any]) -> None:
    """Push a variant's settings into the trace-time flags."""
    flags.decode_gqa = variant.get("decode_gqa", "repeat")
    flags.moe_impl = variant.get("moe_impl", "gather")
    flags.remat_policy = variant.get("remat_policy", "nothing")
    flags.kv_block = int(variant.get("kv_block", 1024))
    flags.serving_layout = variant.get("serving_layout", "batch")
    flags.xent_impl = variant.get("xent_impl", "onehot")


def model_flops(cfg: ArchConfig, shape: ShapeCfg) -> float:
    n_total, n_active = cfg.param_count()
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    if cfg.enc_dec and shape.kind == "train":
        toks = shape.global_batch * (shape.seq_len
                                     + encdec.dec_len_for(shape.seq_len))
    if cfg.enc_dec and shape.kind == "prefill":
        # encoder stack + per-layer cross-attention K/V projections only
        D, H, dh, F = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        n_active = (cfg.n_enc_layers * (4 * D * H * dh + 3 * D * F)
                    + cfg.n_layers * 2 * D * H * dh)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * toks


# --------------------------------------------------------------------------- #
# counting the local ops
# --------------------------------------------------------------------------- #
# ring-model bytes moved a device, by kind, from the result's bytes and the
# group's size g (the reference's dryrun.py:127-136)
RING = {"all-gather": lambda b, g: b * (g - 1) / g,
        "all-reduce": lambda b, g: 2.0 * b * (g - 1) / g,
        "reduce-scatter": lambda b, g: b * (g - 1),
        "all-to-all": lambda b, g: b * (g - 1) / g}
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
_SKIP = {"wait_tensor", "empty", "empty_strided", "new_empty",
         "new_empty_strided", "empty_like"}


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Counter(TorchDispatchMode):
    """Counts the local ops run under it: an op on DTensors is left to
    DTensor (``NotImplemented``), whose local ops come back here.  Each op
    adds its FLOPs (``torch.utils.flop_counter``'s formula for it, where it
    has one, after decomposing an op that has none, as ``FlopCounterMode``
    does), the bytes of its tensor inputs and outputs (not for views,
    waits and allocations) and, for a collective, its kind, group size and
    ring-model bytes."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_unfused = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.counting = True

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside are not counted."""
        was, self.counting = self.counting, False
        try:
            yield
        finally:
            self.counting = was

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if not self.counting:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry and func.namespace == "aten":
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = packet.__name__
        if packet in self.registry:
            n = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            key = f"{func.namespace}.{name}"
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            self._collective(COLLECTIVES[name], args, out)
        if not (func.is_view or name in _SKIP or func.namespace == "prim"):
            self.bytes_unfused += _nbytes(_tensors((args, kwargs))) + \
                _nbytes(_tensors(out))
        return out

    def _collective(self, kind: str, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1]).size()
        rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        rec["count"] += 1
        if group > 1:
            rec["bytes"] += RING[kind](_nbytes(_tensors(out)), group)


def _strided_shard(placement, size: int, chunks: int, rank: int, mode):
    """``_StridedShard.local_shard_size_and_offset`` by integer arithmetic:
    ``size`` split by ``torch.chunk`` into ``split_factor`` pieces, each
    piece into ``chunks``, rank ``rank`` taking its chunk of every piece.
    Returns (its size, its first offset or -1 / all its offsets / None,
    by ``mode``), as the original does from an index tensor."""
    from torch.distributed.tensor.placement_types import \
        _StridedShardOffsetMode as Mode
    mode = Mode(mode)
    sf = placement._split_factor_int()
    first = -(-size // sf)
    n, offsets = 0, []
    for j in range(sf):
        lo, hi = min(j * first, size), min((j + 1) * first, size)
        step = -(-(hi - lo) // chunks)
        a, b = min(rank * step, hi - lo), min((rank + 1) * step, hi - lo)
        if b > a:
            n += b - a
            if mode is Mode.ALL:
                offsets.extend(range(lo + a, lo + b))
            elif not offsets:
                offsets.append(lo + a)
    if mode is Mode.NONE:
        return n, None
    if mode is Mode.FIRST:
        return n, offsets[0] if offsets else -1
    return n, offsets


@contextlib.contextmanager
def dtensor_on_fake_tensors(counter: "Counter"):
    """Two of DTensor's own computations replaced for the trace, restored
    on exit:

    * DTensor folds two sharded dimensions into one as a ``_StridedShard``
      (a batch over `data` and heads over `model` in one ``bmm``
      dimension, a weight over `data` and `model` flattened) and plans a
      redistribution of one with ``_StridedShard.local_shard_size_and_offset``,
      which splits an index tensor as long as the dimension and reads it
      back (``.tolist()``): under ``FakeTensorMode`` that tensor is fake
      and the read raises (``aten._local_scalar_dense``), and at a
      production dimension (a million rows) it is slow.  ``_strided_shard``
      computes the same sizes and offsets from the shapes alone;
    * DTensor runs each new (op, global shapes) once on fake tensors of the
      global shapes, for the output's shape and strides
      (``ShardingPropagator._propagate_tensor_meta_non_cached``): no rank
      runs that op, so ``counter`` pauses for it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import (
        _StridedShard, _StridedShardOffsetMode)
    offsets = _StridedShard.__dict__["local_shard_size_and_offset"]
    meta = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]

    def arithmetic(self, size, chunks, rank,
                   offset_mode=_StridedShardOffsetMode.FIRST):
        if not all(isinstance(v, int) for v in (size, chunks, rank)):
            return offsets(self, size, chunks, rank, offset_mode)
        return _strided_shard(self, size, chunks, rank, offset_mode)

    def uncounted_meta(*args, **kwargs):
        with counter.paused():
            return meta(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = arithmetic
    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted_meta
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = offsets
        ShardingPropagator._propagate_tensor_meta_non_cached = meta


# --------------------------------------------------------------------------- #
# fake state
# --------------------------------------------------------------------------- #
def _register_fake_backend() -> None:
    """c10d's 'fake' backend, a process group that runs no collective
    (``FakeProcessGroup``), registered as torch's own test helpers
    register it; registering it again changes nothing."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common, opts):
        return FakeProcessGroup._create_internal(common.group_rank,
                                                 common.group_size, opts)

    dist.Backend.register_backend("fake", create, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(n: int = WORLD):
    """A default fake process group of ``n`` ranks on an in-process store,
    this process rank 0, destroyed on exit."""
    import torch.distributed as dist
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, mesh, placements):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, placements)[0])


class FakeState:
    """Fake DTensors on one mesh, made in one ``FakeTensorMode``, with the
    bytes of every local shard made (the arguments a device holds)."""

    def __init__(self, mesh, mode):
        self.mesh, self.mode, self.arg_bytes = mesh, mode, 0

    def leaf(self, shape, dtype, spec):
        from torch.distributed.tensor import DTensor
        pl = sharding.placements(self.mesh, shape, spec)
        local = _local_shape(shape, self.mesh, pl)
        with self.mode:
            t = torch.empty(local, dtype=dtype)
        self.arg_bytes += t.numel() * t.element_size()
        return DTensor.from_local(
            t, self.mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    def tree(self, meta_tree, spec_tree, dtype=None):
        """Fake DTensors of a tree of ``meta`` tensors (or shapes, with
        ``dtype``) and its specs."""
        if isinstance(spec_tree, sharding.PartitionSpec):
            shape = tuple(meta_tree.shape) if isinstance(
                meta_tree, torch.Tensor) else tuple(meta_tree)
            return self.leaf(shape, dtype or meta_tree.dtype, spec_tree)
        return {k: self.tree(meta_tree[k], spec_tree[k], dtype)
                for k in spec_tree}

    def plain(self, meta: torch.Tensor) -> torch.Tensor:
        """A fake tensor of ``meta``'s shape, whole on this rank."""
        with self.mode:
            return torch.empty(tuple(meta.shape), dtype=meta.dtype)


def _leaf_shapes(cfg: ArchConfig):
    fam = encdec if cfg.enc_dec else transformer
    return transformer.nest_tree(fam.leaf_shapes(cfg))


# --------------------------------------------------------------------------- #
# a cell
# --------------------------------------------------------------------------- #
def build_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
               variant: Dict[str, Any], fake: FakeState):
    """(step: a function of no argument, the record's extra fields) for one
    cell; its arguments are ``fake``'s, placed on ``mesh``."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step, state_specs
    apply_variant_flags(variant)
    if variant.get("pad_heads"):
        # pad the q-head count to a TP-divisible value so attention shards
        # on heads instead of falling back to 'seqq' (the reference's knob)
        cfg = dataclasses.replace(cfg, n_heads=int(variant["pad_heads"]),
                                  d_head=cfg.head_dim)
    model = build_model(cfg)
    ctx = ShardCtx(mesh)
    axes = sharding.mesh_axes(mesh)
    fsdp_over_pod = bool(variant.get("fsdp_over_pod",
                                     "pod" in axes and cfg.d_model >= 16384))
    p_layout = ("serve2d" if (shape.kind == "decode"
                              and variant.get("serving_layout") == "tp2d")
                else "train")
    pspecs = model.param_specs(mesh, fsdp_over_pod=fsdp_over_pod,
                               layout=p_layout)
    dt = transformer.dtype_of(cfg)
    inputs = input_specs(cfg, shape)
    bspecs = batch_pspec(cfg, shape, mesh)
    extra: Dict[str, Any] = {"fsdp_over_pod": fsdp_over_pod}

    if shape.kind == "train":
        ocfg = AdamWConfig(moment_dtype=variant.get(
            "moment_dtype", "bfloat16" if cfg.d_model >= 16384 else "float32"))
        n_mb = int(variant.get("analysis_microbatches", 1))
        extra.update(microbatches=int(variant.get(
            "microbatches", default_microbatches(cfg, shape))),
            analysis_microbatches=n_mb)
        sspecs = state_specs(model, mesh, fsdp_over_pod=fsdp_over_pod)
        params = fake.tree(_leaf_shapes(cfg), pspecs, dt)
        mdt = getattr(torch, ocfg.moment_dtype)
        state = {"params": params,
                 "opt": {k: fake.tree(_leaf_shapes(cfg), sspecs["opt"][k],
                                      mdt) for k in ("mu", "nu")},
                 "step": fake.leaf((), torch.int32, sspecs["step"])}
        # the batch's rows are counted as its spec places them; the step
        # takes it whole and places each microbatch itself
        fake.tree(inputs, bspecs)
        batch = {k: fake.plain(v) for k, v in inputs.items()}
        step = make_train_step(model, ocfg, mesh, num_microbatches=n_mb,
                               scan_impl=variant.get("scan_impl", "seq"),
                               grad_compression=variant.get(
                                   "grad_compression"))
        return (lambda: step(state, batch)), extra

    params = fake.tree(_leaf_shapes(cfg), pspecs, dt)
    if shape.kind == "prefill":
        batch = fake.tree(inputs, bspecs)
        return (lambda: model.prefill(params, batch, ctx)), extra

    if shape.kind == "decode":
        cache = fake.tree(inputs["cache"], bspecs["cache"])
        token = fake.tree(inputs["token"], bspecs["token"])
        pos = shape.seq_len - 1
        extra["pos"] = pos
        return (lambda: model.decode_step(params, cache, token, pos, ctx)), \
            extra
    raise ValueError(shape.kind)


def rates_of(card: str) -> Dict[str, float]:
    return {"peak_flops": card_rates.rate(card_rates.BF16_RATE, card),
            "hbm_Bps": card_rates.rate(card_rates.BANDWIDTH, card),
            "link_Bps": card_rates.rate(card_rates.NVLINK, card)}


def run_cell(arch: str, shape: Union[str, ShapeCfg], mesh_kind: str,
             variant: Dict[str, Any], card: str, *,
             cfg: Optional[ArchConfig] = None, mesh=None) -> Dict[str, Any]:
    """One cell's record.  ``cfg`` (default ``get_config(arch)``) and
    ``mesh`` (default the production mesh of ``mesh_kind`` over the default
    process group, a fake one of 256 or 512 ranks) let tests run a reduced
    cell on a small mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "kind": shape.kind, "variant": dict(variant), "ok": False,
        "card": card,
    }
    runnable, reason = applicability(cfg, shape)
    if not runnable:
        rec.update(skipped=True, reason=reason, ok=True)
        return rec
    rates = rates_of(card)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type="cpu")
    chips = mesh.size()
    saved = {k: getattr(flags, k) for k in ("decode_gqa", "moe_impl",
                                            "remat_policy", "kv_block",
                                            "serving_layout", "xent_impl")}
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = FakeState(mesh, mode)
    try:
        t0 = time.perf_counter()
        step, extra = build_step(cfg, shape, mesh, variant, fake)
        rec["variant"].update(extra)
        counter = Counter()
        with dtensor_on_fake_tensors(counter), mode, \
                CommDebugMode() as comm, counter:
            step()
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
    finally:
        for k, v in saved.items():
            setattr(flags, k, v)
    flops = float(counter.flops)
    coll = {k: dict(v) for k, v in sorted(counter.collectives.items())}
    coll_bytes = sum(v["bytes"] for v in coll.values())
    rec.update(
        mesh_shape=sharding.mesh_axes(mesh), chips=chips, rates=rates,
        flops_per_device=flops, flops_by_op=counter.flops_by_op,
        bytes_unfused=float(counter.bytes_unfused),
        arg_bytes_per_device=fake.arg_bytes,
        collectives=coll, collective_count=sum(v["count"]
                                               for v in coll.values()),
        comm_counts={str(k): v for k, v in comm.get_comm_counts().items()})
    terms = {"compute_s": flops / rates["peak_flops"],
             "memory_s": counter.bytes_unfused / rates["hbm_Bps"],
             "collective_s": coll_bytes / rates["link_Bps"]}
    rec["terms"] = terms
    rec["dominant"] = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    rec["model_flops_total"] = mf
    rec["model_flops_per_chip"] = mf / chips
    rec["useful_flop_ratio"] = (mf / chips) / flops if flops else 0.0
    bound_s = max(terms.values())
    rec["roofline_frac"] = (((mf / chips) / rates["peak_flops"]) / bound_s
                            if bound_s else 0.0)
    rec["ok"] = True
    return rec


def default_card(card: Optional[str]) -> str:
    """``card``, else the card's name; raises where there is none."""
    if card:
        return card
    if not torch.cuda.is_available():
        raise SystemExit("dryrun: no card here: name the card whose rates "
                         "the roofline takes, e.g. --card \"NVIDIA H100 80GB "
                         "HBM3\"")
    return torch.cuda.get_device_name()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--set", action="append", default=[],
                    help="variant overrides, e.g. --set microbatches=4")
    ap.add_argument("--card", default=None,
                    help="the card whose rates the roofline takes "
                    "(default: this machine's)")
    args = ap.parse_args(argv)
    card = default_card(args.card)
    rates_of(card)          # an unknown card fails before any cell

    variant: Dict[str, Any] = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            variant[k] = json.loads(v)
        except json.JSONDecodeError:
            variant[k] = v

    archs = sorted(all_archs()) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    t_run = time.perf_counter()
    with fake_world(WORLD):
        for arch in archs:
            for shape in shapes:
                for mesh_kind in meshes:
                    tag = f"{arch}__{shape}__{mesh_kind}__{args.variant}"
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip existing] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        rec = run_cell(arch, shape, mesh_kind, dict(variant),
                                       card)
                    except Exception:
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_kind, "variant": variant,
                               "ok": False, "card": card,
                               "error": traceback.format_exc()}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    _report(rec)
    print(f"[dryrun] {time.perf_counter() - t_run:.1f} s", flush=True)


def _report(rec: Dict[str, Any]) -> None:
    if not rec.get("ok"):
        print("  -> FAIL\n" + rec["error"].splitlines()[-1], flush=True)
    elif rec.get("skipped"):
        print(f"  -> SKIP ({rec['reason']})", flush=True)
    else:
        t = rec["terms"]
        print(f"  -> ok trace={rec['trace_s']}s "
              f"compute={t['compute_s'] * 1e3:.2f}ms "
              f"mem={t['memory_s'] * 1e3:.2f}ms "
              f"coll={t['collective_s'] * 1e3:.2f}ms "
              f"dominant={rec['dominant']} "
              f"roofline={rec['roofline_frac']:.3f}", flush=True)


if __name__ == "__main__":
    main()
