"""The port's range-sharded engine against the JAX package's, on the CPU.

The reference runs on its 'numpy' filter and compaction backends, the
port on 'fused' and 'jax_packed' (the plain versions of
``fused_zone_filter``, ``pack_codes``, ``unpack_codes``,
``remap_pack_codes``, ``fused_zone_agg`` and ``zone_histogram`` on the
CPU), both pinned here; their trees are the same SCT for SCT.

* the router: boundaries, ``shard_of``, ``shard_of_batch``,
  ``shards_for_range``, splits, ``from_uppers`` and the errors, equal to
  the reference router's on the same tables and keys;
* ``ShardedLSM(n_shards=1)`` is bit for bit the port's own ``LSMTree``
  (every SCT, the counters, every read with its scan counters) for the
  four codecs under the three compaction backends;
* 2 and 4 shards with hot-shard splits, the four codecs, ``n_workers=1``:
  after every batch the boundaries, ``n_splits``, every shard tree (levels,
  file ids, SCTs, counters), the ``shape_report`` counters and
  ``io_report`` equal the reference's, and ``filter``, ``filter_many``,
  ``aggregate_many`` (bucket edges resolved over all shards),
  ``range_lookup`` and ``get`` answer alike now and at every snapshot
  pinned on the way, across the splits;
* ``merge_scts(key_range=...)``: both halves of a tree's runs equal to the
  reference's, the blob garbage marked alike;
* threaded scatter and ingest, ``compact_all``, the gather's dtype on
  empty shards, sharded aggregates, per-shard policies, the background
  scheduler shared by every shard (equal to sync), a ``ScanServer`` over
  the sharded engine, a split half's snapshot, and the default device.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.compaction as rcomp
import repro.shard as RS
import repro_torch.core as T
import repro_torch.core.compaction as tcomp
import repro_torch.shard as TS
from repro.query import AggSpec as RAggSpec
from repro.query import GroupBy as RGroupBy
from repro.serving.scan_server import ScanServer as RServer
from repro.storage.devices import DEVICES as RDEVICES
from repro_torch.core.policy import CompactionPolicy
from repro_torch.core.sct import sct_to_arrays
from repro_torch.query import AggSpec as TAggSpec
from repro_torch.query import GroupBy as TGroupBy
from repro_torch.serving import ScanServer as TServer
from repro_torch.storage.devices import DEVICES as TDEVICES
from repro_torch.testing.workload import apply_op, gen_ops
from test_torch_engine import assert_same_sct, assert_same_tree

VW = 24
KEY_SPACE = 6000
CODECS = ["opd", "plain", "heavy", "blob"]
PREDS = [
    ("prefix", b"pfx_00", b""),
    ("prefix", b"pfx_1", b""),
    ("range", b"pfx_010", b"pfx_080"),
    ("eq", b"pfx_042_c", b""),
    ("ge", b"pfx_120", b""),
    ("le", b"", b"pfx_015"),
]
SPECS = [("count", None, None), ("sum", None, None), ("min", None, None),
         ("max", ("prefix", b"pfx_0", b""), None),
         ("group_count", None, ("prefix", 6)),
         ("group_count", None, ("bucket", 5))]
SHAPE_FREE = SPECS[:-1]
WINDOWS = [(0, KEY_SPACE), (100, 700), (KEY_SPACE // 8 - 5, KEY_SPACE // 8 + 5),
           (2990, 3010), (5, 4)]
REB = dict(split_threshold_bytes=24_000, skew_factor=1.3, max_shards=8)
REF_BE = dict(filter_backend="numpy", compaction_backend="numpy")
PORT_BE = dict(filter_backend="fused", compaction_backend="jax_packed")
SHAPE_KEYS = ("n_shards", "n_splits", "boundaries", "n_files", "disk_bytes",
              "dict_bytes", "policies", "n_policy_switches", "n_retunes",
              "n_flushes", "n_compactions", "write_stalls",
              "cascade_truncations", "dict_compares", "compaction_in_bytes",
              "compaction_out_bytes", "ingest_bytes")


def _kw(codec, **extra):
    return dict(dict(codec=codec, value_width=VW, file_bytes=16 * 1024,
                     l0_limit=2, size_ratio=3, max_levels=5), **extra)


def _ref_cfg(codec, **extra):
    return R.LSMConfig(**_kw(codec, **dict(REF_BE, **extra)))


def _port_cfg(codec, **extra):
    return T.LSMConfig(**_kw(codec, **dict(PORT_BE, **extra)))


def _engines(codec, n_shards, rebalance=True, **extra):
    """The reference and port sharded engines, one worker each (file ids
    then follow one order)."""
    reb = dict(REB) if rebalance else None
    ref = RS.ShardedLSM(
        _ref_cfg(codec, **extra), n_shards=n_shards, key_max=KEY_SPACE,
        n_workers=1, rebalance=reb and RS.RebalanceConfig(**reb))
    port = TS.ShardedLSM(
        _port_cfg(codec, **extra), n_shards=n_shards, key_max=KEY_SPACE,
        n_workers=1, rebalance=reb and TS.RebalanceConfig(**reb),
        device="cpu")
    return ref, port


def _workload(seed, n=2500):
    """The reference's sharded workload: batched puts and deletes, skewed
    toward low keys so that rebalancing engines split."""
    rng = np.random.default_rng(seed)
    ops = []
    m = n // 5
    for _ in range(5):
        space = KEY_SPACE // 8 if rng.random() < 0.6 else KEY_SPACE
        keys = rng.integers(0, space, m, dtype=np.uint64)
        ids = rng.integers(0, 150, m)
        vals = np.asarray(
            [b"pfx_%03d_%c" % (int(x), 97 + int(x) % 7) for x in ids],
            dtype=f"S{VW}")
        ops.append(("batch", keys, vals))
        ops.append(("del", rng.integers(0, space, m // 6, dtype=np.uint64)))
    return ops


def _apply_one(eng, op):
    if op[0] == "batch":
        eng.put_batch(op[1], op[2])
    else:
        for k in op[1].tolist():
            eng.delete(int(k))


def _apply(eng, ops):
    for op in ops:
        _apply_one(eng, op)


def _specs(engine, specs=SPECS):
    A, G = (RAggSpec, RGroupBy) if engine is R else (TAggSpec, TGroupBy)
    out = []
    for op, pred, group in specs:
        g = None if group is None else (
            G("prefix", prefix_len=group[1]) if group[0] == "prefix"
            else G("bucket", n_buckets=group[1]))
        out.append(A(op, pred=None if pred is None else engine.Predicate(*pred),
                     group=g, top_k=4 if group and group[0] == "prefix"
                     else None))
    return out


def _answers(eng, engine, snap=None, counters=False, specs=SPECS):
    """Everything a reader observes, as plain Python values; with
    ``counters`` the filters' scan counters too.  Bucket edges come from
    the snapshot's observed domain (every run's dictionary), so trees of
    different shapes compare without the bucket spec."""
    preds = [engine.Predicate(*p) for p in PREDS]

    def res(r):
        got = (r.keys.tolist(), r.values.tolist(), str(r.values.dtype))
        return got + ((r.n_scanned, r.n_matched_raw) if counters else ())

    singles = [res(eng.filter(p, snapshot=snap)) for p in preds]
    many = [res(r) for r in eng.filter_many(preds, snapshot=snap)]
    aggs = [(r.op, r.count, r.total, r.min_value, r.max_value, r.groups)
            for r in eng.aggregate_many(_specs(engine, specs), snapshot=snap)]
    ranges = []
    for lo, hi in WINDOWS:
        k, v = eng.range_lookup(lo, hi, snapshot=snap)
        ranges.append((k.tolist(), v.tolist(), str(v.dtype)))
    rng = np.random.default_rng(99)
    gets = [eng.get(k, snapshot=snap)
            for k in rng.integers(0, KEY_SPACE, 80).tolist()]
    return singles, many, aggs, ranges, gets


def assert_same_engine(ref, port):
    """Boundaries, every shard tree, the report counters, the I/O."""
    assert ref.router.uppers == port.router.uppers
    assert ref.n_splits == port.n_splits
    assert len(ref.shards) == len(port.shards)
    for a, b in zip(ref.shards, port.shards):
        assert_same_tree(a, b)
        assert a._seqno == b._seqno
    sa, sb = ref.shape_report(), port.shape_report()
    for k in SHAPE_KEYS:
        assert sa[k] == sb[k], k
    for name in RDEVICES:
        assert ref.io_report(RDEVICES[name]) == \
            port.io_report(TDEVICES[name]), name


# --------------------------------------------------------------------------- #
# the router
# --------------------------------------------------------------------------- #
ROUTERS = [(1, 100, []), (3, 100, []), (4, 1000, [(0, 100), (3, 700)]),
           (7, RS.KEY_MAX, [(6, RS.KEY_MAX - 5), (2, RS.KEY_MAX // 3)]),
           (2, 50_000, [(0, 9_000), (0, 300), (3, 40_000)])]


@pytest.mark.parametrize("n,key_max,splits", ROUTERS)
def test_router_matches_reference(n, key_max, splits):
    ra, rb = RS.ShardRouter(n, key_max), TS.ShardRouter(n, key_max)
    rng = np.random.default_rng(n)
    top = min(key_max, 2 ** 63)
    for i, pivot in [(None, None)] + splits:
        if i is not None:
            ra.split(i, pivot)
            rb.split(i, pivot)
        assert (ra.uppers, ra.n_shards, ra.key_max) == \
            (rb.uppers, rb.n_shards, rb.key_max)
        assert [ra.bounds(j) for j in range(ra.n_shards)] == \
            [rb.bounds(j) for j in range(rb.n_shards)]
        keys = np.concatenate([
            rng.integers(0, top, 300, dtype=np.uint64),
            np.asarray([0, key_max - 1] + [u - d for u in ra.uppers
                                            for d in (0, 1) if 0 <= u - d
                                            < key_max], np.uint64)])
        a, b = ra.shard_of_batch(keys), rb.shard_of_batch(keys)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert [ra.shard_of(k) for k in keys.tolist()] == \
            [rb.shard_of(k) for k in keys.tolist()] == b.tolist()
        for lo, hi in [(0, key_max - 1), (5, 3)] + [
                tuple(sorted(rng.integers(0, top, 2).tolist()))
                for _ in range(20)]:
            assert list(ra.shards_for_range(lo, hi)) == \
                list(rb.shards_for_range(lo, hi))
    back = TS.ShardRouter.from_uppers(rb.uppers, key_max)
    assert back.uppers == RS.ShardRouter.from_uppers(ra.uppers,
                                                     key_max).uppers
    assert repr(back) == repr(ra)


@pytest.mark.parametrize("call,exc", [
    (lambda S: S.ShardRouter(0), ValueError),
    (lambda S: S.ShardRouter(11, key_max=10), ValueError),
    (lambda S: S.ShardRouter(2, 100).shard_of(100), KeyError),
    (lambda S: S.ShardRouter(2, 100).shard_of(-1), KeyError),
    (lambda S: S.ShardRouter(2, 1000).split(0, 500), ValueError),
    (lambda S: S.ShardRouter(2, 1000).split(0, 0), ValueError),
    (lambda S: S.ShardRouter.from_uppers([5, 9], 10), ValueError),
    (lambda S: S.ShardRouter.from_uppers([], 10), ValueError),
])
def test_router_errors_match_reference(call, exc):
    msgs = []
    for S in (RS, TS):
        with pytest.raises(exc) as e:
            call(S)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# one shard == the port's own tree, bit for bit
# --------------------------------------------------------------------------- #
def assert_same_port_tree(a, b):
    """Two port trees: the same runs, word for word, and counters."""
    assert [[s.file_id for s in lvl] for lvl in a.levels] == \
        [[s.file_id for s in lvl] for lvl in b.levels]
    for x, y in zip(a.all_runs(), b.all_runs()):
        fx, fy = sct_to_arrays(x), sct_to_arrays(y)
        assert fx.keys() == fy.keys()
        for k in fx:
            if isinstance(fx[k], np.ndarray):
                assert fx[k].dtype == fy[k].dtype, k
                assert np.array_equal(fx[k], fy[k]), k
            else:
                assert fx[k] == fy[k], k
    for c in ("n_flushes", "n_compactions", "dict_compares", "write_stalls",
              "compaction_in_bytes", "compaction_out_bytes", "ingest_bytes",
              "disk_bytes", "n_files", "dict_bytes"):
        assert getattr(a, c) == getattr(b, c), c


@pytest.mark.parametrize("backend", ["jax_packed", "jax", "numpy"])
@pytest.mark.parametrize("codec", CODECS)
def test_single_shard_is_the_port_tree(codec, backend):
    cfg = _port_cfg(codec, compaction_backend=backend)
    ops = _workload(0, n=1500)
    plain = T.LSMTree(cfg, device="cpu")
    with TS.ShardedLSM(cfg, n_shards=1, key_max=KEY_SPACE,
                       device="cpu") as sharded:
        for op in ops:
            _apply_one(plain, op)
            _apply_one(sharded, op)
            assert_same_port_tree(plain, sharded.shards[0])
        assert _answers(plain, T, counters=True) == \
            _answers(sharded, T, counters=True)
        snap_a, snap_b = plain.snapshot(), sharded.snapshot()
        plain.compact()
        sharded.compact_all()
        assert_same_port_tree(plain, sharded.shards[0])
        assert _answers(plain, T, counters=True) == \
            _answers(sharded, T, counters=True)
        assert _answers(plain, T, snap_a, counters=True) == \
            _answers(sharded, T, snap_b, counters=True)
        rep = sharded.shape_report()
        assert (rep["n_flushes"], rep["n_compactions"],
                rep["dict_compares"]) == (plain.n_flushes,
                                          plain.n_compactions,
                                          plain.dict_compares)
        for dev in TDEVICES.values():
            assert sharded.io_report(dev) == plain.io_report(dev)


# --------------------------------------------------------------------------- #
# 2 and 4 shards with splits, against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("codec", CODECS)
def test_sharded_engine_matches_reference(codec, n_shards):
    ref, port = _engines(codec, n_shards)
    snaps = []
    for op in _workload(2):
        _apply_one(ref, op)
        _apply_one(port, op)
        assert_same_engine(ref, port)
        snaps.append((ref.snapshot(), port.snapshot(), port.n_splits))
    assert port.n_splits > 0, "the workload should split a shard"
    assert any(n < port.n_splits for _, _, n in snaps), \
        "a snapshot should be pinned before a split"
    assert _answers(ref, R) == _answers(port, T)
    for sa, sb, _ in snaps:
        assert _answers(ref, R, sa) == _answers(port, T, sb)
    ref.compact_all()
    port.compact_all()
    assert_same_engine(ref, port)
    assert _answers(ref, R) == _answers(port, T)
    ref.close()
    port.close()


def test_stage_stats_fold_retired_shards():
    ref, port = _engines("opd", 2)
    _apply(ref, _workload(2))
    _apply(port, _workload(2))
    assert port.n_splits > 0
    # the merges (one a split half too) counted alike; the engine's row of
    # each stage is its shards' rows plus the retired shards'
    assert ref.compaction_stats.counts["merge"] == \
        port.compaction_stats.counts["merge"]
    for name in ("compaction_stats", "flush_stats", "filter_stats",
                 "lookup_stats", "agg_stats"):
        parts = [getattr(t, name) for t in port.shards] + \
            [port._engine_stages[name]]
        got = getattr(port, name)
        for stage in set(got.counts) | {k for p in parts for k in p.counts}:
            assert got.counts[stage] == sum(p.counts[stage] for p in parts)
            assert got.seconds[stage] == pytest.approx(
                sum(p.seconds[stage] for p in parts))
    assert port._engine_stages["compaction_stats"].counts["merge"] > 0
    ref.close()
    port.close()


def test_bucket_planning_is_timed_in_the_engine_row():
    """The bucket edges are resolved once over every shard, and that stage
    lands in the engine's own agg_stats row, beside the shards' plans."""
    _, port = _engines("opd", 2, rebalance=False)
    _apply(port, _workload(3))
    own = port._engine_stages["agg_stats"]

    def shards_plan():
        return sum(t.agg_stats.counts["plan"] for t in port.shards)
    for calls in (1, 2):
        port.aggregate_many(_specs(T, SPECS[-1:]))
        assert own.counts["plan"] == calls
        assert port.agg_stats.counts["plan"] == calls + shards_plan()
    port.aggregate_many(_specs(T, SHAPE_FREE[:1]))   # nothing to resolve
    assert own.counts["plan"] == 2
    assert port.agg_stats.counts["plan"] == 2 + shards_plan()
    assert own.seconds["plan"] > 0
    port.close()


# --------------------------------------------------------------------------- #
# merge_scts(key_range=...)
# --------------------------------------------------------------------------- #
def _unmerged_trees(codec):
    """A reference and a port tree with several overlapping runs (L0 and
    L1), deletes and overwrites, nothing compacted away at the end."""
    kw = _kw(codec, memtable_bytes=4 * 1024, l0_limit=6, blob_gc_threshold=0.9)
    ref = R.LSMTree(R.LSMConfig(**kw, **REF_BE))
    port = T.LSMTree(T.LSMConfig(**kw, **PORT_BE), device="cpu")
    for op in gen_ops(3, 1400, 700, p_compact=0.0):
        apply_op(ref, op)
        apply_op(port, op)
    ref.flush()
    port.flush()
    assert_same_tree(ref, port)
    assert len(port.all_runs()) > 2
    return ref, port


@pytest.mark.parametrize("codec", CODECS)
def test_merge_key_range_matches_reference(codec):
    ref, port = _unmerged_trees(codec)
    runs_a, runs_b = ref.all_runs(), port.all_runs()
    pivot = int(np.median(np.concatenate([s.keys for s in runs_b])))
    n_total = sum(s.n for s in runs_b)
    halves = [(0, pivot), (pivot, 2 ** 64)]
    n_in = 0
    for key_range in halves:
        ra = rcomp.merge_scts(
            runs_a, out_level=2, is_bottom=True,
            file_entries=ref.file_entries, store=ref.store,
            stats=ref.compaction_stats, blob_mgr=ref.blob_mgr,
            backend="numpy", key_range=key_range)
        rb = tcomp.merge_scts(
            runs_b, out_level=2, is_bottom=True,
            file_entries=port.file_entries, store=port.store,
            stats=port.compaction_stats, device=port.device,
            blob_mgr=port.blob_mgr, backend="jax_packed",
            key_range=key_range)
        assert (ra.n_in, ra.n_out, ra.n_dropped, ra.dict_compares) == \
            (rb.n_in, rb.n_out, rb.n_dropped, rb.dict_compares)
        assert len(ra.outputs) == len(rb.outputs) > 0
        for a, b in zip(ra.outputs, rb.outputs):
            assert_same_sct(a, b)
            lo, hi = key_range
            assert lo <= int(b.keys[0]) and int(b.keys[-1]) < hi
        n_in += rb.n_in
        if codec == "blob":
            assert ref.blob_mgr.live == port.blob_mgr.live
            assert ref.blob_mgr.total == port.blob_mgr.total
    assert n_in == n_total   # every entry counted by exactly one half
    if codec == "blob":
        # the two halves together mark what one unrestricted merge marks
        r2, p2 = _unmerged_trees(codec)
        tcomp.merge_scts(
            p2.all_runs(), out_level=2, is_bottom=True,
            file_entries=p2.file_entries, store=p2.store,
            stats=p2.compaction_stats, device=p2.device,
            blob_mgr=p2.blob_mgr, backend="jax_packed")
        assert p2.blob_mgr.live == port.blob_mgr.live


def test_split_half_dictionaries_hold_their_own_values():
    ref, port = _unmerged_trees("opd")
    runs = port.all_runs()
    pivot = int(np.median(np.concatenate([s.keys for s in runs])))
    res = tcomp.merge_scts(
        runs, out_level=2, is_bottom=True, file_entries=10 ** 6,
        store=port.store, stats=port.compaction_stats, device=port.device,
        blob_mgr=None, backend="jax_packed", key_range=(0, pivot))
    (out,) = res.outputs
    live = ~out.tombs
    used = np.unique(out.host_codes()[live])
    assert np.array_equal(used, np.arange(out.opd.size))


# --------------------------------------------------------------------------- #
# scatter-gather paths
# --------------------------------------------------------------------------- #
def test_threaded_scatter_and_ingest_match_reference():
    """The pool's scatter (SCAN_PARALLEL_MIN 0) and threaded ingest: the
    answers do not depend on scheduling."""
    ops = _workload(4)
    ref = R.LSMTree(_ref_cfg("opd"))
    _apply(ref, ops)
    with TS.ShardedLSM(_port_cfg("opd"), n_shards=4, key_max=KEY_SPACE,
                       n_workers=4, device="cpu") as port:
        # (the port's threshold is a class constant and its ingest rule
        # follows the codec)
        port.SCAN_PARALLEL_MIN = 0
        port.parallel_ingest = True
        _apply(port, ops)
        a, b = _answers(ref, R), _answers(port, T)
        assert a == b
        port.compact_all()
        for t in port.shards:
            assert t.memtable.n_versions == 0
        assert _answers(port, T) == b


def test_gather_dtype_on_empty_shards():
    with TS.ShardedLSM(_port_cfg("opd"), n_shards=4, key_max=2000,
                       device="cpu") as eng:
        for k in range(0, 500):   # only the lowest shard holds data
            eng.put(k, b"pfx_%03d" % (k % 50))
        eng.flush()
        for pred in (T.Predicate("prefix", b"zzz"),
                     T.Predicate("prefix", b"pfx_01")):
            r = eng.filter(pred)
            assert r.values.dtype == np.dtype(f"S{VW}")
        k, v = eng.range_lookup(1500, 1999)
        assert (k.shape, v.dtype) == ((0,), np.dtype(f"S{VW}"))
        k, v = eng.range_lookup(400, 1600)   # spans every shard
        assert k.tolist() == list(range(400, 500))


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_aggregates_equal_one_tree(n_shards):
    """test_aggregate.py's sharded cases: the memtable path before, the
    fast path after ``compact_all``; the GROUP BY buckets resolved over
    every shard's domain."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, KEY_SPACE, 3000, dtype=np.uint64)
    vals = np.asarray([b"%07d_%02d" % (int(x), int(x) % 17)
                       for x in rng.integers(0, 10 ** 6, 3000)], f"S{VW}")
    # files large enough that compact_all leaves every shard one sorted
    # run at L1: disjoint runs, the kernels' fast path
    kw = dict(file_bytes=64 * 1024)
    ref = R.LSMTree(_ref_cfg("opd", **kw))
    with TS.ShardedLSM(_port_cfg("opd", **kw), n_shards=n_shards,
                       key_max=KEY_SPACE, device="cpu") as port:
        for eng in (ref, port):
            eng.put_batch(keys, vals)
            eng.put_batch(keys[:100], vals[100:200])
            for k in keys[200:260].tolist():
                eng.delete(int(k))
        assert _answers(ref, R, specs=SHAPE_FREE)[2] == \
            _answers(port, T, specs=SHAPE_FREE)[2]
        ref.compact()
        before = port.agg_stats.counts.get("agg_fastpath_runs", 0)
        port.compact_all()
        specs = SPECS if n_shards == 1 else SHAPE_FREE
        assert _answers(ref, R, specs=specs)[2] == \
            _answers(port, T, specs=specs)[2]
        assert port.agg_stats.counts["agg_fastpath_runs"] > before


def test_per_shard_policies_read_as_one_leveled_tree():
    """test_policy.py's sharded case: tiered and lazy-leveled shards beside
    leveled ones answer as the reference's leveled tree."""
    ops = gen_ops(11, 1200, KEY_SPACE)
    kw = dict(memtable_bytes=8 * 1024, blob_gc_threshold=0.3)
    ref = R.LSMTree(_ref_cfg("opd", **kw))
    for op in ops:
        apply_op(ref, op)
    ref.flush()
    with TS.ShardedLSM(_port_cfg("opd", **kw), n_shards=4, key_max=KEY_SPACE,
                       n_workers=2, device="cpu") as eng:
        eng.set_policy(1, CompactionPolicy(kind="tiered", tier_runs=3))
        eng.set_policy(2, CompactionPolicy(kind="lazy_leveled", tier_runs=3))
        for op in ops:
            apply_op(eng, op)
        eng.flush()
        eng.compact_all()
        assert eng.policies() == [
            "leveled", "tiered,K=3", "lazy_leveled,K=3", "leveled"]
        assert eng.shape_report()["n_policy_switches"] == 2
        assert _answers(ref, R, specs=SHAPE_FREE) == \
            _answers(eng, T, specs=SHAPE_FREE)


def _bg_ops(rng, n, key_space=3000):
    keys = rng.integers(0, key_space, n, dtype=np.uint64)
    vals = np.asarray([b"pfx_%03d_%05d" % (int(x) % 150, int(x))
                       for x in rng.integers(0, 10 ** 5, n)], f"S{VW}")
    return keys, vals


@pytest.mark.parametrize("codec", ["opd", "blob"])
def test_background_shards_equal_sync(codec):
    """test_maintenance.py's sharded cases: ONE scheduler on the engine's
    pool drives every shard; after each drain the answers equal a sync
    engine's and the reference's sync engine."""
    kw = dict(memtable_bytes=8 * 1024, blob_gc_threshold=0.3)
    ref = RS.ShardedLSM(_ref_cfg(codec, **kw), n_shards=4, key_max=KEY_SPACE,
                        n_workers=1)
    sync = TS.ShardedLSM(_port_cfg(codec, **kw), n_shards=4,
                         key_max=KEY_SPACE, n_workers=1, device="cpu")
    bg = TS.ShardedLSM(_port_cfg(codec, maintenance="background", **kw),
                       n_shards=4, key_max=KEY_SPACE, n_workers=2,
                       device="cpu")
    try:
        assert bg.scheduler is not None and sync.scheduler is None
        assert bg.scheduler.executor is bg.executor
        assert all(t._sched is bg.scheduler for t in bg.shards)
        rng = np.random.default_rng(21)
        for _ in range(3):
            keys, vals = _bg_ops(rng, 1500, KEY_SPACE)
            for eng in (ref, sync, bg):
                eng.put_batch(keys, vals)
                for k in keys[:40].tolist():
                    eng.delete(int(k))
            bg.drain(timeout=60)
            assert all(t._pending_flushes() == 0 for t in bg.shards)
            assert all(t._compaction_debt() == 0.0 for t in bg.shards)
            want = _answers(ref, R)
            assert _answers(sync, T) == want
            # the background shards' shapes differ from sync ones'
            assert _answers(bg, T, specs=SHAPE_FREE) == \
                _answers(ref, R, specs=SHAPE_FREE)
        assert bg.scheduler.n_bg_flushes > 0
        for eng in (ref, sync, bg):
            eng.compact_all()
        assert _answers(bg, T, specs=SHAPE_FREE) == \
            _answers(ref, R, specs=SHAPE_FREE)
    finally:
        for eng in (ref, sync, bg):
            eng.close()


def test_background_split_unregisters_the_retired_shard():
    kw = dict(memtable_bytes=8 * 1024)
    reb = TS.RebalanceConfig(split_threshold_bytes=24_000, skew_factor=1.3,
                             max_shards=6)
    ref = R.LSMTree(_ref_cfg("opd", **kw))
    with TS.ShardedLSM(_port_cfg("opd", maintenance="background", **kw),
                       n_shards=2, key_max=KEY_SPACE, n_workers=2,
                       rebalance=reb, device="cpu") as eng:
        for op in _workload(2):
            _apply_one(ref, op)
            _apply_one(eng, op)
        eng.drain(timeout=60)
        assert eng.n_splits > 0
        with eng.scheduler._lock:
            registered = list(eng.scheduler._trees)
        assert len(registered) == eng.n_shards
        assert all(any(t is s for s in eng.shards) for t in registered)
        assert _answers(ref, R, specs=SHAPE_FREE) == \
            _answers(eng, T, specs=SHAPE_FREE)


def test_split_half_snapshot_sees_its_rows():
    """A split half starts with the old tree's applied seqno: a snapshot
    taken right after the split reads every kept row."""
    reb = TS.RebalanceConfig(split_threshold_bytes=1, skew_factor=1.0,
                             max_shards=2)
    with TS.ShardedLSM(_port_cfg("opd"), n_shards=1, key_max=KEY_SPACE,
                       rebalance=reb, device="cpu") as eng:
        keys = np.arange(0, 2000, 3, dtype=np.uint64)
        eng.put_batch(keys, np.asarray([b"pfx_%03d" % (k % 97)
                                        for k in keys.tolist()], f"S{VW}"))
        assert eng.n_splits == 1
        for t in eng.shards:
            assert t._applied == t._seqno == keys.shape[0]
        snap = eng.snapshot()
        k, _ = eng.range_lookup(0, KEY_SPACE, snapshot=snap)
        assert k.tolist() == keys.tolist()
        assert eng.filter(T.Predicate("prefix", b"pfx_0"),
                          snapshot=snap).keys.shape[0] > 0


def test_scan_server_over_sharded_engine():
    ops = _workload(6, n=1500)
    ref = RS.ShardedLSM(_ref_cfg("opd", filter_backend="jax_packed"),
                        n_shards=3, key_max=KEY_SPACE, n_workers=1)
    port = TS.ShardedLSM(_port_cfg("opd", filter_backend="jax_packed"),
                         n_shards=3, key_max=KEY_SPACE, n_workers=1,
                         device="cpu")
    _apply(ref, ops)
    _apply(port, ops)
    outs = []
    for srv, engine in ((RServer(ref, max_batch=4), R),
                        (TServer(port, max_batch=4), T)):
        rids = srv.submit_many([engine.Predicate(*p) for p in PREDS])
        aids = srv.submit_aggs(_specs(engine)[:2])
        out = srv.drain()
        assert srv.stats.n_batches == 2   # 8 requests, 4 a batch
        outs.append([(out[r].keys.tolist(), out[r].values.tolist())
                     for r in rids] + [out[a].value for a in aids])
    assert outs[0] == outs[1]
    sync = TServer(port, max_batch=4, maintenance="sync")
    got = sync.run([T.Predicate(*p) for p in PREDS])
    assert [(got[q].keys.tolist(), got[q].values.tolist())
            for q in sorted(got)] == outs[1][:len(PREDS)]
    ref.close()
    port.close()


def test_sharded_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ShardedLSM(T.LSMConfig(), n_shards=2)
    eng = TS.ShardedLSM(T.LSMConfig(), n_shards=2, device="cpu")
    assert {t.device.type for t in eng.shards} == {"cpu"}
    eng.close()


def test_stage_stats_merge():
    a, b = T.StageStats(), T.StageStats()
    a.seconds["x"], a.counts["x"] = 1.5, 2
    b.seconds["x"], b.counts["x"] = 0.5, 1
    b.seconds["y"], b.counts["y"] = 2.0, 4
    m = a.merged(b)
    assert (dict(m.seconds), dict(m.counts)) == ({"x": 2.0, "y": 2.0},
                                                 {"x": 3, "y": 4})
    assert dict(T.StageStats.merge_all([]).seconds) == {}
    assert dict(a.seconds) == {"x": 1.5}   # the inputs are untouched
