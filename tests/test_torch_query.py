"""The port's analytics tier against the JAX engine's, on the CPU.

The same seeded stream goes into the reference tree (``codec='opd'``,
``filter_backend='fused'``, Pallas in interpret mode) and the port's tree
on ``device='cpu'`` (the kernels' plain versions); ``aggregate_many``
must return identical counts, sums, decoded min/max and group lists (top-k
included), and identical ``agg_*`` counters (plus the general path's fused
filter telemetry).  Cases: the fast path (sequential keys, compacted) at
pack widths 2 to 16, uniform and key-clustered values; the general path
(overlapping levels, visible memtable rows, deletes); a snapshot taken
before further writes; bucket resolution; the int32 routing guard and
tombstones on the fast path (the host evaluation); ``from_arrays`` of a
tree taken from the JAX engine.
"""

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.query import AggSpec as RSpec, GroupBy as RGroup
from repro.query.planner import collect_domain as r_collect_domain
from repro_torch.query import AggSpec as TSpec, GroupBy as TGroup
from repro_torch.query.planner import collect_domain as t_collect_domain
from test_torch_engine import export_sct

VW = 16
KW = dict(value_width=VW, file_bytes=64 * 1024, l0_limit=2, size_ratio=3)
EDGES = (b"c008", b"c015", b"c022_00100")

# (op, predicate, group, top_k); predicates and groups as plain tuples.
# Each launch costs the reference a Pallas trace in interpret mode, so the
# tables stay short: one scalar launch and two histograms per level.
SPECS = [
    ("count", None, None, None),
    ("count", ("prefix", b"c01"), None, None),
    ("sum", None, None, None),
    ("sum", ("range", b"c005", b"c020"), None, None),
    ("min", None, None, None),
    ("max", ("ge", b"c030"), None, None),
    ("group_count", ("prefix", b"c0"), ("prefix", 4, 8, None), 5),
    ("group_count", None, ("bucket", 8, 16, None), None),
]
# narrow ranges only, plus one wide range: tiles that meet no range skip,
# tiles only the wide range meets take the closed form
CLUSTERED_SPECS = [
    ("count", ("prefix", b"c010"), None, None),
    ("sum", ("range", b"c005", b"c007"), None, None),
    ("min", ("prefix", b"c02"), None, None),
    ("max", ("eq", b"c033_01799"), None, None),
    ("count", ("range", b"c001", b"c030"), None, None),
    ("count", ("prefix", b"zzz"), None, None),
    ("group_count", None, ("bucket", 8, 16, None), None),
]
COUNTERS = ("fused_launches", "zone_tiles_total", "zone_tiles_skipped",
            "zone_blocks_total", "zone_blocks_skipped", "zone_blocks_prunable")


def _specs(engine, table=SPECS):
    Spec, Group = (RSpec, RGroup) if engine is R else (TSpec, TGroup)
    return [Spec(op, engine.Predicate(*p) if p else None,
                 Group(*g) if g else None, k) for op, p, g, k in table]


def _trees(**kw):
    cfg = dict(KW, **kw)
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend="fused",
                                compaction_backend="jax_packed", **cfg))
    port = T.LSMTree(T.LSMConfig(**cfg), device="cpu")
    return ref, port


def _vocab(ndv):
    """ndv distinct values 'c%03d_%05d': the category i % 37 (the first
    digit run, so the SUM weight) then the id i."""
    return np.asarray([b"c%03d_%05d" % (i % 37, i) for i in range(ndv)],
                      f"S{VW}")


def _counters(tree):
    c = tree.agg_stats.counts
    return {k: v for k, v in c.items()
            if k.startswith("agg_") or k in COUNTERS}


def assert_same_aggs(ref, port, table=SPECS, snaps=(None, None)):
    got_r = ref.aggregate_many(_specs(R, table), snapshot=snaps[0])
    got_p = port.aggregate_many(_specs(T, table), snapshot=snaps[1])
    for spec, a, b in zip(table, got_r, got_p):
        assert (a.op, a.count, a.total, a.min_value, a.max_value, a.groups) \
            == (b.op, b.count, b.total, b.min_value, b.max_value, b.groups), \
            spec
        assert a.value == b.value
    assert _counters(ref) == _counters(port)
    return got_p


# --------------------------------------------------------------------------- #
# fast path: compacted tree, sequential keys
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ndv,layout", [(3, "uniform"), (200, "uniform"),
                                        (2000, "uniform"),
                                        (2000, "clustered")])
def test_fast_path_matches_reference(ndv, layout):
    """Sequential keys, compacted: every run takes the kernels.  Clustered
    values (category follows the key) let tiles skip and short-circuit."""
    rng = np.random.default_rng(ndv)
    n = 12000
    keys = np.arange(n, dtype=np.uint64)
    vocab = np.sort(_vocab(ndv))
    if layout == "clustered":
        vals = vocab[np.arange(n) * ndv // n]
    else:
        vals = vocab[rng.integers(0, ndv, n)]
    # larger files: the compacted tree is one level of a few SCTs, so each
    # spec table costs the reference few interpret-mode traces
    ref, port = _trees(file_bytes=128 * 1024)
    for t in (ref, port):
        t.put_batch(keys, vals)
        t.compact()
    assert_same_aggs(ref, port,
                     CLUSTERED_SPECS if layout == "clustered" else SPECS)
    c = port.agg_stats.counts
    assert c["agg_fastpath_runs"] > 1 and c["agg_fallback_runs"] == 0
    assert c["agg_launches"] > 0 and c["agg_tiles_evaluated"] > 0
    if layout == "clustered":
        assert c["agg_tiles_skipped"] > 0 and c["agg_tiles_shortcircuit"] > 0


# --------------------------------------------------------------------------- #
# general path: overlapping runs, memtable rows, deletes, snapshots
# --------------------------------------------------------------------------- #
def _mixed_stream(ref, port, seed, n=6000, key_max=4000):
    """Random keys with overwrites, a delete in ten ops, in batches."""
    rng = np.random.default_rng(seed)
    for _ in range(n // 500):
        keys = rng.integers(0, key_max, 500).astype(np.uint64)
        vals = _vocab(2000)[rng.integers(0, 2000, 500)]
        for t in (ref, port):
            t.put_batch(keys, vals)
        for k in rng.integers(0, key_max, 50).tolist():
            ref.delete(k)
            port.delete(k)


def test_general_path_matches_reference():
    ref, port = _trees()
    _mixed_stream(ref, port, seed=1)
    assert port.memtable.n_versions > 0 and port.n_compactions > 0
    assert_same_aggs(ref, port)
    c = port.agg_stats.counts
    assert c["agg_fallback_runs"] > 0 and c["agg_fastpath_runs"] == 0
    assert c["fused_launches"] > 0


def test_snapshot_before_further_writes():
    """A snapshot pinned before more writes, flushes and compactions still
    aggregates to its own answer, on both engines."""
    ref, port = _trees()
    _mixed_stream(ref, port, seed=2, n=3000)
    snaps = (ref.snapshot(), port.snapshot())
    # explicit bucket edges: resolving them reads the snapshot's memtable,
    # which later writes still reach (the reference's domain contract)
    table = SPECS[:-1] + [("group_count", None, ("bucket", 8, 4, EDGES),
                           None)]
    before = assert_same_aggs(ref, port, table, snaps=snaps)
    _mixed_stream(ref, port, seed=3, n=3000)
    for t in (ref, port):
        t.compact()
    assert assert_same_aggs(ref, port, table, snaps=snaps) == before
    assert_same_aggs(ref, port)


def test_bucket_resolution_matches_reference():
    """Equi-depth edges resolved over the same observed domain (runs and
    memtable rows), and the labels they give."""
    ref, port = _trees()
    _mixed_stream(ref, port, seed=4, n=3000)
    sr, sp = ref.snapshot(), port.snapshot()
    dr = r_collect_domain(sr.runs, sr.mems, None, VW)
    dp = t_collect_domain(sp.runs, sp.mems, VW)
    assert np.array_equal(dr, dp)
    table = [("group_count", None, ("bucket", 8, b, None), None)
             for b in (1, 2, 5, 64)]
    table.append(("group_count", ("le", b"", b"c030"),
                  ("bucket", 8, 4, EDGES), 3))
    res = assert_same_aggs(ref, port, table)
    assert [len(r.groups) for r in res][:3] == [1, 2, 5]
    assert len(res[-1].groups) == 3


# --------------------------------------------------------------------------- #
# the host evaluation on the fast path
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", ["int32_guard", "tombstones"])
def test_fast_path_host_evaluation_matches_reference(case):
    """Large numeric weights (max weight x tile entries >= 2**31) route the
    SUM launch's runs to the host; so do tombstones under a range that
    admits code 0 (one flushed run, deletes of keys never written)."""
    rng = np.random.default_rng(7)
    n = 8000
    keys = np.arange(n, dtype=np.uint64)
    vals = _vocab(300)[rng.integers(0, 300, n)]
    ref, port = _trees(file_bytes=128 * 1024)
    if case == "int32_guard":
        big = np.asarray([b"%010d" % v for v in
                          rng.integers(1_000_000, 2_100_000_000, 40)], "S16")
        vals = np.concatenate([vals[:-40], big])
        for t in (ref, port):
            t.put_batch(keys, vals)
            t.compact()
    else:
        for t in (ref, port):
            t.put_batch(keys[:1500], vals[:1500])
            for k in range(n, n + 60):
                t.delete(k)
            t.flush()
        assert len(port.levels[0]) == 1 and port.levels[0][0].tombs.any()
    res = assert_same_aggs(ref, port)
    c = port.agg_stats.counts
    assert c["agg_fastpath_runs"] > 0
    # the host evaluation counts (block x spec) units: more than kernel tiles
    assert c["agg_tiles_total"] > c["agg_launches"]
    if case == "int32_guard":
        assert res[2].total > 2**31   # the whole-column SUM


# --------------------------------------------------------------------------- #
# state carried over from the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compacted", [True, False])
def test_from_arrays_aggregates_like_the_reference(compacted):
    """A tree built from the JAX engine's SCT arrays (zones, weight sums,
    dictionaries) answers ``aggregate_many`` as the JAX tree does, on the
    fast path (compacted, sequential keys) and the general path."""
    rng = np.random.default_rng(11)
    kw = dict(KW, file_bytes=128 * 1024) if compacted else KW
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend="fused",
                                compaction_backend="jax_packed", **kw))
    if compacted:
        n = 12000
        ref.put_batch(np.arange(n, dtype=np.uint64),
                      _vocab(2000)[rng.integers(0, 2000, n)])
        ref.compact()
    else:
        _, throwaway = _trees()
        _mixed_stream(ref, throwaway, seed=12, n=3000)
        ref.flush()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    port = T.LSMTree.from_arrays(T.LSMConfig(**kw), levels, ref._seqno,
                                 device="cpu")
    assert_same_aggs(ref, port)
    c = port.agg_stats.counts
    assert (c["agg_fastpath_runs"] > 0) == compacted
