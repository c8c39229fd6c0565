"""The port's 'numpy' filter backend and the paper's Figure-5 pipeline
against the JAX package, on the CPU.

Engine: the same puts, deletes, flushes and compactions go into the
reference tree (``LSMConfig(codec='opd', filter_backend='numpy',
compaction_backend='jax_packed')``) and the port's tree under 'numpy';
``filter_many`` of 16 predicates (tombstoned keys, memtable rows, an older
pinned snapshot), ``aggregate_many`` on the general and the fast path
(with equal ``agg_*`` counters) and a ``ScanServer`` must agree, exactly.
Under 'numpy' ``filter_many`` consults no kernel wrapper at all: the codes
are unpacked and compared on the host.

Figure 5 (``examples/filter_analytics.py``): per SCT, a string predicate
planned to a code range, evaluated three ways (numpy on the unpacked
codes, ``range_filter_codes`` on the code column, ``range_filter_packed``
on the packed words), all equal to each other and to the reference's
masks and bitmaps, and the matches decoded to the reference's values.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.kernels import ops as jops
from repro.serving.scan_server import ScanServer as RServer
from repro_torch import ScanServer as TServer
from repro_torch.kernels import _build, ops
from test_torch_filter_backends import (KW, PREDS, _trees, _writes,
                                        assert_same_filters)
from test_torch_kernels import _u32
from test_torch_query import SPECS, _vocab, assert_same_aggs
from test_torch_serving import QUEUE, _same_result, _stats, _submit


@pytest.fixture
def no_kernel_wrappers(monkeypatch):
    """Every kernel wrapper asks ``on_card`` first: make that call fail."""
    def refuse(*_t):
        raise AssertionError("a kernel wrapper was called")
    return lambda: monkeypatch.setattr(_build, "on_card", refuse)


def test_filter_many_matches_reference(no_kernel_wrappers):
    """Overlapping levels, tombstones, memtable rows, and a snapshot pinned
    before further writes, flushes and compactions."""
    ref, port = _trees("numpy")
    _writes(ref, port, seed=11)
    assert port.n_compactions > 0 and port.memtable.n_versions > 0
    assert any(s.tombs.any() for s in port.all_runs())
    snaps = (ref.snapshot(), port.snapshot())
    before = assert_same_filters(ref, port)
    assert sum(r.keys.shape[0] for r in before) > 0
    _writes(ref, port, seed=12)
    assert len({s.code_bits for s in port.all_runs()}) > 1
    assert_same_filters(ref, port)
    no_kernel_wrappers()
    after = assert_same_filters(ref, port, snaps)
    for a, b in zip(before, after):
        assert np.array_equal(a.keys, b.keys)
    assert "fused_launches" not in port.filter_stats.counts


@pytest.mark.parametrize("path", ["general", "fast"])
def test_aggregates_match_reference(path):
    """The general path (overlapping runs, memtable rows) and the fast path
    (a compacted tree of sequential keys, evaluated on the host as under
    'jax'): results and ``agg_*`` counters equal to the reference's."""
    if path == "general":
        ref, port = _trees("numpy")
        _writes(ref, port, seed=13, n=2000)
    else:
        ref, port = _trees("numpy", file_bytes=128 * 1024)
        n = 12000
        vals = _vocab(2000)[np.random.default_rng(14).integers(0, 2000, n)]
        for t in (ref, port):
            t.put_batch(np.arange(n, dtype=np.uint64), vals)
            t.compact()
    assert_same_aggs(ref, port, SPECS)
    c = port.agg_stats.counts
    if path == "general":
        assert c["agg_fallback_runs"] > 0 and c["agg_fastpath_runs"] == 0
    else:
        assert c["agg_fastpath_runs"] > 0 and c["agg_fallback_runs"] == 0
        assert c["agg_launches"] == 0


@pytest.mark.parametrize("max_batch", [1, 4, 16])
def test_scan_server_matches_reference(max_batch):
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend="numpy",
                                compaction_backend="jax_packed", **KW))
    port = T.LSMTree(T.LSMConfig(filter_backend="numpy", **KW), device="cpu")
    _writes(ref, port, seed=15, n=2000)
    rsrv, tsrv = RServer(ref, max_batch=max_batch), TServer(
        port, max_batch=max_batch)
    rids = _submit(rsrv, R, QUEUE)
    assert _submit(tsrv, T, QUEUE) == rids
    ra, tb = rsrv.drain(), tsrv.drain()
    assert set(ra) == set(tb) == set(rids)
    for rid, (kind, item) in zip(rids, QUEUE):
        assert _same_result(ra[rid], tb[rid]), (kind, item)
    assert _stats(rsrv) == _stats(tsrv)


def test_numpy_matches_fused_on_one_tree():
    """Switching a loaded tree's filter backend to 'numpy' gives the
    'fused' answers, on the current state and on a pinned snapshot."""
    port = T.LSMTree(T.LSMConfig(**KW), device="cpu")
    rng = np.random.default_rng(16)
    snap = None
    for i in range(3):
        port.put_batch(rng.integers(0, 2500, 500).astype(np.uint64),
                       _vocab(2000)[rng.integers(0, 2000, 500)])
        for k in rng.integers(0, 2500, 50).tolist():
            port.delete(k)
        if i == 1:
            snap = port.snapshot()
    preds = [T.Predicate(*p) for p in PREDS]
    for sn in (None, snap):
        port.cfg = dataclasses.replace(port.cfg, filter_backend="fused")
        fused = port.filter_many(preds, snapshot=sn)
        port.cfg = dataclasses.replace(port.cfg, filter_backend="numpy")
        host = port.filter_many(preds, snapshot=sn)
        for p, a, b in zip(PREDS, fused, host):
            assert np.array_equal(a.keys, b.keys) and \
                np.array_equal(a.values, b.values), p


# --------------------------------------------------------------------------- #
# the paper's Figure-5 pipeline, per SCT
# --------------------------------------------------------------------------- #
FIG5_VW = 128


def _fig5_trees(n=20000):
    """The example's configuration, cut to n puts: 128-byte values from the
    1,000-value 'commodity/%03d/' + 80 x 'd' vocabulary, seed 0."""
    kw = dict(value_width=FIG5_VW, file_bytes=256 * 1024)
    ref = R.LSMTree(R.LSMConfig(codec="opd", filter_backend="numpy",
                                compaction_backend="jax_packed", **kw))
    port = T.LSMTree(T.LSMConfig(filter_backend="numpy", **kw), device="cpu")
    rng = np.random.default_rng(0)
    vocab = np.asarray([b"commodity/%03d/" % i + b"d" * 80
                        for i in range(1000)], f"S{FIG5_VW}")
    keys = rng.integers(0, 10**9, n, dtype=np.uint64)
    vals = vocab[rng.integers(0, 1000, n)]
    for t in (ref, port):
        t.put_batch(keys, vals)
    return ref, port


@pytest.mark.parametrize("pred", [("prefix", b"commodity/00", b""),
                                  ("range", b"commodity/100", b"commodity/250"),
                                  ("eq", b"commodity/007/" + b"d" * 80, b""),
                                  ("prefix", b"zzz", b"")])
def test_figure5_pipeline_per_sct(pred):
    ref, port = _fig5_trees()
    runs_r, runs_t = ref.all_runs(), port.all_runs()
    assert len(runs_t) == len(runs_r) > 1
    total = 0
    for sr, st in zip(runs_r, runs_t):
        lo, hi = st.opd.code_range(T.Predicate(*pred))
        r_lo, r_hi = sr.opd.code_range(R.Predicate(*pred))
        # an empty plan is the canonical (0, 0) in the port
        assert (lo, hi) == ((r_lo, r_hi) if r_lo < r_hi else (0, 0))
        width = st.code_bits
        codes = st.host_codes()
        assert np.array_equal(codes, sr.evs)
        m_np = (codes >= lo) & (codes < hi)
        # inclusive bounds; an empty plan as the engine encodes it
        k_lo, k_hi = (lo, hi - 1) if lo < hi else (1, 0)
        m_codes = ops.range_filter_codes(st.code_column(), k_lo, k_hi).numpy()
        bitmap = ops.range_filter_packed(st.packed, width, k_lo, k_hi)
        m_packed = ops.bitmap_to_mask(bitmap, width, st.n).numpy()
        assert np.array_equal(m_np, m_codes) and \
            np.array_equal(m_np, m_packed)
        # the reference's masks: tombstones (-1) never match; the packed
        # words would hold them as code 0 (none here)
        assert np.array_equal(m_np, (sr.evs >= lo) & (sr.evs < hi))
        assert np.array_equal(_u32(bitmap), jops.range_filter_packed(
            sr.packed, sr.code_bits, k_lo, k_hi))
        idx = np.nonzero(m_np)[0]
        assert np.array_equal(st.opd.decode(codes[idx]),
                              sr.opd.decode(sr.evs[idx]))
        total += int(idx.shape[0])
    want = ref.filter(R.Predicate(*pred))
    got = port.filter(T.Predicate(*pred))
    assert np.array_equal(got.keys, want.keys) and \
        np.array_equal(got.values, want.values)
    if pred[1] != b"zzz":
        assert total > 0


def test_figure5_filter_many_and_server_match_reference():
    """The example's second half: K=16 prefix predicates through ``filter``,
    ``filter_many`` and a ``ScanServer(max_batch=8)``."""
    ref, port = _fig5_trees()
    preds = [("prefix", b"commodity/%03d" % i, b"") for i in range(16)]
    snaps = (ref.snapshot(), port.snapshot())
    ra = ref.filter_many([R.Predicate(*p) for p in preds], snapshot=snaps[0])
    rb = port.filter_many([T.Predicate(*p) for p in preds], snapshot=snaps[1])
    seq = [port.filter(T.Predicate(*p), snapshot=snaps[1]) for p in preds]
    for a, b, c in zip(ra, rb, seq):
        assert np.array_equal(a.keys, b.keys) and \
            np.array_equal(a.values, b.values)
        assert np.array_equal(b.keys, c.keys) and \
            np.array_equal(b.values, c.values)
    srv = TServer(port, max_batch=8)
    rids = srv.submit_many([T.Predicate(*p) for p in preds])
    out = srv.drain()
    assert srv.stats.batch_sizes == [8, 8]
    for rid, a in zip(rids, ra):
        assert np.array_equal(out[rid].keys, a.keys)
