"""The port's competitor codecs ('plain', 'heavy', 'blob' and 'blob' with
``blob_compress``, named 'blob_zstd' after the harness's system) against
the JAX package's, on the CPU, bit for bit.

* ``build_sct`` per codec: columns, raw values, each zlib block's bytes or
  the log pointers and logs, block entries, disk bytes and the block
  index's keys and blooms; and the three decoding methods (``raw_values``,
  ``decode_slice``, ``value_at``) against the reference's
  ``raw_values_for_merge`` (``_read_blob_values`` for 'blob'),
  ``_decode_slice`` and ``_decode_one``, with the I/O they charge.
* ``merge_scts`` over the reference harness's inputs
  (``tests/test_compaction_backends.py``'s ``_build_inputs``) carried in
  with ``sct_from_arrays`` (and the logs they point into), under each
  compaction backend, at the bottom level and above it; for 'blob' the
  garbage the merge marks.
* Trees: the same put/overwrite/delete stream into the reference tree and
  the port's under each filter backend, compared after every flush and
  compaction (file ids, levels, disk bytes, columns, values, zlib blocks,
  pointers, logs, blob GC, I/O), then ``get``, ``range_lookup`` and
  ``filter_many`` on a snapshot taken before later writes.
* Aggregates (``aggregate_many``, ``aggregate_partials``, a
  ``ScanServer`` aggregate) under each filter backend, with memtable rows
  and on a snapshot taken before later writes: results, ``agg_*``
  counters, stage names and I/O.
* ``LSMTree.from_arrays`` over reference trees of each codec; SCTs of a
  codec other than the configuration's are refused, and a merge takes one
  codec.
* No competitor path reaches a kernel wrapper.

The stream, the comparisons and the SCT export are ``test_torch_engine``'s,
whose helpers take every codec.
"""

import functools
import gc

import numpy as np
import pytest

import repro.core as R
import repro.core.sct as rsct
import repro_torch.core as T
import repro_torch.core.sct as tsct
import test_compaction_backends
from repro.core.compaction import merge_scts as ref_merge_scts
from repro.core.filter_exec import _read_blob_values
from repro.core.iterator import _decode_slice as ref_decode_slice
from repro.query import AggSpec as RSpec, GroupBy as RGroup
from repro.serving.scan_server import ScanServer as RServer
from repro.storage.io import FileStore as RStore
from repro_torch import ScanServer
from repro_torch.core.compaction import merge_scts
from repro_torch.kernels import _build
from repro_torch.query import AggSpec as TSpec, GroupBy as TGroup
from repro_torch.storage.io import FileStore
from test_compaction_backends import _build_inputs
from test_torch_engine import (KW, PREDS, VW, _apply, _stream, _trees,
                               assert_same_reads, assert_same_sct,
                               assert_same_tree, export_blobs, export_sct)

# the harness's four competitor systems, by their configuration
CODEC_KW = {"plain": dict(codec="plain"), "heavy": dict(codec="heavy"),
            "blob": dict(codec="blob"),
            "blob_zstd": dict(codec="blob", blob_compress=True)}
CODECS = list(CODEC_KW)
FILTER_BACKENDS = ["numpy", "jax", "jax_packed", "fused"]
COMPACTION_BACKENDS = ["numpy", "jax", "jax_packed"]
STAGES = {"read", "decode", "merge", "encode", "write"}
KEY_MAX = 3000   # keys for the tree streams: deep enough to reach L2


def io(store):
    st = store.stats
    return (st.bytes_read, st.bytes_written, st.read_ios, st.write_ios)


# --------------------------------------------------------------------------- #
# (a) build_sct and the decoding methods
# --------------------------------------------------------------------------- #
def _columns(n, ndv, rng):
    keys = np.sort(rng.choice(4 * n + 8, n, replace=False)).astype(np.uint64)
    seqnos = rng.permutation(np.arange(1, n + 1, dtype=np.uint64))
    tombs = rng.random(n) < 0.1
    vocab = np.asarray([b"v%03d_" % i + bytes(rng.integers(97, 123, 9)
                                              .astype(np.uint8))
                        for i in range(ndv)], f"S{VW}")
    vals = vocab[rng.integers(0, ndv, n)]
    vals[tombs] = b""
    return keys, seqnos, tombs, vals


def _slices(n, epb):
    """[a, b) slices inside one block, across block edges, and whole."""
    out = [(0, n), (0, 1), (n - 1, n)]
    if n > epb + 3:
        out += [(epb - 2, epb + 3), (3, epb - 1), (epb, 2 * epb)]
    return [(a, min(b, n)) for a, b in out if a < min(b, n)]


def _blob_mgrs(codec_kw, rstore, tstore):
    """The reference's and the port's value logs for a 'blob' codec, else
    (None, None)."""
    if codec_kw["codec"] != "blob":
        return None, None
    z = codec_kw.get("blob_compress", False)
    return rsct.BlobManager(rstore, VW, z), tsct.BlobManager(tstore, VW, z)


@pytest.mark.parametrize("n", [0, 1, 300, 2000])
@pytest.mark.parametrize("codec", CODECS)
def test_build_sct_and_decoding_match(codec, n):
    ckw = CODEC_KW[codec]
    rng = np.random.default_rng(n + len(codec))
    keys, seqnos, tombs, vals = _columns(n, 37, rng)
    kw = dict(keys=keys, seqnos=seqnos, tombs=tombs, level=0, key_bytes=16,
              value_width=VW, block_bytes=512, bloom_bits_per_key=10,
              raw_values=vals, codec=ckw["codec"])
    rstore, tstore = RStore(), FileStore()
    rmgr, tmgr = _blob_mgrs(ckw, rstore, tstore)
    a = rsct.build_sct(store=rstore, blob_mgr=rmgr, **kw)
    b = tsct.build_sct(store=tstore, device="cpu", blob_mgr=tmgr, **kw)
    assert_same_sct(a, b)
    assert io(rstore) == io(tstore)
    if rmgr is not None:
        assert (rmgr.live, rmgr.total) == (tmgr.live, tmgr.total)
        for fid in rmgr.live:
            assert rstore.size_of(fid) == tstore.size_of(fid)
            assert np.array_equal(tmgr.log_values(fid),
                                  rstore.payload(fid)[2])
    assert tsct.record_disk_bytes(ckw["codec"], 16, VW) == \
        rsct.record_disk_bytes(ckw["codec"], 16, VW)
    raw = b.raw_values()
    assert raw.dtype == np.dtype(f"S{VW}")
    assert np.array_equal(raw, a.raw_values_for_merge() if rmgr is None
                          else _read_blob_values(a, rmgr))
    assert io(rstore) == io(tstore)
    if not n:
        return
    epb = b.zblock_entries or b.blocks.entries_per_block
    for lo, hi in _slices(n, epb):
        got = b.decode_slice(lo, hi)
        want = ref_decode_slice(a, lo, hi, rstore, rmgr)
        assert np.array_equal(got, want), (lo, hi)
    ref_tree = R.LSMTree(R.LSMConfig(value_width=VW, **ckw))
    ref_tree.blob_mgr = rmgr
    for pos in sorted({0, n // 2, n - 1, min(epb, n - 1)}):
        if rmgr is not None and tombs[pos]:
            continue    # a 'blob' tombstone points into no log
        assert b.value_at(pos) == ref_tree._decode_one(a, pos), pos
    assert io(rstore) == io(tstore)


def test_blob_codec_is_accepted():
    """'blob' and ``blob_compress`` configure trees (``blob_compress`` is
    ignored by the other codecs, as in the reference); a codec neither
    package has names the ones the port takes."""
    assert tsct.record_disk_bytes("blob", 16, VW) == \
        rsct.record_disk_bytes("blob", 16, VW)
    for kw in (dict(codec="blob"), dict(codec="blob", blob_compress=True),
               dict(blob_compress=True),
               dict(codec="plain", blob_compress=True)):
        tree = T.LSMTree(T.LSMConfig(value_width=VW, **kw), device="cpu")
        assert (tree.blob_mgr is not None) == (tree.cfg.codec == "blob")
        tree.put(1, b"v")
        tree.flush()
        assert [s.codec for s in tree.all_runs()] == [tree.cfg.codec]
        assert tree.get(1) == b"v"
    with pytest.raises(ValueError, match="'blob'"):
        T.sct_from_arrays(dict(codec="lz4"), "cpu")
    with pytest.raises(ValueError, match="'blob'"):
        tsct.record_disk_bytes("lz4", 16, VW)


# --------------------------------------------------------------------------- #
# (b) merges under every compaction backend
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("is_bottom", [False, True])
@pytest.mark.parametrize("backend", COMPACTION_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_merge_matches_reference(codec, backend, is_bottom, seed,
                                 monkeypatch):
    ckw = CODEC_KW[codec]
    monkeypatch.setattr(test_compaction_backends, "BlobManager",
                        functools.partial(rsct.BlobManager, compress=ckw.get(
                            "blob_compress", False)))
    inputs, ref_store, ref_stats, ref_mgr = _build_inputs(ckw["codec"], seed)
    store = FileStore()
    mgr = None
    if ref_mgr is not None:
        # the logs the inputs point into, under the same ids
        mgr = tsct.BlobManager(store, VW, ref_mgr.compress)
        for fid in ref_mgr.live:
            mgr.write_log(ref_store.payload(fid)[2], fid=fid)
        mgr.live, mgr.total = dict(ref_mgr.live), dict(ref_mgr.total)
    port_inputs = []
    for s in inputs:
        t = T.sct_from_arrays(export_sct(s), "cpu", mgr)
        assert_same_sct(s, t)
        store.write(t, t.disk_bytes, fid=t.file_id)
        port_inputs.append(t)
    assert io(ref_store) == io(store)
    args = dict(out_level=1, is_bottom=is_bottom, file_entries=256,
                block_bytes=512, bloom_bits_per_key=8, backend=backend)
    stats = T.StageStats()
    ref = ref_merge_scts(inputs, store=ref_store, stats=ref_stats,
                         blob_mgr=ref_mgr, **args)
    port = merge_scts(port_inputs, store=store, stats=stats, device="cpu",
                      blob_mgr=mgr, **args)
    assert (ref.n_in, ref.n_out, ref.n_dropped) == \
        (port.n_in, port.n_out, port.n_dropped)
    assert ref.dict_compares == port.dict_compares == 0
    assert len(ref.outputs) == len(port.outputs) > 1
    for a, b in zip(ref.outputs, port.outputs):
        assert_same_sct(a, b)
    assert io(ref_store) == io(store)
    assert set(stats.seconds) == STAGES
    if is_bottom:
        assert not any(b.tombs.any() for b in port.outputs)
    if mgr is not None:
        # the dropped entries' garbage, log by log
        assert (mgr.live, mgr.total) == (ref_mgr.live, ref_mgr.total)
        assert mgr.live != mgr.total
        assert all(b.blob_mgr is mgr for b in port.outputs)


# --------------------------------------------------------------------------- #
# (c) trees, after every flush and compaction, under every filter backend
# --------------------------------------------------------------------------- #
def assert_same_scans(ref, port, snaps=(None, None)):
    """``range_lookup`` windows at the snapshots ``snaps``, then the I/O
    both stores were charged."""
    sa, sb = snaps
    for lo, hi in ((0, KEY_MAX), (100, 900), (1234, 1234), (2000, 1000),
                   (2990, 9999)):
        ka, va = ref.range_lookup(lo, hi, snapshot=sa)
        kb, vb = port.range_lookup(lo, hi, snapshot=sb)
        assert np.array_equal(ka, kb) and va.dtype == vb.dtype
        assert np.array_equal(va, vb), (lo, hi)
    assert io(ref.store) == io(port.store)


@pytest.mark.parametrize("filter_backend,compaction_backend",
                         zip(FILTER_BACKENDS, COMPACTION_BACKENDS + ["numpy"]))
@pytest.mark.parametrize("codec", CODECS)
def test_tree_matches_reference(codec, filter_backend, compaction_backend):
    ref, port = _trees(filter_backend=filter_backend,
                       compaction_backend=compaction_backend,
                       **CODEC_KW[codec])
    ops = list(_stream(key_max=KEY_MAX))
    done, snaps = set(), None
    for i, (op, k, v) in enumerate(ops):
        if i == 2800:
            snaps = (ref.snapshot(), port.snapshot())
            assert snaps[0].seqno == snaps[1].seqno
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
        state = (port.n_flushes, port.n_compactions)
        assert (ref.n_flushes, ref.n_compactions) == state, i
        if state not in done:
            done.add(state)
            assert_same_tree(ref, port)
            assert io(ref.store) == io(port.store), i
    assert port.n_compactions >= 3, port.shape_report()
    assert port.shape_report()["levels"][2] > 0, "need an L1 -> L2 cascade"
    assert_same_tree(ref, port)
    # the memtable holds rows too; then a snapshot older than later writes
    assert_same_reads(ref, port, range(0, KEY_MAX, 3))
    assert_same_scans(ref, port)
    assert_same_reads(ref, port, range(0, KEY_MAX, 7), snaps)
    assert_same_scans(ref, port, snaps)
    assert set(ref.filter_stats.counts) == set(port.filter_stats.counts)
    assert set(port.compaction_stats.seconds) == STAGES
    ref.compact()
    port.compact()
    assert_same_tree(ref, port)
    assert_same_reads(ref, port, range(0, KEY_MAX, 5))
    assert_same_scans(ref, port)
    if port.blob_mgr is not None:
        # the snapshot pinned the logs GC would rewrite; released, they go
        assert port.blob_mgr.gc_candidates()
        del snaps
        gc.collect()
        ref._gc_blobs()
        port._gc_blobs()
        assert port.blob_mgr.gc_runs > 0
        assert port.blob_mgr.gc_candidates() == []
        assert_same_tree(ref, port)
        assert_same_reads(ref, port, range(0, KEY_MAX, 5))
        assert_same_scans(ref, port)


# --------------------------------------------------------------------------- #
# (d) the reference's trees carried across
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("codec", CODECS)
def test_from_arrays_reads_like_the_reference(codec):
    ckw = CODEC_KW[codec]
    ref, _ = _trees(filter_backend="numpy", **ckw)
    for op, k, v in _stream(n=2500, seed=7, key_max=KEY_MAX):
        _apply(ref, op, k, v)
    ref.flush()
    assert sum(1 for lvl in ref.levels if lvl) >= 2, ref.shape_report()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    blobs = export_blobs(ref) if ref.blob_mgr is not None else {}
    port = T.LSMTree.from_arrays(T.LSMConfig(**ckw, **KW), levels,
                                 ref._seqno, device="cpu", **blobs)
    for la, lb in zip(ref.levels, port.levels):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            assert_same_sct(a, b)
    before = (io(ref.store), io(port.store))
    assert_same_reads(ref, port, range(0, KEY_MAX, 3))
    ka, va = ref.range_lookup(0, KEY_MAX)
    kb, vb = port.range_lookup(0, KEY_MAX)
    assert np.array_equal(ka, kb) and np.array_equal(va, vb)
    # the reads charged the same I/O
    assert np.subtract(io(ref.store), before[0]).tolist() == \
        np.subtract(io(port.store), before[1]).tolist()


@pytest.mark.parametrize("codec", ["plain", "heavy", "blob"])
def test_one_codec_per_tree(codec):
    """A tree holds the codec its configuration names: SCTs of another
    codec are refused on the way in, and a merge takes one codec."""
    ref, _ = _trees(codec=codec, filter_backend="numpy")
    for op, k, v in _stream(n=600, seed=4, key_max=KEY_MAX):
        _apply(ref, op, k, v)
    ref.flush()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    for other in ["opd", "plain", "heavy", "blob"]:
        if other == codec:
            continue
        with pytest.raises(ValueError, match=f"codec {codec!r}"):
            T.LSMTree.from_arrays(T.LSMConfig(codec=other, **KW), levels,
                                  ref._seqno, device="cpu")
    competitor = T.sct_from_arrays(export_sct(ref.all_runs()[0]), "cpu")
    opd = T.LSMTree(T.LSMConfig(**KW), device="cpu")
    for op, k, v in _stream(n=600, seed=4, key_max=KEY_MAX):
        _apply(opd, op, k, v)
    opd.flush()
    for inputs in ([competitor, opd.all_runs()[0]],
                   [opd.all_runs()[0], competitor]):
        with pytest.raises(AssertionError, match="one codec"):
            merge_scts(inputs, out_level=1, is_bottom=False, file_entries=256,
                       store=FileStore(), stats=T.StageStats(), device="cpu")
    with pytest.raises(ValueError, match="the competitors only"):
        opd.all_runs()[0].raw_values()


# --------------------------------------------------------------------------- #
# (e) aggregates over the competitors, against the reference's
# --------------------------------------------------------------------------- #
AGG_PRED = ("prefix", b"tag_000", b"")
AGG_EDGES = (b"tag_00050", b"tag_00100", b"tag_00150")
# (op, predicate, group (kind, prefix_len, n_buckets, edges), top_k): the
# reference's test_tree_aggregate_parity table, and one bucket group left to
# be resolved over the snapshot's domain
AGG_SPECS = [
    ("count", None, None, None), ("count", AGG_PRED, None, None),
    ("sum", None, None, None), ("sum", AGG_PRED, None, None),
    ("min", None, None, None), ("max", None, None, None),
    ("min", AGG_PRED, None, None), ("max", AGG_PRED, None, None),
    ("group_count", None, ("prefix", 7, 8, None), None),
    ("group_count", AGG_PRED, ("prefix", 8, 8, None), 3),
    ("group_count", None, ("bucket", 4, 4, AGG_EDGES), None),
    ("group_count", None, ("bucket", 4, 5, None), None),
]


def _agg_specs(engine, table=AGG_SPECS):
    Spec, Group = (RSpec, RGroup) if engine is R else (TSpec, TGroup)
    return [Spec(op, engine.Predicate(*p) if p else None,
                 Group(*g) if g else None, k) for op, p, g, k in table]


def _agg_fields(p):
    return (p.count, p.total, p.min_value, p.max_value, p.groups)


def assert_same_aggs(ref, port, snaps=(None, None)):
    """``aggregate_many`` at the snapshots ``snaps``: results, the ``agg_*``
    and filter counters, stage names and I/O."""
    ra = ref.aggregate_many(_agg_specs(R), snapshot=snaps[0])
    rb = port.aggregate_many(_agg_specs(T), snapshot=snaps[1])
    for spec, a, b in zip(AGG_SPECS, ra, rb):
        assert a.op == b.op and _agg_fields(a) == _agg_fields(b), spec
        assert a.value == b.value, spec
    assert dict(ref.agg_stats.counts) == dict(port.agg_stats.counts)
    assert set(ref.agg_stats.seconds) == set(port.agg_stats.seconds)
    assert io(ref.store) == io(port.store)
    return rb


@pytest.mark.parametrize("filter_backend", FILTER_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_aggregates_match_reference(codec, filter_backend):
    """COUNT, SUM, MIN, MAX and GROUP BY prefix and bucket over a
    competitor tree: with memtable rows, on a snapshot older than later
    writes, as mergeable partials, through a ``ScanServer`` batch, and
    after a full compaction.  Competitor runs take the general path (its
    raw-value pool), as in the reference."""
    ref, port = _trees(filter_backend=filter_backend,
                       compaction_backend="numpy", **CODEC_KW[codec])
    ops = list(_stream(n=2400, seed=12, key_max=KEY_MAX))
    for op, k, v in ops[:1600]:
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    snaps = (ref.snapshot(), port.snapshot())
    for op, k, v in ops[1600:]:
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    assert port.n_compactions > 0 and port.memtable.n_versions > 0
    got = assert_same_aggs(ref, port)
    assert got[0].value > 0 and got[4].value is not None
    assert port.agg_stats.counts["agg_fallback_runs"] > 0
    assert port.agg_stats.counts.get("agg_fastpath_runs", 0) == 0
    assert "decode" in port.agg_stats.seconds
    assert_same_aggs(ref, port, snaps)
    resolved = [i for i, (_op, _p, g, _k) in enumerate(AGG_SPECS)
                if g is None or g[0] == "prefix" or g[3]]
    table = [AGG_SPECS[i] for i in resolved]
    pa = ref.aggregate_partials(_agg_specs(R, table))
    pb = port.aggregate_partials(_agg_specs(T, table))
    assert [_agg_fields(a) for a in pa] == [_agg_fields(b) for b in pb]
    servers = (RServer(ref, max_batch=4), ScanServer(port, max_batch=4))
    rids = [[srv.submit_agg(spec) for spec in _agg_specs(engine, table)]
            + [srv.submit(engine.Predicate(*PREDS[0]))]
            for srv, engine in zip(servers, (R, T))]
    outs = [srv.drain() for srv in servers]
    for ra, rb in zip(*rids):
        a, b = outs[0][ra], outs[1][rb]
        if hasattr(a, "value"):
            assert a.value == b.value
        else:
            assert np.array_equal(a.keys, b.keys)
            assert np.array_equal(a.values, b.values)
    assert dict(ref.agg_stats.counts) == dict(port.agg_stats.counts)
    ref.compact()
    port.compact()
    assert_same_tree(ref, port)
    assert_same_aggs(ref, port)


def _no_kernel(*_tensors):
    raise AssertionError("a competitor path reached a kernel wrapper")


@pytest.mark.parametrize("filter_backend", FILTER_BACKENDS)
@pytest.mark.parametrize("codec", CODECS)
def test_competitor_paths_reach_no_kernel(codec, filter_backend, monkeypatch):
    """Writes, flushes, compactions (and blob GC), filters, aggregates, gets
    and range scans of a competitor tree never call a kernel wrapper (each
    asks ``on_card`` first); an 'opd' tree does."""
    monkeypatch.setattr(_build, "on_card", _no_kernel)
    tree = T.LSMTree(T.LSMConfig(filter_backend=filter_backend,
                                 **CODEC_KW[codec], **KW), device="cpu")
    for op, k, v in _stream(n=1500, seed=9, key_max=KEY_MAX):
        _apply(tree, op, k, v)
    snap = tree.snapshot()
    tree.compact()
    assert tree.n_compactions > 0
    tree.filter_many([T.Predicate(*p) for p in PREDS])
    tree.aggregate_many(_agg_specs(T))
    tree.aggregate_many(_agg_specs(T), snapshot=snap)
    tree.get(5)
    tree.range_lookup(0, KEY_MAX)
    opd = T.LSMTree(T.LSMConfig(filter_backend=filter_backend, **KW),
                    device="cpu")
    with pytest.raises(AssertionError, match="kernel wrapper"):
        for op, k, v in _stream(n=1500, seed=9, key_max=KEY_MAX):
            _apply(opd, op, k, v)
