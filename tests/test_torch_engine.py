"""The port's engine against the JAX engine, end to end, on the CPU.

The same put/delete stream goes into the reference tree
(``codec='opd'``, ``filter_backend='fused'``, ``compaction_backend=
'jax_packed'``, Pallas in interpret mode) and into the port's tree on
``device='cpu'`` (the kernels' plain versions).  After every flush and
every compaction the two trees must agree bit for bit: level shape and file
ids, every SCT's packed words, dictionary, zones, weight sums, bloom bits
and size, the counters, ``filter_many`` results and zone telemetry at the
1024-word tile, and ``get`` over present, overwritten and deleted keys.
The helpers take the competitor codecs too (``test_torch_codecs.py``).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T

VW = 24
KW = dict(value_width=VW, file_bytes=8 * 1024, l0_limit=2, size_ratio=3)
PREDS = [
    ("prefix", b"tag_0", b""),
    ("eq", b"tag_00037", b""),
    ("range", b"tag_00020", b"tag_00090"),
    ("ge", b"tag_00150", b""),
    ("le", b"", b"tag_00012"),
    ("prefix", b"zzz", b""),
    ("range", b"tag_00090", b"tag_00020"),   # inverted: empty
    ("prefix", b"tag_001", b""),
]
COUNTERS = ("n_flushes", "n_compactions", "dict_compares", "write_stalls",
            "compaction_in_bytes", "compaction_out_bytes")
ZONE_KEYS = ("fused_launches", "zone_tiles_total", "zone_tiles_skipped",
             "zone_blocks_total", "zone_blocks_skipped", "zone_blocks_prunable")


def _trees(**kw):
    """The reference and port trees under one configuration; the
    reference's codec and backends default to the port's defaults."""
    cfg = dict(KW, **kw)
    ref = R.LSMTree(R.LSMConfig(**dict(dict(
        codec="opd", filter_backend="fused",
        compaction_backend="jax_packed"), **cfg)))
    port = T.LSMTree(T.LSMConfig(**cfg), device="cpu")
    return ref, port


def _stream(n=3500, seed=5, key_max=1500, ndv=200):
    """Puts with overwrites, deletes mixed in (one in ten ops)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        k = int(rng.integers(0, key_max))
        if rng.random() < 0.1:
            yield ("delete", k, None)
        else:
            yield ("put", k, b"tag_%05d" % int(rng.integers(0, ndv)))


def _apply(tree, op, k, v):
    if op == "put":
        tree.put(k, v)
    else:
        tree.delete(k)


def assert_same_sct(a, b):
    assert b.codec == a.codec
    assert (a.file_id, a.level, a.disk_bytes, a.max_seqno) == \
        (b.file_id, b.level, b.disk_bytes, b.max_seqno)
    assert np.array_equal(a.keys, b.keys)
    assert np.array_equal(a.seqnos, b.seqnos)
    assert np.array_equal(a.tombs, b.tombs)
    ba, bb = a.blocks, b.blocks
    assert (ba.entries_per_block, ba.nbits, ba.n_hashes, ba.nbytes) == \
        (bb.entries_per_block, bb.nbits, bb.n_hashes, bb.nbytes)
    assert np.array_equal(ba.first_keys, bb.first_keys)
    assert np.array_equal(ba.last_keys, bb.last_keys)
    assert np.array_equal(ba.bloom_words, bb.bloom_words)
    if a.codec != "opd":
        _assert_same_competitor_values(a, b)
        return
    assert np.array_equal(b.live.numpy(), ~a.tombs)
    assert a.code_bits == b.code_bits
    assert np.array_equal(a.packed, b.packed.numpy().view(np.uint32))
    assert a.opd.values.dtype == b.opd.values.dtype
    assert np.array_equal(a.opd.values, b.opd.values)
    assert np.array_equal(ba.code_lo.astype(np.int64), bb.code_lo.numpy())
    assert np.array_equal(ba.code_hi.astype(np.int64), bb.code_hi.numpy())
    assert np.array_equal(ba.weight_sums, bb.weight_sums.numpy())


def _assert_same_competitor_values(a, b):
    """A 'plain' SCT's raw column, a 'heavy' one's zlib blocks or a 'blob'
    one's log pointers; no OPD fields, zone map or weight sums in either
    engine."""
    if a.codec == "plain":
        assert b.values.dtype == a.values.dtype
        assert np.array_equal(a.values, b.values)
        assert b.zblocks is None and b.vfids is None
    elif a.codec == "heavy":
        assert b.zblocks == a.zblocks
        assert b.zblock_entries == a.zblock_entries
        assert b.values is None and b.vfids is None
    else:
        assert b.vfids.dtype == a.vfids.dtype
        assert b.vptrs.dtype == a.vptrs.dtype
        assert np.array_equal(a.vfids, b.vfids)
        assert np.array_equal(a.vptrs, b.vptrs)
        assert b.values is None and b.zblocks is None
    assert (b.packed, b.opd, b.live) == (None, None, None)
    assert not a.blocks.has_zones and not b.blocks.has_zones
    assert a.blocks.weight_sums is None and b.blocks.weight_sums is None


def assert_same_tree(ref, port):
    ids = lambda t: [[s.file_id for s in lvl] for lvl in t.levels]
    assert ids(ref) == ids(port)
    for la, lb in zip(ref.levels, port.levels):
        for a, b in zip(la, lb):
            assert_same_sct(a, b)
    for c in COUNTERS:
        assert getattr(ref, c) == getattr(port, c), c
    if port.blob_mgr is not None:
        assert_same_blobs(ref, port)
    sa, sb = ref.shape_report(), port.shape_report()
    for k in ("levels", "level_bytes", "run_depths", "n_files", "disk_bytes",
              "dict_bytes", "version"):
        assert sa[k] == sb[k], k
    assert ref.file_entries == port.file_entries


def assert_same_reads(ref, port, probe_keys, snaps=(None, None)):
    """``filter_many`` and ``get`` at the snapshots ``snaps`` (reference's,
    port's; the latest when None), and the zone telemetry of 'opd' trees."""
    sa, sb = snaps
    ra = ref.filter_many([R.Predicate(*p) for p in PREDS], snapshot=sa)
    rb = port.filter_many([T.Predicate(*p) for p in PREDS], snapshot=sb)
    for p, a, b in zip(PREDS, ra, rb):
        assert np.array_equal(a.keys, b.keys), p
        assert a.values.dtype == b.values.dtype
        assert np.array_equal(a.values, b.values), p
        assert (a.n_scanned, a.n_matched_raw) == (b.n_scanned, b.n_matched_raw), p
    if port.cfg.codec == "opd":
        ca, cb = ref.filter_stats.counts, port.filter_stats.counts
        assert {k: ca[k] for k in ZONE_KEYS} == {k: cb[k] for k in ZONE_KEYS}
    for k in probe_keys:
        assert ref.get(k, snapshot=sa) == port.get(k, snapshot=sb), k


def test_stream_bit_identical_after_every_flush_and_compaction():
    ref, port = _trees()
    events, done = 0, set()
    for i, (op, k, v) in enumerate(_stream()):
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
        state = (port.n_flushes, port.n_compactions)
        assert (ref.n_flushes, ref.n_compactions) == state, i
        if state not in done:
            done.add(state)
            events += 1
            assert_same_tree(ref, port)
            if events % 3 == 1:   # reads at a spread of the states
                assert_same_reads(ref, port, range(0, 1500, 7))
    assert port.n_compactions >= 3 and port.n_flushes >= 8, port.shape_report()
    assert port.shape_report()["levels"][2] > 0, "need an L1 -> L2 cascade"
    assert_same_reads(ref, port, range(1500))   # memtable holds rows too


def test_compacted_runs_merge_again_and_snapshot_reads():
    """Every run compacted (packed-only SCTs), then merged again after more
    writes; a snapshot taken before the second batch reads the same."""
    ref, port = _trees()
    ops = list(_stream(n=1200, seed=11, key_max=600))
    for op, k, v in ops[:700]:
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    ref.compact()
    port.compact()
    assert not port.levels[0]
    assert_same_tree(ref, port)
    snap_a, snap_b = ref.snapshot(), port.snapshot()
    for op, k, v in ops[700:]:
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    ref.compact()
    port.compact()
    assert_same_tree(ref, port)
    assert_same_reads(ref, port, range(600))
    for p in PREDS:
        a = ref.filter(R.Predicate(*p), snapshot=snap_a)
        b = port.filter(T.Predicate(*p), snapshot=snap_b)
        assert np.array_equal(a.keys, b.keys) and np.array_equal(a.values, b.values)
    for k in range(0, 600, 5):
        assert ref.get(k, snapshot=snap_a) == port.get(k, snapshot=snap_b), k


def test_put_batch_matches_single_puts():
    """put_batch cuts its columnar runs where single puts would flush."""
    ref, port = _trees()
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 3000, 1800).astype(np.uint64)
    vals = np.asarray([b"tag_%05d" % int(v) for v in rng.integers(0, 300, 1800)],
                      f"S{VW}")
    ref.put_batch(keys, vals)
    port.put_batch(keys, vals)
    assert_same_tree(ref, port)
    assert ref._seqno == port._seqno
    assert_same_reads(ref, port, range(0, 3000, 3))


def assert_same_blobs(ref, port):
    """Two 'blob' trees' value logs: the liveness tables, the GC counters,
    the logs GC replaced and has yet to delete, the files in the store, and
    every live log's values and size."""
    ma, mb = ref.blob_mgr, port.blob_mgr
    assert (ma.live, ma.total) == (mb.live, mb.total)
    assert (ma.gc_runs, ma.gc_bytes_rewritten) == \
        (mb.gc_runs, mb.gc_bytes_rewritten)
    assert ref._zombie_blobs == port._zombie_blobs
    assert sorted(ref.store.fids()) == sorted(port.store._objects)
    for fid in ma.live:
        assert ref.store.size_of(fid) == port.store.size_of(fid), fid
        values = ref.store.payload(fid)[2]
        got = mb.log_values(fid)
        assert got.dtype == values.dtype and np.array_equal(got, values), fid


def export_blobs(ref) -> dict:
    """A reference 'blob' tree's logs and liveness tables, as the keyword
    arguments ``LSMTree.from_arrays`` takes."""
    mgr = ref.blob_mgr
    return dict(blob_logs={f: ref.store.payload(f)[2] for f in mgr.live},
                blob_live=dict(mgr.live), blob_total=dict(mgr.total))


def export_sct(s) -> dict:
    """The reference SCT, of any ported codec, as the plain per-SCT arrays
    ``sct_from_arrays`` takes."""
    b = s.blocks
    out = dict(codec=s.codec, keys=s.keys, seqnos=s.seqnos, tombs=s.tombs,
               entries_per_block=b.entries_per_block, first_keys=b.first_keys,
               last_keys=b.last_keys, bloom_words=b.bloom_words,
               n_hashes=b.n_hashes, nbits=b.nbits, file_id=s.file_id,
               level=s.level, disk_bytes=s.disk_bytes,
               key_bytes=s.key_bytes, value_width=s.value_width)
    if s.codec == "plain":
        out["values"] = s.values
    elif s.codec == "heavy":
        out.update(zblocks=list(s.zblocks), zblock_entries=s.zblock_entries)
    elif s.codec == "blob":
        out.update(vfids=s.vfids, vptrs=s.vptrs)
    else:
        out.update(packed=s.packed, code_bits=s.code_bits,
                   opd_values=s.opd.values, code_lo=b.code_lo,
                   code_hi=b.code_hi, weight_sums=b.weight_sums)
    return out


def test_from_arrays_reads_like_the_reference():
    """The reference's state carried into the port answers reads alike,
    isolating the read path from compaction."""
    ref, _ = _trees()
    for op, k, v in _stream(n=1600, seed=7):
        _apply(ref, op, k, v)
    ref.flush()
    assert sum(1 for lvl in ref.levels if lvl) >= 2, ref.shape_report()
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    port = T.LSMTree.from_arrays(T.LSMConfig(**KW), levels, ref._seqno,
                                 device="cpu")
    ids = lambda t: [[s.file_id for s in lvl] for lvl in t.levels]
    assert ids(port) == ids(ref)
    for la, lb in zip(ref.levels, port.levels):
        for a, b in zip(la, lb):
            assert_same_sct(a, b)
    ref.filter_stats.counts.clear()
    assert_same_reads(ref, port, range(1500))


def test_snapshot_get_across_block_boundary():
    """An old snapshot's version of a heavily updated key lies past a block
    boundary; both engines find it and charge the same block reads."""
    ref, port = (R.LSMTree(R.LSMConfig(codec="opd", value_width=VW,
                                       filter_backend="fused",
                                       compaction_backend="jax_packed")),
                 T.LSMTree(T.LSMConfig(value_width=VW), device="cpu"))
    for t in (ref, port):
        t.put(5, b"v_first")
    old = ref.snapshot().seqno
    assert port.snapshot().seqno == old
    for i in range(200):
        for t in (ref, port):
            t.put(5, b"v_%03d" % i)
    ref.flush()
    port.flush()
    sa = dataclasses.replace(ref.snapshot(), seqno=old)
    sb = dataclasses.replace(port.snapshot(), seqno=old)
    r0, p0 = ref.store.stats.read_ios, port.store.stats.read_ios
    assert ref.get(5, snapshot=sa) == port.get(5, snapshot=sb) == b"v_first"
    assert ref.get(5) == port.get(5) == b"v_199"
    assert ref.store.stats.read_ios - r0 == port.store.stats.read_ios - p0


@pytest.mark.parametrize("pred", PREDS[:5], ids=lambda p: p[0])
def test_empty_tree_and_memtable_only_filters(pred):
    ref, port = _trees()
    for t, P in ((ref, R.Predicate), (port, T.Predicate)):
        assert t.filter(P(*pred)).values.dtype == np.dtype(f"S{VW}")
    for op, k, v in list(_stream(n=60, seed=2)):
        _apply(ref, op, k, v)
        _apply(port, op, k, v)
    a, b = ref.filter(R.Predicate(*pred)), port.filter(T.Predicate(*pred))
    assert np.array_equal(a.keys, b.keys) and np.array_equal(a.values, b.values)
    assert a.n_matched_raw == b.n_matched_raw
