"""The port's 'blob' codec and blob GC against the JAX package's, on the CPU.

``tests/test_blob_gc.py``'s three tests, each run on the port's tree and on
the reference's (``repro.LSMTree``) under the same stream: garbage-ratio
thresholds, GC rewrites whose values stay readable, and a snapshot taken
before compactions and GC that still reads its values and releases its
logs when it goes.  Beside each test's own checks, the two trees must agree
on ``gc_runs``, ``gc_bytes_rewritten``, the ``live`` and ``total`` tables,
every log's values and size, file ids and ``store.stats``.  Then
``LSMTree.from_arrays`` over a reference blob tree whose GC has run: the
port takes its logs and tables, and further writes compact and collect
as the reference's do.  Every case runs with and without
``blob_compress``.
"""

import gc

import numpy as np
import pytest

import repro.core as R
import repro.core.sct as rsct
import repro_torch.core as T
import repro_torch.core.sct as tsct
from repro.storage.io import FileStore as RStore
from repro_torch.storage.io import FileStore
from test_torch_engine import (COUNTERS, assert_same_blobs, assert_same_sct,
                               assert_same_tree, export_blobs, export_sct)

VW = 32
CFG = dict(codec="blob", value_width=VW, file_bytes=32 * 1024, l0_limit=2,
           size_ratio=3, max_levels=5, blob_gc_threshold=0.3)
COMPRESS = [False, True]


def _trees(compress):
    ref = R.LSMTree(R.LSMConfig(blob_compress=compress, **CFG))
    port = T.LSMTree(T.LSMConfig(blob_compress=compress, **CFG),
                     device="cpu")
    return ref, port


def _val(tag, i):
    return b"%s_%04d_" % (tag, i % 500) + b"q" * 8


def _fill(trees, oracle, tag, n, key_space, seed, check_every=None):
    """``n`` puts of random keys into every tree, the model ``oracle`` kept;
    with ``check_every``, the two trees compared after every flush and
    compaction."""
    rng = np.random.default_rng(seed)
    done = set()
    for _ in range(n):
        k = int(rng.integers(0, key_space))
        v = _val(tag, int(rng.integers(0, 1000)))
        for t in trees:
            t.put(k, v)
        oracle[k] = v
        if check_every:
            ref, port = trees
            state = (port.n_flushes, port.n_compactions)
            assert (ref.n_flushes, ref.n_compactions) == state
            if state not in done:
                done.add(state)
                check_every(ref, port)


def io(store):
    st = store.stats
    return (st.bytes_read, st.bytes_written, st.read_ios, st.write_ios)


def assert_same(ref, port):
    """Trees, logs, GC counters and I/O equal."""
    assert_same_tree(ref, port)
    assert io(ref.store) == io(port.store)


def _read_back(tree, oracle, keys):
    for k in keys:
        got = tree.get(int(k))
        if int(k) in oracle:
            assert got is not None and got.rstrip(b"\x00") == oracle[int(k)], k
        else:
            assert got is None, k


# --------------------------------------------------------------------------- #
# threshold semantics (unit level, deterministic)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compress", COMPRESS)
def test_gc_threshold_respected(compress):
    mgrs = (rsct.BlobManager(RStore(), VW, compress, gc_threshold=0.5),
            tsct.BlobManager(FileStore(), VW, compress, gc_threshold=0.5))
    vals = np.asarray([b"x" * VW] * 10, dtype=f"S{VW}")
    fids = [m.append(vals)[0] for m in mgrs]
    assert fids[0] == fids[1]
    fid = fids[1]
    assert io(mgrs[0].store) == io(mgrs[1].store)
    for bm in mgrs:
        bm.mark_dead(fid, 5)                # ratio == threshold: NOT eligible
        assert bm.garbage_ratio(fid) == 0.5
        assert fid not in bm.gc_candidates()
        bm.mark_dead(fid, 1)                # ratio 0.6 > 0.5: eligible
        assert fid in bm.gc_candidates()
        # mark_dead never drives the live count negative
        bm.mark_dead(fid, 100)
        assert bm.live[fid] == 0 and bm.garbage_ratio(fid) == 1.0
    ptrs = np.asarray([0, 3, 9], np.uint64)
    got = mgrs[1].read_values(fid, ptrs)
    assert np.array_equal(got, mgrs[0].read_values(fid, ptrs))
    assert io(mgrs[0].store) == io(mgrs[1].store)
    mgrs[1].forget(fid)
    assert mgrs[1].live_fids() == [] and mgrs[1].gc_candidates() == []
    # a log that is not in the store raises; nothing falls back
    with pytest.raises(KeyError):
        mgrs[1].read_values(fid + 1, ptrs)


# --------------------------------------------------------------------------- #
# engine-level rewrite correctness
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compress", COMPRESS)
def test_gc_rewrite_values_stay_readable(compress):
    ref, t = _trees(compress)
    oracle = {}
    _fill((ref, t), oracle, b"v1", 6000, 1500, seed=0)
    # overwrites => garbage; the trees compared at every flush and merge
    _fill((ref, t), oracle, b"v2", 6000, 1500, seed=1,
          check_every=assert_same)
    ref.flush()
    t.flush()
    assert_same(ref, t)
    assert t.blob_mgr.gc_runs > 0, "workload never triggered blob GC"
    assert t.blob_mgr.gc_bytes_rewritten > 0
    # GC runs at the end of every compaction, so no unpinned log may
    # linger past the threshold
    assert t.blob_mgr.gc_candidates() == []
    # every surviving value is byte-identical through point lookups...
    rng = np.random.default_rng(2)
    probe = rng.integers(0, 1500, 400)
    _read_back(t, oracle, probe)
    _read_back(ref, oracle, probe)
    # ...and through a full range scan (bulk blob addressing path)
    keys, values = t.range_lookup(0, 1500)
    assert keys.tolist() == sorted(oracle)
    for k, v in zip(keys.tolist(), values):
        assert bytes(v).rstrip(b"\x00") == oracle[k]
    ref.range_lookup(0, 1500)
    assert io(ref.store) == io(t.store)
    # rewritten logs are dense: no file may exceed the garbage threshold
    for fid in t.blob_mgr.live:
        assert t.blob_mgr.garbage_ratio(fid) <= t.cfg.blob_gc_threshold


# --------------------------------------------------------------------------- #
# snapshot isolation across compaction + GC
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compress", COMPRESS)
def test_snapshot_survives_compaction_and_gc(compress):
    ref, t = _trees(compress)
    v1 = {}
    _fill((ref, t), v1, b"v1", 5000, 1200, seed=3)
    ref.flush()
    t.flush()
    snaps = (ref.snapshot(), t.snapshot())
    snap_view = dict(v1)
    # a later writer overwrites everything (compactions + GC fire)
    v2 = dict(v1)
    _fill((ref, t), v2, b"v2", 8000, 1200, seed=4, check_every=assert_same)
    ref.flush()
    t.flush()
    assert_same(ref, t)
    # GC ran on the logs written after the snapshot; the snapshot's are
    # pinned, still past the threshold
    assert t.blob_mgr.gc_runs > 0
    pinned = t._pinned_blob_fids()
    assert pinned and set(t.blob_mgr.gc_candidates()) <= pinned
    # the snapshot still reads the pre-compaction values...
    rng = np.random.default_rng(5)
    for k in rng.integers(0, 1200, 300):
        k = int(k)
        got = t.get(k, snaps[1])
        assert got == ref.get(k, snaps[0])
        if k in snap_view:
            assert got is not None and got.rstrip(b"\x00") == snap_view[k], k
        else:
            assert got is None, k
    # ...including through the scan path pinned to the snapshot
    res = t.filter(T.Predicate("prefix", b"v1_"), snaps[1])
    exp = sorted(k for k, v in snap_view.items() if v.startswith(b"v1_"))
    assert sorted(res.keys.tolist()) == exp
    ref.filter(R.Predicate("prefix", b"v1_"), snaps[0])
    assert io(ref.store) == io(t.store)
    # ...while current reads see the new state
    some_k = next(iter(v2))
    assert t.get(some_k).rstrip(b"\x00") == v2[some_k] == \
        ref.get(some_k).rstrip(b"\x00")
    # releasing the snapshot un-pins its logs: the next GC pass reclaims
    # them and current values remain intact
    runs = t.blob_mgr.gc_runs
    del snaps
    gc.collect()
    ref._gc_blobs()
    t._gc_blobs()
    assert t.blob_mgr.gc_candidates() == []
    assert t.blob_mgr.gc_runs > runs
    assert t._pinned_blob_fids() == set()
    assert_same(ref, t)
    _read_back(t, v2, rng.integers(0, 1200, 200))


# --------------------------------------------------------------------------- #
# the reference's tree carried across
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("compress", COMPRESS)
def test_from_arrays_carries_the_logs_and_gc_state(compress):
    """A reference blob tree after GC (logs rewritten, garbage counted)
    carried into the port with its logs and ``live`` / ``total`` tables:
    the same reads, then further writes compact and collect as the
    reference's do, under the same file ids."""
    ref, _ = _trees(compress)
    oracle = {}
    _fill((ref,), oracle, b"v1", 4000, 1200, seed=6)
    _fill((ref,), oracle, b"v2", 3000, 1200, seed=7)
    ref.flush()
    # one more pass deletes the logs the last one replaced (a tree carries
    # the logs its runs point into, not the replaced ones)
    ref._gc_blobs()
    assert ref.blob_mgr.gc_runs > 0 and not ref._zombie_blobs
    assert ref.blob_mgr.live != ref.blob_mgr.total   # garbage accrued
    levels = [[export_sct(s) for s in lvl] for lvl in ref.levels]
    t = T.LSMTree.from_arrays(T.LSMConfig(blob_compress=compress, **CFG),
                              levels, ref._seqno, device="cpu",
                              **export_blobs(ref))
    # the history's counters too, so that the trees compare on what follows
    for c in COUNTERS:
        setattr(t, c, getattr(ref, c))
    t.blob_mgr.gc_runs = ref.blob_mgr.gc_runs
    t.blob_mgr.gc_bytes_rewritten = ref.blob_mgr.gc_bytes_rewritten
    assert t.store._next_id == ref.store._next_id
    base = np.subtract(io(ref.store), io(t.store))

    def same(a, b):
        """The trees' runs, logs and counters, and the I/O since the carry
        (the version ids count different histories)."""
        ids = [[[s.file_id for s in lvl] for lvl in x.levels] for x in (a, b)]
        assert ids[0] == ids[1]
        for la, lb in zip(a.levels, b.levels):
            for x, y in zip(la, lb):
                assert_same_sct(x, y)
        assert_same_blobs(a, b)
        for c in COUNTERS:
            assert getattr(a, c) == getattr(b, c), c
        assert a.disk_bytes == b.disk_bytes
        assert np.array_equal(np.subtract(io(a.store), io(b.store)), base)

    same(ref, t)
    assert all(s.blob_mgr is t.blob_mgr for s in t.all_runs())
    probe = np.random.default_rng(8).integers(0, 1200, 200)
    for k in probe:
        assert t.get(int(k)) == ref.get(int(k)), k
    ka, va = ref.range_lookup(0, 1200)
    kb, vb = t.range_lookup(0, 1200)
    assert np.array_equal(ka, kb) and np.array_equal(va, vb)

    runs = t.blob_mgr.gc_runs
    _fill((ref, t), oracle, b"v3", 5000, 1200, seed=9, check_every=same)
    assert t.blob_mgr.gc_runs > runs
    same(ref, t)
    _read_back(t, oracle, probe)
