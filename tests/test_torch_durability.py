"""The port's durability against the JAX package's, on the CPU.

* ``tests/test_filestore_restore.py``'s and ``tests/test_version_set.py``'s
  tests, each run on the reference's store / version set / tree and on the
  port's.  The port's ``FileStore.restore`` gives an SCT back as its spill
  record and ``VersionSet.recover`` builds it (``sct_from_arrays``), so the
  tests that read a restored SCT compare it with the reference's.
* The same stream into a reference tree and a port tree with a spill
  directory, for the harness's five systems ('opd', 'plain', 'heavy',
  'blob', 'blob' + ``blob_compress`` as 'blob_zstd') and ``wal_sync``
  'off', 'group' and 'every': the trees, ``MANIFEST.log`` line for line
  (blob GC's replace edits included), the WAL segments byte for byte, the
  spill file names and ``io_report`` under each device model; then both
  closed and restored, and the restored trees equal to each other and to
  the port's tree before the close, SCT for SCT; aggregates answer alike
  with the same ``agg_*`` counters.  Every port spill file loads with an
  unpickler that refuses any ``torch``, ``repro_torch`` or ``repro``
  global.
* The sync-mode crash matrix: both engines armed at the same (point,
  skip) over one ``gen_ops`` stream must fire alike, leave the same WAL
  floor, recover the same seqno K and the same tree, hold the oracle's
  state of the first K mutations, and keep working.  'opd' runs under the
  'numpy' backends and under the port's defaults ('fused', 'jax_packed';
  the reference stays on 'numpy', whose trees are bit for bit the same),
  the four competitors under 'group'; the blob GC points run on the blob
  systems only (the others never reach them) and ``split.before_table``
  nowhere (no shard split here).  A torn WAL record and deeper hits
  (``skip``) too.
* The crash matrix in background mode (``tests/test_wal_recovery.py``'s
  ``mode='background'`` cases): the port alone, because where a worker
  meets the armed site depends on thread timing; 'opd' under 'group' on
  'numpy' backends over the eight tree points, on the port's defaults
  over the six flush and compaction points, and 'blob' over the two GC
  points.  A site on a worker reaches the writer as ``MaintenanceError``
  wrapping ``SimulatedCrash``; the workers are stopped without touching
  the WAL (``_quiesce``).  The restore must recover a seqno K within
  [durable floor, issued] and answer as the oracle's first K mutations and
  as a sync reference tree (the JAX engine) fed them; tree shapes are not
  compared.
* The subprocess ``os._exit(137)`` kill through both engines' crash
  drivers, the port's with ``--device cpu``: the same site in sync mode on
  both, and in background mode each engine's restore checked as above.
"""

import itertools
import json
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as R
import repro.core.sct as rsct
import repro.core.version as rver
import repro.testing.workload as rwork
import repro_torch.core as T
import repro_torch.core.sct as tsct
import repro_torch.core.version as tver
from repro.storage.devices import DEVICES as RDEVICES
from repro.storage.io import FileStore as RStore
from repro.testing.crashpoints import CRASH as RCRASH
from repro.testing.crashpoints import SimulatedCrash as RCrash
from repro_torch.core.maintenance import MaintenanceError
from repro_torch.query import AggSpec, GroupBy
from repro_torch.storage.devices import DEVICES as TDEVICES
from repro_torch.storage.io import FileStore as TStore
from repro_torch.testing.crashpoints import CRASH as TCRASH
from repro_torch.testing.crashpoints import CRASH_POINTS
from repro_torch.testing.crashpoints import SimulatedCrash as TCrash
from repro_torch.testing.workload import (apply_op, gen_ops, mutations,
                                          oracle_state, value_for)
from test_torch_engine import assert_same_sct, assert_same_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VW = 16
ENGINES = ["ref", "port"]


# --------------------------------------------------------------------------- #
# one namespace per engine
# --------------------------------------------------------------------------- #
def _ref_sct(store, keys, level=0):
    return rsct.build_sct(store=store, **_sct_args(keys, level))


def _port_sct(store, keys, level=0):
    return tsct.build_sct(store=store, device="cpu", **_sct_args(keys, level))


def _sct_args(keys, level):
    keys = np.asarray(sorted(keys), np.uint64)
    n = keys.shape[0]
    return dict(
        keys=keys, seqnos=np.arange(1, n + 1, dtype=np.uint64),
        tombs=np.zeros(n, np.bool_),
        raw_values=np.asarray([b"v%02d" % (int(k) % 97) for k in keys],
                              f"S{VW}"),
        level=level, codec="opd", key_bytes=8, value_width=VW,
        block_bytes=512, bloom_bits_per_key=8)


def _port_recover(store, max_levels):
    """``VersionSet.recover`` over a restored port store, each kept run
    built on the CPU from its spill record and put back as the file's
    payload, as ``LSMTree.restore`` does on its device."""
    def load(fid):
        _tag, fields = store.payload(fid)
        sct = tsct.sct_from_arrays(fields, "cpu")
        store.put_payload(fid, sct)
        return sct
    return tver.VersionSet.recover(store, max_levels, load=load)


ENGINE = {
    "ref": SimpleNamespace(
        Store=RStore, VersionSet=rver.VersionSet, VersionEdit=rver.VersionEdit,
        Version=rver.Version, gc_orphan_scts=rver.gc_orphan_scts,
        sct=_ref_sct, recover=rver.VersionSet.recover,
        tree=lambda kw, **a: R.LSMTree(R.LSMConfig(**kw), **a)),
    "port": SimpleNamespace(
        Store=TStore, VersionSet=tver.VersionSet, VersionEdit=tver.VersionEdit,
        Version=tver.Version, gc_orphan_scts=tver.gc_orphan_scts,
        sct=_port_sct, recover=_port_recover,
        tree=lambda kw, **a: T.LSMTree(T.LSMConfig(**kw), device="cpu", **a)),
}


@pytest.fixture(params=ENGINES)
def E(request):
    return ENGINE[request.param]


class HostOnly(pickle.Unpickler):
    """Refuses any global of torch, the port or the reference."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("torch", "repro_torch", "repro"):
            raise pickle.UnpicklingError(f"{module}.{name} in a spill file")
        return super().find_class(module, name)


def load_host_only(spill_dir):
    """Every spill file of ``spill_dir`` through ``HostOnly``; returns the
    number of SCT records."""
    n = 0
    for name in sorted(os.listdir(spill_dir)):
        if name.startswith("f") and name.endswith(".bin"):
            with open(os.path.join(spill_dir, name), "rb") as f:
                obj, _ = HostOnly(f).load()
            n += tsct.is_sct_record(obj)
    return n


# --------------------------------------------------------------------------- #
# tests/test_filestore_restore.py on both engines
# --------------------------------------------------------------------------- #
def _payloads():
    rng = np.random.default_rng(0)
    return [("tuple", rng.integers(0, 99, 32), b"tail"), rng.random(100),
            {"k": np.arange(7, dtype=np.uint64)}]


def _assert_obj_equal(a, b):
    if isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_obj_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_obj_equal(a[k], b[k])
    else:
        assert a == b


def test_restore_round_trip(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    fids = [store.write(obj, nbytes=100 * (i + 1))
            for i, obj in enumerate(_payloads())]
    store.delete(fids[1])   # a deletion must not come back on restore
    back = E.Store.restore(spill)
    assert back.n_files == 2
    assert not back.contains(fids[1])
    for fid in (fids[0], fids[2]):
        assert back.contains(fid)
        assert back.size_of(fid) == store.size_of(fid)
        _assert_obj_equal(back.payload(fid), store.payload(fid))
    assert back.write(b"post-restart", nbytes=12) == max(fids) + 1
    assert back.stats.bytes_read == 0
    assert back.stats.bytes_written == 12


def test_restore_empty_dir(E, tmp_path):
    spill = str(tmp_path / "empty")
    os.makedirs(spill)
    back = E.Store.restore(spill)
    assert back.n_files == 0
    assert back.write(b"x", nbytes=1) == 0


def test_spill_files_track_deletes(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    fid = store.write(b"abc", nbytes=3)
    path = os.path.join(spill, f"f{fid:08d}.bin")
    assert os.path.exists(path)
    store.delete(fid)
    assert not os.path.exists(path)


def test_payload_accessor_matches_read(E):
    store = E.Store()
    fid = store.write(("obj",), nbytes=64)
    before = store.stats.bytes_read
    assert store.payload(fid) == ("obj",)
    assert store.stats.bytes_read == before
    assert store.read(fid) == ("obj",)
    assert store.stats.bytes_read == before + 64
    assert store.contains(fid)
    store.delete(fid)
    assert not store.contains(fid)
    with pytest.raises(KeyError):
        store.payload(fid)


SYSTEMS = {"opd": dict(codec="opd"), "plain": dict(codec="plain"),
           "heavy": dict(codec="heavy"), "blob": dict(codec="blob"),
           "blob_zstd": dict(codec="blob", blob_compress=True)}


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_tree_store_restores_scts(system, tmp_path):
    """A tree's spilled SCTs come back: the reference's as SCTs, the
    port's as spill records of host arrays that build the same SCT."""
    kw = dict(value_width=VW, file_bytes=8 * 1024, l0_limit=2, size_ratio=3,
              max_levels=4, filter_backend="numpy",
              compaction_backend="numpy", **SYSTEMS[system])
    trees = [ENGINE[e].tree(kw, spill_dir=str(tmp_path / e))
             for e in ENGINES]
    rng = np.random.default_rng(1)
    for k in rng.integers(0, 2000, 1500).tolist():
        for t in trees:
            t.put(int(k), b"val_%04d" % (k % 97))
    for t in trees:
        t.flush()
    ref, port = trees
    assert_same_tree(ref, port)
    live = {s.file_id for lvl in port.levels for s in lvl}
    assert live
    rback, pback = (ENGINE[e].Store.restore(str(tmp_path / e))
                    for e in ENGINES)
    assert sorted(pback.fids()) == sorted(rback.fids()) \
        == sorted(port.store.fids())
    mgr = port.blob_mgr
    for fid in live:
        rec = pback.payload(fid)
        assert tsct.is_sct_record(rec)
        built = tsct.sct_from_arrays(rec[1], "cpu", mgr)
        assert_same_sct(rback.payload(fid), built)
        assert_same_arrays(built, port.store.payload(fid))
        assert pback.size_of(fid) == built.disk_bytes
    assert load_host_only(str(tmp_path / "port")) == len(
        [f for f in pback.fids() if tsct.is_sct_record(pback.payload(f))])


def assert_same_arrays(a, b):
    """Two port SCTs equal field for field (``sct_to_arrays``)."""
    fa, fb = tsct.sct_to_arrays(a), tsct.sct_to_arrays(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_sct_to_arrays_inverts_sct_from_arrays(system):
    port = ENGINE["port"].tree(dict(value_width=VW, file_bytes=8 * 1024,
                                    **SYSTEMS[system]))
    for k in range(900):
        port.put(k * 7 % 1000, b"val_%03d" % (k % 41))
        if k % 10 == 0:
            port.delete(k * 3 % 1000)
    port.flush()
    for s in port.all_runs():
        back = tsct.sct_from_arrays(tsct.sct_to_arrays(s), "cpu",
                                    port.blob_mgr)
        assert_same_arrays(back, s)
        assert back.max_seqno == s.max_seqno
        assert back.blob_mgr is s.blob_mgr


# --------------------------------------------------------------------------- #
# tests/test_version_set.py on both engines
# --------------------------------------------------------------------------- #
def test_with_edit_is_functional_and_preserves_l0_order(E):
    store = E.Store()
    vs = E.VersionSet(store, max_levels=3)
    a, b, c = (E.sct(store, [1, 5]), E.sct(store, [2, 6]),
               E.sct(store, [3, 7]))
    v1 = vs.apply(E.VersionEdit(adds=[(0, a)]))
    v2 = vs.apply(E.VersionEdit(adds=[(0, b), (0, c)]))
    assert [s.file_id for s in v2.levels[0]] == [c.file_id, b.file_id,
                                                 a.file_id]
    assert [s.file_id for s in v1.levels[0]] == [a.file_id]
    assert v2.vid == v1.vid + 1


def test_edit_drops_and_deeper_level_sorting(E):
    store = E.Store()
    vs = E.VersionSet(store, max_levels=3)
    lo = E.sct(store, [10, 20], level=1)
    hi = E.sct(store, [30, 40], level=1)
    vs.apply(E.VersionEdit(adds=[(1, hi)]))
    v = vs.apply(E.VersionEdit(adds=[(1, lo)]))
    assert [s.min_key for s in v.levels[1]] == [10, 30]
    v = vs.apply(E.VersionEdit(drops=[(1, hi.file_id)]))
    assert [s.file_id for s in v.levels[1]] == [lo.file_id]


def test_replace_preserves_position(E):
    store = E.Store()
    vs = E.VersionSet(store, max_levels=2)
    a, b, c = (E.sct(store, [1]), E.sct(store, [2]), E.sct(store, [3]))
    vs.apply(E.VersionEdit(adds=[(0, a), (0, b), (0, c)]))
    b2 = E.sct(store, [2])
    v = vs.apply(E.VersionEdit(replaces=[(0, b.file_id, b2)]))
    assert [s.file_id for s in v.levels[0]] == \
        [c.file_id, b2.file_id, a.file_id]


def test_manifest_replay_round_trip(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=3)
    a = E.sct(store, [1, 5])
    b = E.sct(store, [2, 6])
    merged = E.sct(store, [1, 2, 5, 6], level=1)
    vs.apply(E.VersionEdit(adds=[(0, a)], last_seqno=2))
    vs.apply(E.VersionEdit(adds=[(0, b)], last_seqno=4))
    vs.apply(E.VersionEdit(adds=[(1, merged)],
                           drops=[(0, a.file_id), (0, b.file_id)],
                           last_seqno=4))
    store.delete(a.file_id)
    store.delete(b.file_id)
    back = E.recover(E.Store.restore(spill), max_levels=3)
    assert back.last_seqno == 4
    assert [s.file_id for s in back.current.levels[0]] == []
    assert [s.file_id for s in back.current.levels[1]] == [merged.file_id]
    got = back.current.levels[1][0]
    assert np.array_equal(got.keys, merged.keys)
    assert got.file_id == merged.file_id
    # the rebuilt SCT is the store's payload of its file now
    assert back.store.payload(merged.file_id) is got


def test_manifest_replay_tolerates_dropped_files(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    a = E.sct(store, [1])
    vs.apply(E.VersionEdit(adds=[(0, a)]))
    vs.apply(E.VersionEdit(drops=[(0, a.file_id)]))
    store.delete(a.file_id)
    back = E.recover(E.Store.restore(spill), max_levels=2)
    assert back.current.n_files == 0


def test_manifest_recover_truncated_final_line(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    a = E.sct(store, [1])
    b = E.sct(store, [2])
    vs.apply(E.VersionEdit(adds=[(0, a)], last_seqno=1))
    vs.apply(E.VersionEdit(adds=[(0, b)], last_seqno=2))
    path = vs._manifest_path
    good_len = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b'{"adds": [[0, 99')
    back = E.recover(E.Store.restore(spill), max_levels=2)
    assert back.last_seqno == 2
    assert [s.file_id for s in back.current.levels[0]] == \
        [b.file_id, a.file_id]
    assert os.path.getsize(path) == good_len
    c = E.sct(back.store, [3])
    back.apply(E.VersionEdit(adds=[(0, c)], last_seqno=3))
    again = E.recover(E.Store.restore(spill), max_levels=2)
    assert [s.file_id for s in again.current.levels[0]] == \
        [c.file_id, b.file_id, a.file_id]


def test_manifest_recover_torn_non_dict_tail(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    a = E.sct(store, [1])
    vs.apply(E.VersionEdit(adds=[(0, a)], last_seqno=1))
    path = vs._manifest_path
    good_len = os.path.getsize(path)
    with open(path, "ab") as f:
        f.write(b"4")
    back = E.recover(E.Store.restore(spill), max_levels=2)
    assert [s.file_id for s in back.current.levels[0]] == [a.file_id]
    assert os.path.getsize(path) == good_len


def test_manifest_recover_rejects_mid_log_corruption(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    a = E.sct(store, [1])
    b = E.sct(store, [2])
    vs.apply(E.VersionEdit(adds=[(0, a)], last_seqno=1))
    with open(vs._manifest_path, "ab") as f:
        f.write(b"!!! not json !!!\n")
    vs_dirty = E.VersionSet(store, max_levels=2)
    vs_dirty.apply(E.VersionEdit(adds=[(0, b)], last_seqno=2))
    with pytest.raises(ValueError, match="corrupted at byte"):
        E.recover(E.Store.restore(spill), max_levels=2)


def test_gc_orphans_single_and_union(E, tmp_path):
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    live = E.sct(store, [1])
    orphan = E.sct(store, [9])        # spilled but never logged (a crash)
    blob_like = store.write(("raw", None, np.zeros(3, f"S{VW}")), 48)
    vs.apply(E.VersionEdit(adds=[(0, live)]))
    assert vs.gc_orphans() == [orphan.file_id]
    assert store.contains(live.file_id)
    assert store.contains(blob_like)  # a payload that is no SCT stays
    other = E.sct(store, [4])
    v_other = E.Version(((other,), ()))
    assert E.gc_orphan_scts(store, [vs.current, v_other]) == []
    assert store.contains(other.file_id)


def test_gc_orphans_of_a_restored_store(E, tmp_path):
    """After a restore the port's store holds spill records, not SCTs:
    an orphaned record goes, a value log stays, on both engines."""
    spill = str(tmp_path / "spill")
    store = E.Store(spill)
    vs = E.VersionSet(store, max_levels=2)
    live = E.sct(store, [1])
    orphan = E.sct(store, [9])
    blob_like = store.write(np.zeros(3, f"S{VW}"), 48)
    vs.apply(E.VersionEdit(adds=[(0, live)]))
    back = E.recover(E.Store.restore(spill), max_levels=2)
    assert back.gc_orphans() == [orphan.file_id]
    assert sorted(back.store.fids()) == [live.file_id, blob_like]
    assert not os.path.exists(os.path.join(spill, f"f{orphan.file_id:08d}.bin"))


def test_tree_level_mutation_goes_through_edits(E):
    t = E.tree(dict(codec="opd", value_width=VW, file_bytes=8 * 1024,
                    l0_limit=2, size_ratio=2, max_levels=4))
    for k in range(500):
        t.put(k, b"v%02d" % (k % 50))
    t.flush()
    view = t.levels
    view[0].clear()
    assert t.n_files > 0
    assert len(t.levels[0]) == len(t.versions.current.levels[0])


def test_manifest_records_are_json_lines(E, tmp_path):
    spill = str(tmp_path / "s")
    t = E.tree(dict(codec="opd", value_width=VW, file_bytes=8 * 1024,
                    l0_limit=2, size_ratio=2, max_levels=4), spill_dir=spill)
    for k in range(2000):
        t.put(k % 700, b"v%02d" % (k % 50))
    t.flush()
    with open(os.path.join(spill, E.VersionSet.MANIFEST)) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    assert len(recs) == t.versions.current.vid
    assert any("adds" in r for r in recs)
    assert any("drops" in r for r in recs)


# --------------------------------------------------------------------------- #
# one stream into both engines' spilled trees
# --------------------------------------------------------------------------- #
def _kw(system, wal, backend="numpy", **extra):
    """The recovery tests' configuration; the reference always on 'numpy'
    backends, the port on ``backend`` ('numpy', or 'default' for its
    'fused' / 'jax_packed')."""
    base = dict(value_width=32, memtable_bytes=8 * 1024, file_bytes=16 * 1024,
                l0_limit=2, size_ratio=3, max_levels=5, blob_gc_threshold=0.3,
                wal_sync=wal, **SYSTEMS[system], **extra)
    ref = dict(base, filter_backend="numpy", compaction_backend="numpy")
    port = dict(base) if backend == "default" else dict(ref)
    return ref, port


def _key_space(system):
    return 300 if system.startswith("blob") else 1200   # churn for blob GC


def _spill_pair(tmp_path, system, wal, backend="numpy", **extra):
    rkw, pkw = _kw(system, wal, backend, **extra)
    dirs = [str(tmp_path / e) for e in ENGINES]
    ref = R.LSMTree(R.LSMConfig(**rkw), spill_dir=dirs[0])
    port = T.LSMTree(T.LSMConfig(**pkw), spill_dir=dirs[1], device="cpu")
    return ref, port, dirs, rkw, pkw


def _files(d, suffix):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(suffix)}


def assert_same_disk(dirs):
    """MANIFEST.log line for line, the WAL segments byte for byte, the
    same spill file names."""
    a, b = (_files(d, ".log") for d in dirs)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].decode().splitlines() == b[name].decode().splitlines()
    a, b = (_files(d, ".wal") for d in dirs)
    assert a == b
    names = [sorted(n for n in os.listdir(d) if n.endswith(".bin"))
             for d in dirs]
    assert names[0] == names[1]


def assert_same_answers(ref, port, key_space):
    a = ref.filter(R.Predicate("prefix", b"pfx_0"))
    b = port.filter(T.Predicate("prefix", b"pfx_0"))
    assert a.keys.tolist() == b.keys.tolist()
    assert a.values.tolist() == b.values.tolist()
    ka, va = ref.range_lookup(0, key_space)
    kb, vb = port.range_lookup(0, key_space)
    assert ka.tolist() == kb.tolist() and va.tolist() == vb.tolist()
    for k in range(0, key_space, 13):
        assert ref.get(k) == port.get(k), k
    return {int(k): bytes(v) for k, v in zip(kb, vb)}


AGGS = [AggSpec("count"), AggSpec("sum"), AggSpec("min"), AggSpec("max"),
        AggSpec("group_count", group=GroupBy("prefix", prefix_len=7),
                top_k=5)]


def _aggregate(tree):
    """``aggregate_many`` of ``AGGS`` and the ``agg_*`` counters it moved."""
    before = {k: v for k, v in tree.agg_stats.counts.items()
              if k.startswith("agg_")}
    got = [(r.count, r.total, r.min_value, r.max_value, r.groups)
           for r in tree.aggregate_many(AGGS)]
    after = {k: v for k, v in tree.agg_stats.counts.items()
             if k.startswith("agg_")}
    return got, {k: v - before.get(k, 0) for k, v in after.items()}


SPILLED = [(s, "numpy") for s in SYSTEMS] + [("opd", "default")]


@pytest.mark.parametrize("wal", ["off", "group", "every"])
@pytest.mark.parametrize("system,backend", SPILLED,
                         ids=["-".join(c) for c in SPILLED])
def test_spilled_tree_matches_reference_and_restores(tmp_path, system,
                                                     backend, wal):
    """Under the port's default backends the tree is compacted before the
    close, so that the restored runs take the aggregate fast path (the
    reference stays on 'numpy', whose trees are the same)."""
    ref, port, dirs, rkw, pkw = _spill_pair(tmp_path, system, wal, backend)
    ks = _key_space(system)
    ops = gen_ops(7, 1500, ks)
    for op in ops:
        apply_op(ref, op)
        apply_op(port, op)
    assert port.n_compactions > 0
    if system.startswith("blob"):
        assert port.blob_mgr.gc_runs > 0
        assert any('"replaces"' in line for line in
                   open(os.path.join(dirs[1], "MANIFEST.log")))
    assert_same_tree(ref, port)
    assert_same_disk(dirs)
    for name in RDEVICES:
        assert ref.io_report(RDEVICES[name]) == port.io_report(TDEVICES[name])
    assert_same_answers(ref, port, ks)
    assert load_host_only(dirs[1]) == len(port.all_runs())
    if backend == "default":
        ref.compact()
        port.compact()
    elif wal == "off":
        # without a WAL the memtable dies with the process: flush it first
        ref.flush()
        port.flush()
    aggs = _aggregate(port)
    if backend == "default":
        assert aggs[1]["agg_fastpath_runs"] > 0
    before = {s.file_id: s for s in port.all_runs()}

    ref.close()
    port.close()
    rb = R.LSMTree.restore(R.LSMConfig(**rkw), dirs[0])
    pb = T.LSMTree.restore(T.LSMConfig(**pkw), dirs[1], device="cpu")
    assert (rb._seqno, rb.wal_replayed) == (pb._seqno, pb.wal_replayed)
    muts = mutations(ops)
    if wal != "off":
        assert pb._seqno == len(muts)   # a planned close loses nothing
    assert_same_tree(rb, pb)
    for s in pb.all_runs():
        assert_same_arrays(s, before[s.file_id])
    got = assert_same_answers(rb, pb, ks)
    if wal != "off":
        assert got == oracle_state(muts, len(muts))
    assert _aggregate(pb) == aggs
    # the restored trees keep working, and keep writing the same files
    for op in gen_ops(8, 400, ks):
        apply_op(rb, op)
        apply_op(pb, op)
    rb.flush()
    pb.flush()
    assert_same_tree(rb, pb)
    assert_same_disk(dirs)
    assert_same_answers(rb, pb, ks)


# --------------------------------------------------------------------------- #
# the crash matrix
# --------------------------------------------------------------------------- #
def apply_ops(tree, ops):
    for op in ops:
        apply_op(tree, op)


# ``put_batch`` streams: few deletes and hints, so that runs of puts span
# several memtables, cut into batches of these sizes in turn (a memtable
# of ``_kw`` holds 147 records); a group commit every 2 KiB, so that
# 'group' syncs inside a batch as well as at its end
BATCH_MIX = dict(p_delete=0.01, p_flush=0.001, p_compact=0.0005)
BATCH_SIZES = (1, 37, 5, 211, 64, 400)
BATCH_KW = dict(wal_group_bytes=2048)


def apply_batched(tree, ops):
    """``ops`` with each run of consecutive puts cut into ``put_batch``
    calls of the ``BATCH_SIZES`` in turn; the other ops one by one."""
    sizes = itertools.cycle(BATCH_SIZES)
    i = 0
    while i < len(ops):
        if ops[i][0] != "put":
            apply_op(tree, ops[i])
            i += 1
            continue
        j, n = i, next(sizes)
        while j < len(ops) and j - i < n and ops[j][0] == "put":
            j += 1
        tree.put_batch(np.asarray([op[1] for op in ops[i:j]], np.uint64),
                       np.asarray([op[2] for op in ops[i:j]], "S32"))
        i = j


def _ingest(tree, ops, crash_cls, registry, feed):
    try:
        feed(tree, ops)
    except crash_cls:
        return True
    return registry.fired is not None


def crash_pair(tmp_path, system, point, wal, backend="numpy", skip=0,
               tear=False, n=900, seed=11, batched=False):
    """Both engines over one stream, armed at ``point`` after ``skip``
    hits; -> (ops, K) after the differential recovery checks.  With
    ``batched`` the stream is ``BATCH_MIX``'s, fed through
    ``apply_batched``."""
    extra = BATCH_KW if batched else {}
    ref, port, dirs, rkw, pkw = _spill_pair(tmp_path, system, wal, backend,
                                            **extra)
    ks = _key_space(system)
    ops = gen_ops(seed, n, ks, **(BATCH_MIX if batched else {}))
    feed = apply_batched if batched else apply_ops
    outcome = []
    for tree, registry, crash_cls in ((ref, RCRASH, RCrash),
                                      (port, TCRASH, TCrash)):
        with registry.armed(point, skip=skip):
            fired = _ingest(tree, ops, crash_cls, registry, feed)
            floor = tree.wal.durable_seqno
            tree.wal.simulate_power_loss(tear=tear)
        outcome.append((fired, floor, tree._seqno))
    assert outcome[0] == outcome[1]
    fired, floor, _ = outcome[1]
    assert fired, f"the stream never reached {point} (skip {skip})"
    rb = R.LSMTree.restore(R.LSMConfig(**rkw), dirs[0])
    pb = T.LSMTree.restore(T.LSMConfig(**pkw), dirs[1], device="cpu")
    muts = mutations(ops)
    K = pb._seqno
    assert rb._seqno == K and floor <= K <= len(muts)
    assert rb.wal_replayed == pb.wal_replayed
    assert_same_tree(rb, pb)
    assert_same_disk(dirs)
    assert assert_same_answers(rb, pb, ks) == oracle_state(muts, K)
    # the recovered trees keep working: the rest of the stream, then a flush
    for op in muts[K:]:
        apply_op(rb, op)
        apply_op(pb, op)
    rb.flush()
    pb.flush()
    assert_same_tree(rb, pb)
    assert assert_same_answers(rb, pb, ks) == oracle_state(muts, len(muts))
    pb.put(0, b"pfx_999_post")
    assert pb.get(0) == b"pfx_999_post"
    rb.close()
    pb.close()
    return ops, K


SYNC_POINTS = [p for p in CRASH_POINTS if p != "split.before_table"]
TREE_POINTS = [p for p in SYNC_POINTS if not p.startswith("gc.")]
MATRIX = ([("opd", p, "every", "numpy") for p in TREE_POINTS]
          + [("opd", p, "group", "default") for p in TREE_POINTS]
          + [(c, p, "group", "numpy") for c in ("plain", "heavy")
             for p in TREE_POINTS]
          + [(c, p, "group", "numpy") for c in ("blob", "blob_zstd")
             for p in SYNC_POINTS])


@pytest.mark.parametrize("system,point,wal,backend", MATRIX,
                         ids=["-".join(c) for c in MATRIX])
def test_crash_matrix(tmp_path, system, point, wal, backend):
    crash_pair(tmp_path, system, point, wal, backend)


def test_crash_at_deeper_hits_via_skip(tmp_path):
    for skip in (0, 3, 9):
        crash_pair(tmp_path / f"s{skip}", "opd", "flush.before_manifest",
                   "group", skip=skip, n=2000)


# crashes inside ``put_batch``: at an append past the first batches, at
# a sync (a group commit inside a batch, or the batch's own barrier), at
# a flush's spill and manifest append that a full memtable started, and
# at the compaction that flush set off
BATCH_CRASHES = [
    ("opd", "wal.after_append", "group", "numpy", 700),
    ("opd", "wal.after_append", "every", "numpy", 700),
    ("opd", "wal.after_append", "group", "default", 1111),
    ("opd", "wal.after_sync", "group", "numpy", 9),
    ("opd", "wal.after_sync", "every", "numpy", 400),
    ("opd", "flush.mid_spill", "group", "numpy", 2),
    ("opd", "flush.before_manifest", "group", "numpy", 3),
    ("opd", "flush.before_manifest", "every", "default", 5),
    ("opd", "flush.after_manifest", "group", "numpy", 4),
    ("opd", "compact.before_manifest", "group", "numpy", 1),
    ("blob", "wal.after_append", "group", "numpy", 700),
    ("blob", "flush.before_manifest", "group", "numpy", 3),
]


@pytest.mark.parametrize("system,point,wal,backend,skip", BATCH_CRASHES,
                         ids=["-".join(map(str, c)) for c in BATCH_CRASHES])
def test_crash_inside_put_batch(tmp_path, system, point, wal, backend,
                                skip):
    crash_pair(tmp_path, system, point, wal, backend, skip=skip, n=1500,
               batched=True)


BATCHED = [("opd", "numpy"), ("opd", "default"), ("blob", "numpy")]


@pytest.mark.parametrize("wal", ["group", "every"])
@pytest.mark.parametrize("system,backend", BATCHED,
                         ids=["-".join(c) for c in BATCHED])
def test_put_batch_matches_reference_and_restores(tmp_path, system, backend,
                                                  wal):
    """``put_batch`` streams across several memtable rotations: the same
    WAL segments byte for byte, the same appends, syncs and rotations,
    the same manifest and tree, after every batch size; then both closed
    and restored alike, holding every write."""
    ref, port, dirs, rkw, pkw = _spill_pair(tmp_path, system, wal, backend,
                                            **BATCH_KW)
    ks = _key_space(system)
    ops = gen_ops(5, 2500, ks, **BATCH_MIX)
    apply_batched(ref, ops)
    apply_batched(port, ops)
    counts = [(t.wal.appends, t.wal.syncs, t.wal.rotations,
               t.wal.truncations, t.wal.durable_seqno, t._seqno)
              for t in (ref, port)]
    assert counts[0] == counts[1]
    assert port.n_flushes >= 10 and port.n_compactions > 0
    assert_same_tree(ref, port)
    assert_same_disk(dirs)
    muts = mutations(ops)
    assert assert_same_answers(ref, port, ks) == oracle_state(muts, len(muts))
    ref.close()
    port.close()
    rb = R.LSMTree.restore(R.LSMConfig(**rkw), dirs[0])
    pb = T.LSMTree.restore(T.LSMConfig(**pkw), dirs[1], device="cpu")
    assert (rb._seqno, rb.wal_replayed) == (pb._seqno, pb.wal_replayed)
    assert pb._seqno == len(muts) and pb.wal_replayed > 0
    assert_same_tree(rb, pb)
    assert assert_same_answers(rb, pb, ks) == oracle_state(muts, len(muts))


@pytest.mark.parametrize("backend", ["numpy", "default"])
def test_torn_wal_record_through_engine(tmp_path, backend):
    crash_pair(tmp_path, "opd", "wal.after_append", "group", backend,
               tear=True)


def test_failed_flush_deletes_its_spilled_chunks(tmp_path, monkeypatch):
    """A flush failing with an exception (not a kill) deletes the chunks it
    spilled, keeps the memtable readable and queued, and a retry writes
    it whole; the reference does the same."""
    kw = dict(value_width=32, memtable_bytes=64 * 1024, file_bytes=16 * 1024,
              wal_sync="group", filter_backend="numpy",
              compaction_backend="numpy")
    dirs = [str(tmp_path / e) for e in ENGINES]
    ref = R.LSMTree(R.LSMConfig(**kw), spill_dir=dirs[0])
    port = T.LSMTree(T.LSMConfig(**kw), spill_dir=dirs[1], device="cpu")
    ks = 5000
    for op in mutations(gen_ops(4, 1100, ks))[:1100]:
        apply_op(ref, op)
        apply_op(port, op)
    assert port.n_flushes == 0 and port.file_entries < 1100
    import repro.core.lsm as rlsm
    import repro_torch.core.lsm as tlsm
    for mod in (rlsm, tlsm):
        calls = []

        def failing(*a, _real=mod.build_sct, _calls=calls, **k):
            _calls.append(1)
            if len(_calls) == 2:
                raise OSError("disk full")
            return _real(*a, **k)
        monkeypatch.setattr(mod, "build_sct", failing)
    for tree in (ref, port):
        before = set(tree.store.fids())
        with pytest.raises(OSError):
            tree.flush()
        assert set(tree.store.fids()) == before   # the first chunk deleted
        assert len(tree._immutables) == 1
    assert_same_answers(ref, port, ks)
    monkeypatch.undo()
    ref.flush()
    port.flush()
    assert not port._immutables
    assert_same_tree(ref, port)
    assert_same_disk(dirs)


# --------------------------------------------------------------------------- #
# the subprocess kill
# --------------------------------------------------------------------------- #
def test_subprocess_kill_and_restore(tmp_path):
    """Both crash drivers killed by ``os._exit(137)`` at the same site;
    the port's runs with ``--device cpu``.  Both restores recover the same
    seqno and tree, at least the last acknowledged durable seqno."""
    n, seed, key_space = 600, 0, 400
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    spills = []
    for module, extra in (("repro.testing.crash_driver",
                           ["--maintenance", "sync"]),
                          ("repro_torch.testing.crash_driver",
                           ["--device", "cpu"])):
        spill = str(tmp_path / module.split(".")[0])
        os.makedirs(spill)
        proc = subprocess.run(
            [sys.executable, "-m", module, "--spill", spill, "--codec", "opd",
             "--wal", "every", "--point", "flush.before_manifest",
             "--n", str(n), "--seed", str(seed), "--key-space",
             str(key_space)] + extra,
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 137, proc.stderr
        spills.append(spill)
    acks = [json.load(open(os.path.join(s, "ACKS.json"))) for s in spills]
    assert acks[0] == acks[1]
    kw = dict(codec="opd", wal_sync="every", memtable_bytes=8 * 1024,
              file_bytes=16 * 1024, l0_limit=2, size_ratio=3, max_levels=5,
              blob_gc_threshold=0.3, filter_backend="numpy",
              compaction_backend="numpy")
    rb = R.LSMTree.restore(R.LSMConfig(**kw), spills[0])
    pb = T.LSMTree.restore(T.LSMConfig(**kw), spills[1], device="cpu")
    muts = mutations(gen_ops(seed, n, key_space))
    K = pb._seqno
    assert rb._seqno == K and acks[1]["durable_seqno"] <= K <= len(muts)
    assert_same_tree(rb, pb)
    assert assert_same_answers(rb, pb, key_space) == oracle_state(muts, K)
    rb.close()
    pb.close()


# --------------------------------------------------------------------------- #
# background mode: crashes on the writer or on a worker
# --------------------------------------------------------------------------- #
WAIT = 30.0


def _quiesce(tree):
    """Stop the owned scheduler's workers without a planned shutdown: the
    WAL is left as it is (``close`` would sync its tail and defeat the
    power-loss simulation).  The registry is sticky, so a queued job dies
    at its first crash site, like a thread of a killed process."""
    if tree._sched is not None and tree._owns_sched:
        tree._sched.executor.close()


def _ingest_background(tree, ops):
    """Apply ``ops`` until the armed site fires, on the writer's thread or
    on a worker (then raised as ``MaintenanceError`` wrapping the crash);
    a final drain surfaces a crash still pending on a worker."""
    try:
        apply_ops(tree, ops)
        tree.drain(timeout=WAIT)
    except TCrash:
        return True
    except MaintenanceError as e:
        assert isinstance(e.__cause__, TCrash), e
        return True
    return TCRASH.fired is not None


def _answers(tree, engine, key_space):
    res = tree.filter(engine.Predicate("prefix", b"pfx_0"))
    keys, vals = tree.range_lookup(0, key_space)
    gets = [tree.get(k) for k in range(0, key_space, 13)]
    return (res.keys.tolist(), res.values.tolist(), keys.tolist(),
            vals.tolist(), gets)


def check_recovered(back, engine, rkw, ops, floor, key_space):
    """A recovered tree holds a prefix of at least the durable floor: K
    within [floor, issued], the answers of a sync reference tree (the JAX
    engine, WAL off) fed the first K mutations and the oracle's state;
    then the rest of the stream brings it to the whole oracle."""
    muts = mutations(ops)
    K = back._seqno
    assert floor <= K <= len(muts), \
        f"recovered seqno {K} outside [{floor}, {len(muts)}]"
    with R.LSMTree(R.LSMConfig(**dict(rkw, maintenance="sync",
                                      wal_sync="off"))) as ref:
        for op in muts[:K]:
            apply_op(ref, op)
        ref.flush()
        want = _answers(ref, R, key_space)
    got = _answers(back, engine, key_space)
    assert got == want
    assert dict(zip(got[2], got[3])) == oracle_state(muts, K)
    for op in muts[K:]:
        apply_op(back, op)
    back.flush()
    back.drain()
    state = _answers(back, engine, key_space)
    assert dict(zip(state[2], state[3])) == oracle_state(muts, len(muts))
    return K


def background_crash(tmp_path, system, point, wal, backend="numpy", n=900,
                     seed=11):
    rkw, pkw = _kw(system, wal, backend, maintenance="background")
    spill = str(tmp_path / "port")
    ks = _key_space(system)
    ops = gen_ops(seed, n, ks)
    tree = T.LSMTree(T.LSMConfig(**pkw), spill_dir=spill, device="cpu")
    with TCRASH.armed(point):
        fired = _ingest_background(tree, ops)
        floor = tree.wal.durable_seqno
        _quiesce(tree)
        tree.wal.simulate_power_loss()
    assert fired, f"the stream never reached {point}"
    with T.LSMTree.restore(T.LSMConfig(**pkw), spill, device="cpu") as back:
        return check_recovered(back, T, rkw, ops, floor, ks)


FLUSH_COMPACT_POINTS = [p for p in TREE_POINTS
                        if p.startswith(("flush.", "compact."))]
BG_MATRIX = ([("opd", p, "numpy") for p in TREE_POINTS]
             + [("opd", p, "default") for p in FLUSH_COMPACT_POINTS]
             + [("blob", p, "numpy") for p in ("gc.mid_blob",
                                               "gc.after_replace")])


@pytest.mark.parametrize("system,point,backend", BG_MATRIX,
                         ids=["-".join(c) for c in BG_MATRIX])
def test_crash_matrix_background(tmp_path, system, point, backend):
    background_crash(tmp_path, system, point, "group", backend)


@pytest.mark.parametrize("engine", ENGINES)
def test_subprocess_kill_in_background_mode(tmp_path, engine):
    """A crash driver in background mode killed by ``os._exit(137)`` at
    ``flush.before_manifest``, which the flush worker reaches; the
    engine's own restore recovers at least the last acknowledged durable
    seqno and answers as the sync reference tree of its prefix."""
    n, seed, key_space = 600, 0, 400
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    module, extra = {"ref": ("repro.testing.crash_driver", []),
                     "port": ("repro_torch.testing.crash_driver",
                              ["--device", "cpu"])}[engine]
    spill = str(tmp_path / engine)
    os.makedirs(spill)
    proc = subprocess.run(
        [sys.executable, "-m", module, "--spill", spill, "--codec", "opd",
         "--wal", "every", "--maintenance", "background", "--point",
         "flush.before_manifest", "--n", str(n), "--seed", str(seed),
         "--key-space", str(key_space)] + extra,
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 137, proc.stderr
    acks = json.load(open(os.path.join(spill, "ACKS.json")))
    kw = dict(codec="opd", wal_sync="every", memtable_bytes=8 * 1024,
              file_bytes=16 * 1024, l0_limit=2, size_ratio=3, max_levels=5,
              blob_gc_threshold=0.3, filter_backend="numpy",
              compaction_backend="numpy", maintenance="background")
    E = {"ref": R, "port": T}[engine]
    dev = {} if engine == "ref" else {"device": "cpu"}
    with E.LSMTree.restore(E.LSMConfig(**kw), spill, **dev) as back:
        check_recovered(back, E, kw, gen_ops(seed, n, key_space),
                        acks["durable_seqno"], key_space)


def test_workloads_are_the_reference_s():
    assert gen_ops(11, 900, 300) == rwork.gen_ops(11, 900, 300)
    assert value_for(17, 40) == rwork.value_for(17, 40)
