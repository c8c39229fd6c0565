"""The port's sharded engine on disk against the JAX package's, on the CPU.

* One stream into a reference and a port ``ShardedLSM`` with a spill
  directory, splits included, under ``wal_sync`` 'off', 'group' and
  'every' (one worker each): ``SHARDS.json`` equal, every shard's
  ``MANIFEST-<n>.log`` line for line, its ``WAL-<n>-*.wal`` segments byte
  for byte (a retired shard's discarded), the spill file names; then both
  closed and ``ShardedLSM.restore``d, equal to each other shard for shard,
  answering as the oracle, and still writing the same files.
* The sharded crash matrix in sync mode: both engines armed at one
  (point, skip) over one ``gen_ops`` stream fire alike and restore the
  same engine, holding every acknowledged mutation and at most the one in
  flight (``wal_sync='every'``); where no split ran, each shard holds a
  prefix of the mutations routed to it, at least its durable floor.
  ``split.before_table`` comes back with the old, fully backed table.
* The crash matrix in background mode (``tests/test_wal_recovery.py``'s
  sharded cases): the port alone, 4 shards on one scheduler, each restore
  checked against the reference's sync engine fed every shard's recovered
  prefix.
* ``restore`` purges the manifests and WAL segments the table does not
  name, collects orphans over every shard's version (never another
  shard's live files) and round-trips a background engine.
"""

import json
import os

import pytest

import repro.core as R
import repro.shard as RS
import repro_torch.core as T
import repro_torch.shard as TS
from repro.testing.crashpoints import CRASH as RCRASH
from repro.testing.crashpoints import SimulatedCrash as RCrash
from repro_torch.core.maintenance import MaintenanceError
from repro_torch.testing.crashpoints import CRASH as TCRASH
from repro_torch.testing.crashpoints import SimulatedCrash as TCrash
from repro_torch.testing.workload import (apply_op, gen_ops, mutations,
                                          oracle_state)
from test_torch_engine import assert_same_tree

KEY_SPACE = 1200
WAIT = 30.0
REB = dict(split_threshold_bytes=24 * 1024, skew_factor=1.0)


def _kw(codec="opd", wal="every", **extra):
    return dict(dict(codec=codec, value_width=32, memtable_bytes=8 * 1024,
                     file_bytes=16 * 1024, l0_limit=2, size_ratio=3,
                     max_levels=5, blob_gc_threshold=0.3, wal_sync=wal,
                     filter_backend="numpy", compaction_backend="numpy"),
                **extra)


def _pair(tmp_path, n_shards=2, rebalance=True, **kw):
    dirs = [str(tmp_path / e) for e in ("ref", "port")]
    ref = RS.ShardedLSM(
        R.LSMConfig(**_kw(**kw)), n_shards=n_shards, key_max=KEY_SPACE,
        n_workers=1, spill_dir=dirs[0],
        rebalance=RS.RebalanceConfig(**REB) if rebalance else None)
    port = TS.ShardedLSM(
        T.LSMConfig(**_kw(**kw)), n_shards=n_shards, key_max=KEY_SPACE,
        n_workers=1, spill_dir=dirs[1], device="cpu",
        rebalance=TS.RebalanceConfig(**REB) if rebalance else None)
    return ref, port, dirs


def _restore_pair(dirs, **kw):
    return (RS.ShardedLSM.restore(R.LSMConfig(**_kw(**kw)), dirs[0],
                                  n_workers=1),
            TS.ShardedLSM.restore(T.LSMConfig(**_kw(**kw)), dirs[1],
                                  n_workers=1, device="cpu"))


def _files(d, suffix):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(suffix)}


def assert_same_disk(dirs):
    """SHARDS.json, the manifests line for line, the WAL segments byte for
    byte, the same spill file names."""
    tables = [json.load(open(os.path.join(d, "SHARDS.json"))) for d in dirs]
    assert tables[0] == tables[1]
    a, b = (_files(d, ".log") for d in dirs)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].decode().splitlines() == b[name].decode().splitlines()
    a, b = (_files(d, ".wal") for d in dirs)
    assert a == b
    names = [sorted(n for n in os.listdir(d) if n.endswith(".bin"))
             for d in dirs]
    assert names[0] == names[1]
    return tables[1]


def assert_same_engines(ref, port):
    assert ref.router.uppers == port.router.uppers
    assert ref.n_shards == port.n_shards
    for a, b in zip(ref.shards, port.shards):
        assert_same_tree(a, b)
        assert (a._seqno, a.wal_replayed) == (b._seqno, b.wal_replayed)
        assert a.versions.manifest_name == b.versions.manifest_name


def _answers(eng, engine):
    res = eng.filter(engine.Predicate("prefix", b"pfx_0"))
    keys, vals = eng.range_lookup(0, KEY_SPACE - 1)
    gets = [eng.get(k) for k in range(0, KEY_SPACE, 13)]
    return (res.keys.tolist(), res.values.tolist(), keys.tolist(),
            vals.tolist(), gets)


def _state(eng, engine):
    got = _answers(eng, engine)
    return dict(zip(got[2], got[3]))


@pytest.mark.parametrize("wal", ["off", "group", "every"])
def test_spilled_sharded_engine_matches_reference_and_restores(tmp_path,
                                                               wal):
    ref, port, dirs = _pair(tmp_path, wal=wal)
    ops = gen_ops(17, 1800, KEY_SPACE)
    for op in ops:
        apply_op(ref, op)
        apply_op(port, op)
    assert port.n_splits > 0
    assert_same_engines(ref, port)
    table = assert_same_disk(dirs)
    assert len(table["manifests"]) == port.n_shards
    assert table["next_manifest"] == 2 + 2 * port.n_splits
    if wal != "off":
        # a retired shard's segments are gone, the live shards' are there
        prefixes = {n.rsplit("-", 1)[0] for n in os.listdir(dirs[1])
                    if n.endswith(".wal")}
        assert prefixes <= {"WAL-" + m[len("MANIFEST-"):-len(".log")]
                            for m in table["manifests"]}
    assert _answers(ref, R) == _answers(port, T)
    if wal == "off":
        ref.flush()
        port.flush()
    ref.close()
    port.close()
    rb, pb = _restore_pair(dirs, wal=wal)
    assert_same_engines(rb, pb)
    muts = mutations(ops)
    assert _answers(rb, R) == _answers(pb, T)
    assert _state(pb, T) == oracle_state(muts, len(muts))
    # the restored engines keep working, and keep writing the same files
    for op in gen_ops(18, 600, KEY_SPACE):
        apply_op(rb, op)
        apply_op(pb, op)
    rb.flush()
    pb.flush()
    assert_same_engines(rb, pb)
    assert_same_disk(dirs)
    assert _answers(rb, R) == _answers(pb, T)
    rb.close()
    pb.close()


# --------------------------------------------------------------------------- #
# the crash matrix
# --------------------------------------------------------------------------- #
def _ingest(eng, ops, crash_cls, registry, acked=None):
    """Apply ``ops`` until the armed site fires; ``acked`` (a list) gets
    the number of mutations whose call returned."""
    done = 0
    try:
        for op in ops:
            apply_op(eng, op)
            done += op[0] in ("put", "delete")
            if acked is not None:
                acked[:] = [done]
        eng.drain()
    except crash_cls:
        return True
    except MaintenanceError as e:
        assert isinstance(e.__cause__, crash_cls), e
        return True
    return registry.fired is not None


def _per_shard(router, muts):
    per = [[] for _ in range(router.n_shards)]
    for op in muts:
        per[router.shard_of(op[1])].append(op)
    return per


def _prefix_state(back, muts):
    """The oracle of every shard's recovered prefix of the mutations
    routed to it (shards acknowledge independently)."""
    exp = {}
    for i, ops in enumerate(_per_shard(back.router, muts)):
        for op in ops[:back.shards[i]._seqno]:
            if op[0] == "put":
                exp[op[1]] = op[2]
            else:
                exp.pop(op[1], None)
    return exp


SYNC_CASES = [("wal.after_append", 0, False), ("wal.after_sync", 40, False),
              ("flush.mid_spill", 1, False),
              ("flush.before_manifest", 3, False),
              ("flush.after_manifest", 0, False),
              ("compact.mid_spill", 0, False),
              ("compact.before_manifest", 2, False),
              ("compact.after_manifest", 1, False),
              ("flush.before_manifest", 0, True),
              ("split.before_table", 0, True),
              ("split.before_table", 1, True)]


@pytest.mark.parametrize("point,skip,rebalance", SYNC_CASES)
def test_sharded_crash_matrix(tmp_path, point, skip, rebalance):
    ref, port, dirs = _pair(tmp_path, n_shards=4 if not rebalance else 2,
                            rebalance=rebalance)
    ops = gen_ops(13, 1800, KEY_SPACE)
    outcome = []
    for eng, registry, crash_cls in ((ref, RCRASH, RCrash),
                                     (port, TCRASH, TCrash)):
        acked = [0]
        with registry.armed(point, skip=skip):
            fired = _ingest(eng, ops, crash_cls, registry, acked)
            floors = [t.wal.durable_seqno for t in eng.shards]
            for t in eng.shards:
                t.wal.simulate_power_loss()
        outcome.append((fired, floors, eng.n_splits, eng.router.uppers,
                        acked[0]))
    assert outcome[0] == outcome[1]
    fired, floors, n_splits, uppers, acked = outcome[1]
    assert fired, f"the stream never reached {point} (skip {skip})"
    rb, pb = _restore_pair(dirs)
    assert_same_engines(rb, pb)
    assert_same_disk(dirs)
    if point == "split.before_table":
        # the last split never reached the table: its halves are gone and
        # the old shard is back, every file its manifest names present
        assert pb.n_shards == len(uppers) - 1
        assert len(rb.store.fids()) == len(pb.store.fids())
    else:
        assert pb.router.uppers == uppers
        for K, fl in zip([t._seqno for t in pb.shards], floors):
            assert fl <= K
    for t in pb.shards:
        for s in t.versions.current.all_runs():
            assert pb.store.contains(s.file_id)
    muts = mutations(ops)
    assert _answers(rb, R) == _answers(pb, T)
    # 'every' syncs each record: every acknowledged mutation survives,
    # and the one in flight at most besides
    got = _state(pb, T)
    K = acked + (got != oracle_state(muts, acked))
    assert got == oracle_state(muts, K)
    if not n_splits:
        # no shard inherited a seqno: each one holds a prefix of the
        # mutations routed to it
        per = _per_shard(pb.router, muts)
        assert all(t._seqno <= len(p) for t, p in zip(pb.shards, per))
        assert got == _prefix_state(pb, muts)
    # the rest of the stream brings both to the whole oracle
    for op in muts[K:]:
        apply_op(rb, op)
        apply_op(pb, op)
    assert _state(pb, T) == oracle_state(muts, len(muts))
    assert _answers(rb, R) == _answers(pb, T)
    rb.close()
    pb.close()


@pytest.mark.parametrize("point", ["wal.after_append",
                                   "flush.before_manifest",
                                   "compact.after_manifest",
                                   "compact.mid_spill"])
def test_sharded_crash_matrix_background(tmp_path, point):
    """The port alone (where a worker meets the site depends on thread
    timing): 4 shards on the engine's one scheduler, crashed, its pool
    stopped without touching the WALs, restored; each shard a prefix of
    its routed mutations of at least its durable floor, the engine equal
    to the reference's sync engine fed those prefixes."""
    kw = _kw(maintenance="background", filter_backend="fused",
             compaction_backend="jax_packed")
    spill = str(tmp_path / "port")
    eng = TS.ShardedLSM(T.LSMConfig(**kw), n_shards=4, key_max=KEY_SPACE,
                        n_workers=2, spill_dir=spill, device="cpu")
    ops = gen_ops(13, 1200, KEY_SPACE)
    with TCRASH.armed(point):
        fired = _ingest(eng, ops, TCrash, TCRASH)
        floors = [t.wal.durable_seqno for t in eng.shards]
        eng.executor.close()   # the pool, not a planned close
        for t in eng.shards:
            t.wal.simulate_power_loss()
    assert fired, f"the stream never reached {point}"
    back = TS.ShardedLSM.restore(T.LSMConfig(**kw), spill, n_workers=2,
                                 device="cpu")
    try:
        assert back.n_shards == 4
        muts = mutations(ops)
        per = _per_shard(back.router, muts)
        for t, fl, p in zip(back.shards, floors, per):
            assert fl <= t._seqno <= len(p)
        ref = RS.ShardedLSM(R.LSMConfig(**_kw(wal="off")), n_shards=4,
                            key_max=KEY_SPACE, n_workers=1)
        for i, p in enumerate(per):
            for op in p[:back.shards[i]._seqno]:
                apply_op(ref.shards[i], op)
        ref.flush()
        assert _answers(back, T) == _answers(ref, R)
        assert _state(back, T) == _prefix_state(back, muts)
        ref.close()
    finally:
        back.close()


# --------------------------------------------------------------------------- #
# restore's purge and orphan collection
# --------------------------------------------------------------------------- #
def test_restore_purges_unnamed_manifests_and_segments(tmp_path):
    _, port, dirs = _pair(tmp_path, n_shards=2, rebalance=False)
    for op in gen_ops(5, 500, KEY_SPACE):
        apply_op(port, op)
    port.close()
    spill = dirs[1]
    live_fids = set(port.store.fids())
    # leftovers of halves a crashed split allocated but never adopted
    for name in ("MANIFEST-0007.log", "WAL-0007-00000000.wal",
                 "WAL-0008-00000003.wal"):
        with open(os.path.join(spill, name), "w") as f:
            f.write('{"adds": [[1, 999999]]}\n')
    # an orphan SCT of one shard: collected; the other shard's files stay
    orphan = T.LSMTree(T.LSMConfig(**_kw(wal="off")), device="cpu",
                       store=port.store)
    orphan.put(3, b"pfx_orphan")
    orphan.flush()
    (stray,) = [f for f in port.store.fids() if f not in live_fids]
    back = TS.ShardedLSM.restore(T.LSMConfig(**_kw()), spill,
                                 n_workers=1, device="cpu")
    names = set(os.listdir(spill))
    assert not {"MANIFEST-0007.log", "WAL-0007-00000000.wal",
                "WAL-0008-00000003.wal"} & names
    assert {"MANIFEST-0000.log", "MANIFEST-0001.log"} <= names
    assert not back.store.contains(stray)
    for t in back.shards:
        for s in t.versions.current.all_runs():
            assert back.store.contains(s.file_id)
    assert [t.versions.manifest_name for t in back.shards] == \
        ["MANIFEST-0000.log", "MANIFEST-0001.log"]
    muts = mutations(gen_ops(5, 500, KEY_SPACE))
    assert _state(back, T) == oracle_state(muts, len(muts))
    back.close()


def test_background_engine_restore_round_trip(tmp_path):
    """test_maintenance.py's sharded restore: a background engine drained,
    closed and restored answers as before and takes writes."""
    kw = _kw(wal="group", maintenance="background",
             filter_backend="fused", compaction_backend="jax_packed")
    spill = str(tmp_path / "spill")
    eng = TS.ShardedLSM(T.LSMConfig(**kw), n_shards=4, key_max=KEY_SPACE,
                        n_workers=2, spill_dir=spill, device="cpu")
    for op in gen_ops(9, 2000, KEY_SPACE):
        apply_op(eng, op)
    eng.flush()
    eng.drain(timeout=WAIT)
    before = _answers(eng, T)
    uppers = eng.router.uppers
    eng.close()
    back = TS.ShardedLSM.restore(T.LSMConfig(**kw), spill, n_workers=2,
                                 device="cpu")
    try:
        assert back.router.uppers == uppers and back.n_shards == 4
        assert back.scheduler is not None
        with back.scheduler._lock:
            assert len(back.scheduler._trees) == 4
        assert all(t._sched is back.scheduler for t in back.shards)
        assert _answers(back, T) == before
        back.put(5, b"post-restart")
        assert back.get(5) == b"post-restart"
        back.drain(timeout=WAIT)
    finally:
        back.close()


# --------------------------------------------------------------------------- #
# 'blob' value logs shared by the halves of a split, across a restart
# --------------------------------------------------------------------------- #
def _shared_tracked_logs(eng):
    """The value logs that runs of two or more shards point into and that
    some shard's blob manager tracks for GC."""
    refs = {}
    for i, t in enumerate(eng.shards):
        for s in t.versions.current.all_runs():
            if s.vfids is not None:
                for f in set(s.vfids[s.vfids >= 0].tolist()):
                    refs.setdefault(f, set()).add(i)
    shared = {f for f, owners in refs.items() if len(owners) > 1}
    return shared, {f for t in eng.shards for f in t.blob_mgr.live_fids()
                    if f in shared}


def test_blob_restore_across_a_split_keeps_shared_logs(tmp_path):
    """A split's halves point into the old shard's value logs and track
    none of them; a restore must not hand them back to either half's GC.
    Split, close, restore, overwrite one half's every key and compact:
    every key reads back.  (The reference's restore hands every such log
    to each half that points into it: shown here, and in ROADMAP.md.)"""
    ref, port, dirs = _pair(tmp_path, codec="blob", wal="off")
    ops = gen_ops(17, 1800, KEY_SPACE)
    for op in ops:
        apply_op(ref, op)
        apply_op(port, op)
    assert port.n_splits > 0
    for eng in (ref, port):
        eng.flush()
        eng.close()
    rb, pb = _restore_pair(dirs, codec="blob", wal="off")
    shared, tracked = _shared_tracked_logs(pb)
    assert shared and not tracked
    assert _shared_tracked_logs(rb)[1] == shared
    rb.close()
    exp = oracle_state(mutations(ops), len(mutations(ops)))
    assert _state(pb, T) == exp
    tracked = set()   # the logs the overwritten half's GC may collect
    for rnd in range(3):
        for k in range(pb.router.uppers[0]):
            pb.put(k, b"over_%d_%d" % (rnd, k))
            exp[k] = b"over_%d_%d" % (rnd, k)
        pb.compact_all()
        tracked |= set(pb.shards[0].blob_mgr.live_fids())
    assert any(not pb.store.contains(f) for f in tracked)   # GC ran
    assert _state(pb, T) == exp
    for k in range(KEY_SPACE):
        assert pb.get(k) == exp.get(k)
    pb.close()
