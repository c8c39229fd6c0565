"""The engine hooks replication needs, on the port and on the JAX package,
on the CPU.

* The fault registry: the port's ``FaultRegistry`` and the reference's
  agree over random ``inject`` / ``injected`` / ``heal`` schedules (skip,
  count and lag parameters, kills at replica sites among them), and a kill
  armed at a replica site is sticky across every site.
* The WAL tap: it sees exactly the records the WAL holds, in seqno order,
  for ``put``, ``put_batch`` and ``delete`` across memtable rotations, as
  the reference's tap does.
* ``LSMTree.replicate``: duplicates skipped, the gap and unknown-op errors,
  ``_applied == _seqno`` so a follower's snapshot sees every applied row,
  and the follower's WAL, counters and answers equal the reference's.
* ``ShardedLSM.replace_shard``: ``tests/test_replica.py``'s
  ``test_replace_shard_repoints_routing`` on both engines.
"""

import json
import os
import random

import numpy as np
import pytest

import repro.core as R
import repro.shard as RS
import repro_torch.core as T
import repro_torch.shard as TS
from repro.core.wal import WALRecord as RRecord
from repro.testing import crashpoints as RC
from repro.testing import workload as RW
from repro_torch.core.wal import OP_DELETE, OP_PUT, parse_segment
from repro_torch.core.wal import WALRecord as TRecord
from repro_torch.testing import crashpoints as TC
from repro_torch.testing import workload as TW

VW = 32
KEY_SPACE = 160


def _kw(**extra):
    return dict(dict(codec="opd", value_width=VW, memtable_bytes=8 * 1024,
                     file_bytes=16 * 1024, l0_limit=2, size_ratio=3,
                     max_levels=5, wal_sync="group", filter_backend="numpy",
                     compaction_backend="numpy"), **extra)


def _trees(tmp_path, **extra):
    return (R.LSMTree(R.LSMConfig(**_kw(**extra)),
                      spill_dir=str(tmp_path / "ref")),
            T.LSMTree(T.LSMConfig(**_kw(**extra)),
                      spill_dir=str(tmp_path / "port"), device="cpu"))


def _reads(tree, engine):
    snap = tree.snapshot()
    f = tree.filter(engine.Predicate("prefix", b"pfx_01"), snapshot=snap)
    k, v = tree.range_lookup(0, KEY_SPACE, snapshot=snap)
    return (snap.seqno, f.keys.tolist(), f.values.tolist(), k.tolist(),
            v.tolist(), [tree.get(i, snapshot=snap) for i in range(KEY_SPACE)])


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (RC.FAULTS, TC.FAULTS):
        f.disarm()
        f.heal()
    yield
    for f in (RC.FAULTS, TC.FAULTS):
        f.disarm()
        f.heal()


# ---------------------------------------------------------------------- #
# the fault registry
# ---------------------------------------------------------------------- #
def test_fault_tables_and_aliases_match_the_reference():
    for name in ("CRASH_POINTS", "REPLICA_FAULT_SITES", "FAULT_SITES",
                 "FAULT_KINDS"):
        assert getattr(TC, name) == getattr(RC, name), name
    assert TC.CrashPointRegistry is TC.FaultRegistry
    assert TC.FAULTS is TC.CRASH
    assert isinstance(TC.CRASH, TC.FaultRegistry)


@pytest.mark.parametrize("call", [
    lambda m: m.FaultRegistry().inject("ship.send", kind="drop"),
    lambda m: m.FaultRegistry().inject("nowhere", kind="lag", seqnos=3),
    lambda m: m.FaultRegistry().inject("nowhere", kind="kill"),
    lambda m: m.FaultRegistry().arm("nowhere"),
    lambda m: m.FaultRegistry().arm("ship.send", action="hang"),
])
def test_registry_refuses_alike(call):
    msgs = []
    for m in (RC, TC):
        with pytest.raises(ValueError) as e:
            call(m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _registry_trace(mod, seed, n_steps=300):
    """One random schedule on a fresh registry of ``mod``: what each call
    returned or raised, and the registry's state after it."""
    reg = mod.FaultRegistry()
    rng = random.Random(seed)
    out = []
    for _ in range(n_steps):
        r = rng.random()
        site = rng.choice(mod.FAULT_SITES)
        try:
            if r < 0.25:
                kind = rng.choice(("partition", "lag"))
                count = rng.choice((None, 1, 2, 4))
                reg.inject(rng.choice(mod.REPLICA_FAULT_SITES), kind=kind,
                           skip=rng.randrange(4), count=count,
                           seqnos=rng.randrange(1, 20))
                res = "injected"
            elif r < 0.3:
                reg.inject(rng.choice(mod.REPLICA_FAULT_SITES), kind="kill",
                           skip=rng.randrange(6))
                res = "armed"
            elif r < 0.65:
                f = reg.injected(rng.choice(mod.REPLICA_FAULT_SITES))
                res = None if f is None else (f.kind, f.skip, f.count,
                                              f.params, f.hits, f.fired)
            elif r < 0.8:
                reg.reached(site)
                res = "passed"
            elif r < 0.88:
                reg.heal(rng.choice((None, site)))
                res = "healed"
            elif r < 0.93:
                reg.disarm()
                res = "disarmed"
            else:
                with reg.injected_at(rng.choice(mod.REPLICA_FAULT_SITES),
                                     kind="lag", seqnos=5) as g:
                    f = g.injected("ship.send")
                    res = None if f is None else (f.kind, f.params)
        except mod.SimulatedCrash as e:
            res = ("crash", str(e))
        out.append((res, reg.fired, dict(reg.hits), reg._crashed,
                    reg._armed))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_registries_agree_over_random_schedules(seed):
    got = _registry_trace(TC, seed)
    assert got == _registry_trace(RC, seed)
    assert any(r[0] not in (None, "passed", "healed", "disarmed",
                            "injected", "armed") for r in got)


@pytest.mark.parametrize("site", TC.REPLICA_FAULT_SITES)
def test_kill_at_a_replica_site_is_sticky(site):
    reg = TC.FAULTS
    reg.inject("ship.send", kind="lag", seqnos=4)
    reg.inject(site, kind="kill", skip=1)
    if site == "ship.send":
        assert TC.fault_at(site).params == {"seqnos": 4}  # the skipped hit
    else:
        TC.crashpoint(site)
    with pytest.raises(TC.SimulatedCrash):
        TC.fault_at(site) if site == "ship.send" else TC.crashpoint(site)
    assert reg.fired == site
    for other in TC.FAULT_SITES:   # the "process" is dead everywhere
        with pytest.raises(TC.SimulatedCrash):
            TC.crashpoint(other)
        with pytest.raises(TC.SimulatedCrash):
            TC.fault_at(other)
    reg.disarm()
    TC.crashpoint(site)
    assert TC.fault_at("ship.send").kind == "lag"
    reg.heal()
    assert TC.fault_at("ship.send") is None


# ---------------------------------------------------------------------- #
# the WAL tap
# ---------------------------------------------------------------------- #
def _tap_stream(tree, rng_seed=5):
    rng = np.random.default_rng(rng_seed)
    for i in range(40):
        tree.put(int(rng.integers(KEY_SPACE)), TW.value_for(i))
    for b in range(3):
        keys = rng.integers(0, KEY_SPACE, 250).astype(np.uint64)
        vals = np.asarray([TW.value_for(1000 * b + i) for i in range(250)],
                          f"S{VW}")
        tree.put_batch(keys, vals)
        for k in rng.integers(0, KEY_SPACE, 15).tolist():
            tree.delete(k)


@pytest.mark.parametrize("maintenance", ["sync", "background"])
def test_wal_tap_sees_every_record_the_wal_holds(tmp_path, maintenance):
    trees = _trees(tmp_path, maintenance=maintenance)
    taps = []
    for t in trees:
        seen = []
        t.wal.tap = lambda *rec, seen=seen: seen.append(rec)
        t.wal.truncate_upto = lambda seqno: None   # keep every segment
        _tap_stream(t)
        t.drain()
        taps.append(seen)
    ref_tap, port_tap = taps
    assert port_tap == ref_tap
    assert trees[1].wal.rotations >= 3
    assert [r[1] for r in port_tap] == list(range(1, trees[1]._seqno + 1))
    assert {r[0] for r in port_tap} == {OP_PUT, OP_DELETE}
    d = trees[1].store.spill_dir
    on_disk = []
    trees[1].close()
    for name in sorted(n for n in os.listdir(d) if n.endswith(".wal")):
        with open(os.path.join(d, name), "rb") as f:
            recs, _, clean = parse_segment(f.read())
        assert clean
        on_disk += [(r.op, r.seqno, r.key, r.value) for r in recs]
    assert on_disk == port_tap
    trees[0].close()


# ---------------------------------------------------------------------- #
# LSMTree.replicate
# ---------------------------------------------------------------------- #
def _records(rec_cls, n=400, seed=9):
    muts = RW.mutations(RW.gen_ops(seed=seed, n=n, key_space=KEY_SPACE))
    return [rec_cls(OP_PUT, i + 1, m[1], m[2]) if m[0] == "put"
            else rec_cls(OP_DELETE, i + 1, m[1]) for i, m in enumerate(muts)]


def _applied(t):
    """The port's snapshot watermark; the reference's snapshots read
    ``_seqno``."""
    return getattr(t, "_applied", t._seqno)


def _follower_state(t):
    return (t._seqno, _applied(t), t.n_flushes, t.n_compactions,
            t.ingest_bytes, t.wal.appends, t.wal.syncs, t.wal.durable_seqno,
            t.wal.rotations)


def test_replicate_applies_skips_duplicates_and_refuses_gaps(tmp_path):
    trees = _trees(tmp_path)
    for t, rec_cls, eng in zip(trees, (RRecord, TRecord), (R, T)):
        recs = _records(rec_cls)
        assert t.replicate(recs[:150]) == 150
        assert t.replicate(recs[:260]) == 110       # the first 150 skipped
        assert t.replicate(recs[100:200]) == 0      # all duplicates
        with pytest.raises(ValueError, match="replication gap"):
            t.replicate(recs[300:310])
        with pytest.raises(ValueError, match="unknown WAL op"):
            t.replicate([rec_cls(7, 261, 1, b"x")])
    ref, port = trees
    assert str(_gap(ref, RRecord)) == str(_gap(port, TRecord))
    assert port._seqno == port._applied == 260
    assert port.n_flushes > 0
    assert _follower_state(port) == _follower_state(ref)
    # a follower snapshot sees every replicated row
    assert port.snapshot().seqno == 260
    state = TW.oracle_state(TW.mutations(
        TW.gen_ops(seed=9, n=400, key_space=KEY_SPACE)), 260)
    assert {k: port.get(k) for k in range(KEY_SPACE)} == {
        k: state.get(k) for k in range(KEY_SPACE)}
    assert _reads(port, T) == _reads(ref, R)
    for t in trees:
        t.close()


def _gap(tree, rec_cls):
    try:
        tree.replicate([rec_cls(OP_PUT, tree._seqno + 5, 1, b"x")])
    except ValueError as e:
        return e
    raise AssertionError("no gap error")


def test_replicated_follower_restores_its_applied_prefix(tmp_path):
    """A follower's WAL carries the leader's seqnos: closed and restored,
    it comes back at its applied watermark with the same answers, on both
    engines."""
    trees = _trees(tmp_path)
    for t, rec_cls in zip(trees, (RRecord, TRecord)):
        t.replicate(_records(rec_cls)[:333])
        t.close()
    ref = R.LSMTree.restore(R.LSMConfig(**_kw()), str(tmp_path / "ref"))
    port = T.LSMTree.restore(T.LSMConfig(**_kw()), str(tmp_path / "port"),
                             device="cpu")
    assert port._seqno == port._applied == ref._seqno == 333
    assert port.wal_replayed == ref.wal_replayed
    assert _reads(port, T) == _reads(ref, R)
    for t in (ref, port):
        t.close()


def test_kill_mid_replicate_leaves_a_prefix(tmp_path):
    trees = _trees(tmp_path)
    got = []
    for t, rec_cls, mod in zip(trees, (RRecord, TRecord), (RC, TC)):
        mod.FAULTS.arm("apply.record", skip=37)
        with pytest.raises(mod.SimulatedCrash):
            t.replicate(_records(rec_cls)[:100])
        with pytest.raises(mod.SimulatedCrash):   # sticky
            mod.crashpoint("wal.after_sync")
        mod.FAULTS.disarm()
        got.append((t._seqno, _applied(t), t.wal.appends,
                    t.wal.durable_seqno))
    assert got[1] == got[0] == (37, 37, 37, got[0][3])


# ---------------------------------------------------------------------- #
# ShardedLSM.replace_shard
# ---------------------------------------------------------------------- #
def _replace(eng_mod, tree_mod, tmp_path, wal, maintenance, dev):
    cfg = tree_mod.LSMConfig(**_kw(wal_sync=wal, maintenance=maintenance))
    eng = eng_mod.ShardedLSM(cfg, n_shards=2, key_max=KEY_SPACE,
                             spill_dir=str(tmp_path / "eng"), **dev)
    ops = RW.gen_ops(seed=37, n=240, key_space=KEY_SPACE)
    for op in ops:
        RW.apply_op(eng, op)
    eng.drain()
    pred = tree_mod.Predicate("prefix", b"pfx_01")
    before = eng.filter(pred)
    i = 1
    lo, hi = eng.router.bounds(i)
    stand_in = tree_mod.LSMTree(cfg, spill_dir=str(tmp_path / "promoted"),
                                **dev)
    for op in RW.mutations(ops):
        if lo <= op[1] < hi:
            RW.apply_op(stand_in, op)
    stand_in.flush()
    table = open(tmp_path / "eng" / "SHARDS.json").read()
    wals = sorted(n for n in os.listdir(tmp_path / "eng")
                  if n.endswith(".wal"))
    rep0 = eng.shape_report()
    old = eng.replace_shard(i, stand_in)
    assert old is not eng.shards[i] and eng.shards[i] is stand_in
    after = eng.filter(pred)
    assert after.keys.tolist() == before.keys.tolist()
    assert after.values.tolist() == before.values.tolist()
    rep1 = eng.shape_report()
    assert rep1["n_flushes"] >= rep0["n_flushes"]
    # the table is not rewritten and the old tree's WAL is not discarded
    assert open(tmp_path / "eng" / "SHARDS.json").read() == table
    assert sorted(n for n in os.listdir(tmp_path / "eng")
                  if n.endswith(".wal")) == wals
    if eng.scheduler is not None:
        assert all(t is not old for t in eng.scheduler._trees)
    counts = {k: v for k, v in eng._retired_counts.items()
              if not k.endswith("seconds")}
    stages = {k: dict(v.counts) for k, v in getattr(
        eng, "_engine_stages", getattr(eng, "_retired_stages", None)).items()}
    out = (before.keys.tolist(), before.values.tolist(),
           after.keys.tolist(), rep0["n_flushes"], rep1["n_flushes"],
           counts, stages, json.loads(table), wals,
           [eng.get(k) for k in range(KEY_SPACE)])
    old.close()
    eng.close()
    return out


@pytest.mark.parametrize("maintenance", ["sync", "background"])
@pytest.mark.parametrize("wal", ["off", "group"])
def test_replace_shard_repoints_routing(tmp_path, wal, maintenance):
    want = _replace(RS, R, tmp_path / "ref", wal, maintenance, {})
    got = _replace(TS, T, tmp_path / "port", wal, maintenance,
                   {"device": "cpu"})
    assert got[:3] == want[:3]
    assert got[7:] == want[7:]
    if maintenance == "sync":   # a background stand-in flushes on a worker
        assert got[3:7] == want[3:7]
