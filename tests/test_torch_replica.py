"""The port's replication against the JAX package's, on the CPU.

Every tier-1 schedule of ``tests/test_replica.py`` runs through
``repro.replica.ReplicatedShard`` and through the port's (``device='cpu'``,
where each kernel wrapper runs its plain version): tracking, bounded
staleness, round-robin, partition / heal, lag, leader kill + promote, a
stale promote dropping a divergent peer, follower kill + restore, a crash
at each ``promote.*`` site then ``ReplicatedShard.restore``, kill mid-ship,
kill mid-apply, the strict policy with a dead leader, the EPOCH file and
a ``ScanServer`` across a promote.  Both groups take the same ``gen_ops``
streams, and each schedule arms the same faults on its own package's
registry.

Each schedule records what it observes: in sync mode the whole
``replication_report()`` at each of its checkpoints, every answer (filter,
``range_lookup``, ``aggregate_many``, a get of every key, all at one
pinned snapshot) and the values it asserts on.  The port's record must
equal the reference's, and every answer the test holds against the
acknowledged prefix must equal the reference's ``_fresh_prefix`` oracle
(a sync reference tree without a WAL fed that prefix).  In background mode
the trees' shapes follow thread timing, so the reports keep the seqno
bookkeeping (epoch, leader, head, watermarks, dead replicas), and answers
are read after ``drain`` only, as the reference's schedules read them.

The reference and the port run with ('numpy', 'numpy') backends, as the
reference's ``_cfg`` pins them; the port also runs under its defaults
('fused' filter, 'jax_packed' compaction), where the record must be the
same.
"""

import json
import os
import types

import pytest

import repro.core as R
import repro.query as RQ
import repro.replica as RR
import repro_torch.core as T
import repro_torch.query as TQ
import repro_torch.replica as TR
from repro.serving.scan_server import ScanServer as RServer
from repro.testing import crashpoints as RC
from repro.testing import workload as RW
from repro_torch.core.maintenance import MaintenanceError
from repro_torch.serving.scan_server import ScanServer as TServer
from repro_torch.testing import crashpoints as TC
from repro_torch.testing import workload as TW

VW = 32
KEY_SPACE = 160
PRED = ("prefix", b"pfx_01")   # buckets 010-019 of value_for's 60

REF = types.SimpleNamespace(
    name="ref", core=R, query=RQ, replica=RR, faults=RC.FAULTS,
    crash=RC.SimulatedCrash, server=RServer, work=RW, dev={},
    backends=dict(filter_backend="numpy", compaction_backend="numpy"))
PORT = types.SimpleNamespace(
    name="port", core=T, query=TQ, replica=TR, faults=TC.FAULTS,
    crash=TC.SimulatedCrash, server=TServer, work=TW, dev={"device": "cpu"},
    backends=dict(filter_backend="numpy", compaction_backend="numpy"))
PORT_DEFAULTS = types.SimpleNamespace(**dict(vars(PORT), backends={}))
PORTS = {"numpy": PORT, "defaults": PORT_DEFAULTS}


def _aggs(pkg):
    A, G, P = pkg.query.AggSpec, pkg.query.GroupBy, pkg.core.Predicate
    return [A("count"),
            A("count", pred=P("range", b"pfx_01", b"pfx_04")),
            A("sum", pred=P(*PRED)),
            A("min"), A("max"),
            A("group_count", group=G("prefix", prefix_len=6))]


def _cfg(pkg, mode="sync", wal="group", **kw):
    base = dict(codec="opd", value_width=VW, memtable_bytes=8 * 1024,
                file_bytes=16 * 1024, l0_limit=2, size_ratio=3,
                max_levels=5, maintenance=mode, wal_sync=wal)
    base.update(pkg.backends)
    base.update(kw)
    return pkg.core.LSMConfig(**base)


def _group(pkg, root, mode="sync", n_followers=2, **kw):
    return pkg.replica.ReplicatedShard(_cfg(pkg, mode), root,
                                       n_followers=n_followers, **pkg.dev,
                                       **kw)


def _restore(pkg, cfg, root):
    return pkg.replica.ReplicatedShard.restore(cfg, root, **pkg.dev)


def answers(x, pkg):
    """Every read of a tree or a group, at one pinned snapshot."""
    snap = x.snapshot()
    f = x.filter(pkg.core.Predicate(*PRED), snapshot=snap)
    k, v = x.range_lookup(0, KEY_SPACE, snapshot=snap)
    aggs = x.aggregate_many(_aggs(pkg), snapshot=snap)
    gets = [x.get(i, snapshot=snap) for i in range(KEY_SPACE)]
    return (f.keys.tolist(), f.values.tolist(), k.tolist(), v.tolist(),
            [(a.value, a.groups) for a in aggs], gets)


def oracle(muts, k):
    """The reference's ``_fresh_prefix``: a sync reference tree without a
    WAL fed exactly the first k mutations, and its answers."""
    ref = R.LSMTree(_cfg(REF, "sync", wal="off"))
    for op in muts[:k]:
        RW.apply_op(ref, op)
    ref.flush()
    out = answers(ref, REF)
    ref.close()
    return out


_BG_KEYS = ("epoch", "leader", "head_seqno", "watermarks", "dead")


class Record:
    """What one schedule observed, in order."""

    def __init__(self, pkg, mode):
        self.pkg, self.mode, self.items = pkg, mode, []

    def report(self, grp):
        rep = grp.replication_report()
        if self.mode == "background":
            rep = {k: rep[k] for k in _BG_KEYS}
        self.items.append(("report", rep))

    def prefix(self, x, muts, k):
        """``x`` answers as the acknowledged prefix ``muts[:k]``."""
        got = answers(x, self.pkg)
        assert got == oracle(muts, k)
        self.items.append(("prefix", k, got))

    def same(self, a, b):
        """Two replicas of one group answer alike."""
        got = answers(a, self.pkg)
        assert got == answers(b, self.pkg)
        self.items.append(("same", got))

    def value(self, *v):
        self.items.append(("value",) + v)


def _abandon(grp):
    """Coordinator death: quiesce the surviving workers without a planned
    shutdown (no WAL sync: the on-disk state stays as it crashed)."""
    for i, t in grp.replicas.items():
        if not grp.is_dead(i) and t._sched is not None and t._owns_sched:
            t._sched.executor.close()


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
# the schedules of tests/test_replica.py, on either package
# ---------------------------------------------------------------------- #
def s_track(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    for op in pkg.work.gen_ops(seed=3, n=300, key_space=KEY_SPACE):
        pkg.work.apply_op(grp, op)
    grp.drain()
    rec.report(grp)
    rep = grp.replication_report()
    assert set(rep["watermarks"].values()) == {rep["head_seqno"]}
    for i in grp.live_followers():
        rec.same(grp.replicas[i], grp.leader)
    grp.close()


def s_staleness(pkg, root, mode, rec):
    grp = _group(pkg, root, mode,
                 read_policy=pkg.replica.ReadPolicy(max_lag_seqnos=8))
    ops = pkg.work.gen_ops(seed=5, n=200, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    for op in ops:
        pkg.work.apply_op(grp, op)
    grp.drain()
    for _ in range(4):
        s = grp.snapshot()
        assert s.follower and s.lag == 0
    grp.links[1].partition()
    for op in muts[:20]:
        pkg.work.apply_op(grp, op)
    s = grp.snapshot()
    rec.value(s.replica, s.lag, s.follower, s.seqno)
    assert s.replica == 2 and s.lag == 0
    grp.links[2].lag_seqnos = 5
    for op in muts[20:30]:
        pkg.work.apply_op(grp, op)
    s = grp.snapshot()
    rec.value(s.replica, s.lag, s.follower, s.seqno)
    assert s.replica == 2 and 0 < s.lag <= 8
    grp.links[2].lag_seqnos = 50
    for op in muts[30:90]:
        pkg.work.apply_op(grp, op)
    s = grp.snapshot()
    rec.value(s.replica, s.lag, s.follower, s.seqno)
    assert not s.follower and s.lag == 0
    c = grp.read_stats.counts
    assert c["follower_reads"] >= 6 and c["leader_reads"] >= 1
    assert c["read_lag_max"] <= 8
    rec.report(grp)
    grp.links[1].heal()
    grp.links[2].lag_seqnos = 0
    grp.pump()
    grp.drain()
    rec.report(grp)
    for i in (1, 2):
        rec.same(grp.replicas[i], grp.leader)
    grp.close()


def s_round_robin(pkg, root, mode, rec):
    grp = _group(pkg, root, mode, n_followers=3)
    for i in range(40):
        grp.put(i, pkg.work.value_for(i))
    grp.drain()
    seen = [grp.snapshot().replica for _ in range(12)]
    rec.value(seen)
    assert set(seen) == {1, 2, 3}
    rec.report(grp)
    grp.close()


def s_partition(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    ops = pkg.work.gen_ops(seed=7, n=300, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    for op in ops[:100]:
        pkg.work.apply_op(grp, op)
    frozen = grp.replicas[1]._seqno
    with pkg.faults.injected_at("ship.send", kind="partition"):
        for op in ops[100:200]:
            pkg.work.apply_op(grp, op)
        assert grp.replicas[1]._seqno == frozen
        assert grp.replicas[2]._seqno == frozen
        rec.report(grp)
    for op in ops[200:]:
        pkg.work.apply_op(grp, op)
    grp.pump()
    grp.drain()
    rec.report(grp)
    assert grp.links[1].resumes >= 1
    for i in (1, 2):
        rec.prefix(grp.replicas[i], muts, grp.leader._seqno)
    grp.close()


def s_lag(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    with pkg.faults.injected_at("ship.send", kind="lag", seqnos=16):
        for i in range(100):
            grp.put(i % KEY_SPACE, pkg.work.value_for(i))
        for i in (1, 2):
            lag = grp.leader._seqno - grp.replicas[i]._seqno
            assert 0 < lag <= 16
        rec.report(grp)
    grp.pump()
    assert all(grp.replicas[i]._seqno == grp.leader._seqno for i in (1, 2))
    rec.report(grp)
    grp.close()


def s_leader_kill(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    ops = pkg.work.gen_ops(seed=11, n=300, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    for op in ops:
        pkg.work.apply_op(grp, op)
    grp.links[2].lag_seqnos = 23
    for i in range(60):
        grp.put((7 * i) % KEY_SPACE, pkg.work.value_for(1000 + i))
        muts.append(("put", (7 * i) % KEY_SPACE, pkg.work.value_for(1000 + i)))
    grp.kill_leader()
    assert grp.snapshot().follower
    best = grp.best_follower()
    assert best == 1
    w = grp.promote(best)
    rec.value(w)
    assert w == len(muts)
    grp.drain()
    rec.report(grp)
    rec.prefix(grp, muts, w)
    assert not grp.is_dead(2)
    grp.links[2].lag_seqnos = 0
    grp.pump()
    grp.drain()
    rec.prefix(grp.replicas[2], muts, w)
    grp.put(3, b"pfx_000_post")
    assert grp.replicas[2]._seqno == grp.leader._seqno
    rec.report(grp)
    grp.close()


def s_stale_promote(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    ops = pkg.work.gen_ops(seed=13, n=250, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    for op in ops[:150]:
        pkg.work.apply_op(grp, op)
    grp.links[1].partition()
    stale_at = grp.replicas[1]._seqno
    for op in ops[150:]:
        pkg.work.apply_op(grp, op)
    grp.kill_leader()
    w = grp.promote(1)
    rec.value(w)
    assert w == stale_at
    assert grp.is_dead(2) and grp.n_divergent_dropped == 1
    grp.drain()
    rec.report(grp)
    rec.prefix(grp, muts, w)
    grp.resync_follower(2)
    grp.pump()
    grp.drain()
    rec.report(grp)
    rec.prefix(grp.replicas[2], muts, w)
    grp.close()


def s_follower_kill(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    ops = pkg.work.gen_ops(seed=17, n=300, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    third = len(ops) // 3
    for op in ops[:third]:
        pkg.work.apply_op(grp, op)
    grp.kill_follower(2)
    for op in ops[third:]:
        pkg.work.apply_op(grp, op)
    assert grp.log.floor <= grp._ack_floor[2]
    rec.report(grp)
    grp.restore_follower(2)
    grp.pump()
    grp.drain()
    rec.report(grp)
    rec.prefix(grp.replicas[2], muts, grp.leader._seqno)
    grp.close()


def _crash_promote(site):
    def sched(pkg, root, mode, rec):
        cfg = _cfg(pkg, mode)
        grp = pkg.replica.ReplicatedShard(cfg, root, n_followers=2, **pkg.dev)
        ops = pkg.work.gen_ops(seed=23, n=250, key_space=KEY_SPACE)
        muts = pkg.work.mutations(ops)
        for op in ops:
            pkg.work.apply_op(grp, op)
        grp.kill_leader()
        pkg.faults.arm(site)
        with pytest.raises(pkg.crash):
            grp.promote(1)
        pkg.faults.disarm()
        _abandon(grp)
        back = _restore(pkg, cfg, root)
        committed = site != "promote.before_seal"
        assert back.epoch == (2 if committed else 1)
        assert back.leader_idx == (1 if committed else 0)
        w = back.leader._seqno
        assert w <= len(muts)
        back.drain()
        rec.report(back)
        rec.prefix(back, muts, w)
        back.put(5, b"pfx_000_post")
        for i in back.live_followers():
            assert back.replicas[i]._seqno == back.leader._seqno
        w2 = back.promote(back.best_follower())
        assert w2 == back.leader._seqno
        back.drain()
        rec.report(back)
        back.close()
    return sched


def s_kill_mid_ship(pkg, root, mode, rec):
    cfg = _cfg(pkg, mode)
    grp = pkg.replica.ReplicatedShard(cfg, root, n_followers=2, **pkg.dev)
    ops = pkg.work.gen_ops(seed=29, n=220, key_space=KEY_SPACE)
    muts = pkg.work.mutations(ops)
    fired = False
    pkg.faults.arm("ship.send", skip=150)
    try:
        for op in ops:
            pkg.work.apply_op(grp, op)
    except pkg.crash:
        fired = True
    pkg.faults.disarm()
    assert fired
    rec.report(grp)
    _abandon(grp)
    back = _restore(pkg, cfg, root)
    back.drain()
    rec.report(back)
    rec.prefix(back, muts, back.leader._seqno)
    back.close()


def s_kill_mid_apply(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    pkg.faults.arm("apply.record", skip=80)
    fired = False
    try:
        for i in range(100):
            grp.put(i % KEY_SPACE, pkg.work.value_for(i))
    except pkg.crash:
        fired = True
    pkg.faults.disarm()
    assert fired
    rec.report(grp)
    hurt = min((i for i in grp.links), key=lambda i: grp.replicas[i]._seqno)
    rec.value(hurt)
    grp.kill_follower(hurt)
    for i in range(100, 140):
        grp.put(i % KEY_SPACE, pkg.work.value_for(i))
    grp.resync_follower(hurt)
    grp.pump()
    grp.drain()
    rec.report(grp)
    rec.same(grp.replicas[hurt], grp.leader)
    grp.close()


def s_strict(pkg, root, mode, rec):
    grp = _group(pkg, root, mode,
                 read_policy=pkg.replica.ReadPolicy(max_lag_seqnos=0))
    for i in range(30):
        grp.put(i, pkg.work.value_for(i))
    grp.links[1].partition()
    grp.links[2].partition()
    for i in range(30, 60):
        grp.put(i, pkg.work.value_for(i))
    grp.kill_leader()
    with pytest.raises(pkg.replica.ReplicationLag) as lag:
        grp.snapshot()
    with pytest.raises(RuntimeError) as dead:
        grp.put(0, b"x")
    rec.value(str(lag.value), str(dead.value))
    rec.value(grp.promote(grp.best_follower()))
    s = grp.snapshot()
    rec.value(s.replica, s.lag, s.follower)
    rec.report(grp)
    grp.close()


def s_epoch_file(pkg, root, mode, rec):
    grp = _group(pkg, root, mode)
    path = os.path.join(root, pkg.replica.EPOCH_FILE)
    with open(path) as f:
        meta = json.load(f)
    assert meta == {"epoch": 1, "leader": 0, "watermark": 0}
    for i in range(20):
        grp.put(i, pkg.work.value_for(i))
    grp.promote(1)
    with open(path) as f:
        meta2 = json.load(f)
    assert meta2 == {"epoch": 2, "leader": 1, "watermark": 20}
    rec.value(pkg.replica.EPOCH_FILE, meta, meta2)
    rec.report(grp)
    grp.close()


def s_scan_server(pkg, root, mode, rec):
    grp = _group(pkg, root, mode,
                 read_policy=pkg.replica.ReadPolicy(max_lag_seqnos=0))
    for op in pkg.work.gen_ops(seed=31, n=260, key_space=KEY_SPACE):
        pkg.work.apply_op(grp, op)
    grp.drain()
    srv = pkg.server(grp, max_batch=4, maintenance="sync")
    P, A = pkg.core.Predicate, pkg.query.AggSpec
    preds = [P("prefix", b"pfx_0%d" % i) for i in range(6)]
    rids = srv.submit_many(preds)
    arid = srv.submit_agg(A("count"))
    out = srv.drain()
    direct = grp.leader.filter_many(preds)
    got = [(out[r].keys.tolist(), out[r].values.tolist()) for r in rids]
    assert got == [(d.keys.tolist(), d.values.tolist()) for d in direct]
    assert out[arid].value == grp.leader.aggregate(A("count")).value
    assert grp.read_stats.counts["follower_reads"] >= 1
    rec.value(got, out[arid].value, srv.stats.batch_sizes)
    grp.kill_leader()
    grp.promote(grp.best_follower())
    rids2 = srv.submit_many(preds)
    out2 = srv.drain()
    got2 = [(out2[r].keys.tolist(), out2[r].values.tolist()) for r in rids2]
    assert got2 == got
    rec.value(got2, srv.stats.batch_sizes)
    rec.report(grp)
    grp.close()


SCHEDULES = {
    "track-sync": (s_track, "sync"),
    "track-background": (s_track, "background"),
    "staleness": (s_staleness, "sync"),
    "round_robin": (s_round_robin, "sync"),
    "partition-sync": (s_partition, "sync"),
    "partition-background": (s_partition, "background"),
    "lag": (s_lag, "sync"),
    "leader_kill-sync": (s_leader_kill, "sync"),
    "leader_kill-background": (s_leader_kill, "background"),
    "stale_promote": (s_stale_promote, "sync"),
    "follower_kill-sync": (s_follower_kill, "sync"),
    "follower_kill-background": (s_follower_kill, "background"),
    "kill_mid_ship": (s_kill_mid_ship, "sync"),
    "kill_mid_apply": (s_kill_mid_apply, "sync"),
    "strict": (s_strict, "sync"),
    "epoch_file": (s_epoch_file, "sync"),
    "scan_server": (s_scan_server, "sync"),
}
for _site in RC.REPLICA_FAULT_SITES[2:]:
    for _mode in ("sync", "background"):
        SCHEDULES[f"crash@{_site}-{_mode}"] = (_crash_promote(_site), _mode)


def run(sched, pkg, root, mode):
    rec = Record(pkg, mode)
    sched(pkg, root, mode, rec)
    return rec.items


@pytest.mark.parametrize("port", sorted(PORTS))
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_reference(tmp_path, name, port):
    sched, mode = SCHEDULES[name]
    want = run(sched, REF, str(tmp_path / "ref"), mode)
    got = run(sched, PORTS[port], str(tmp_path / "port"), mode)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a == b, (i, a[0])


@pytest.mark.parametrize("mode", ["sync", "background"])
def test_group_is_built_and_restored_on_its_device(tmp_path, mode):
    """Every replica, a restored follower, a resynced one and a restored
    group's trees take the group's device."""
    root = str(tmp_path)
    grp = _group(PORT, root, mode)
    for i in range(50):
        grp.put(i, TW.value_for(i))
    grp.kill_follower(2)
    grp.restore_follower(2)
    grp.kill_leader()
    grp.promote(1)
    grp.resync_follower(0)
    grp.drain()
    trees = list(grp.replicas.values())
    grp.close()
    back = _restore(PORT, _cfg(PORT, mode), root)
    trees += list(back.replicas.values())
    assert str(grp.device) == str(back.device) == "cpu"
    assert all(t.device == grp.device for t in trees)
    assert all(s.packed.device.type == "cpu"
               for t in trees for s in t.all_runs())
    back.close()


def test_read_only_caller_leaves_a_worker_failure_for_the_writer(tmp_path):
    """``raise_maintenance_errors(consume=False)`` passes ``consume`` to
    every live replica: the failure stays recorded for the next write."""
    grp = _group(PORT, str(tmp_path), "background")
    boom = RuntimeError("flush worker failed")
    for t in grp.replicas.values():
        t._sched._errors.append(boom)
    for _ in range(2):
        with pytest.raises(MaintenanceError):
            grp.raise_maintenance_errors(consume=False)
    assert all(t._sched._errors == [boom] for t in grp.replicas.values())
    with pytest.raises(MaintenanceError):
        grp.put(1, b"v")             # the leader's write consumes its own
    for _ in grp.live_followers():   # then one follower's a call
        with pytest.raises(MaintenanceError):
            grp.raise_maintenance_errors()
    grp.raise_maintenance_errors()   # nothing left
    grp.close()


def test_replicated_wal_off_is_refused_alike(tmp_path):
    msgs = []
    for pkg in (REF, PORT):
        with pytest.raises(ValueError) as e:
            pkg.replica.ReplicatedShard(_cfg(pkg, wal="off"),
                                        str(tmp_path / pkg.name), **pkg.dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

