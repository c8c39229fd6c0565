"""The compaction-policy axis of the port against the JAX engine, on the CPU.

Ports every case of ``tests/test_policy.py`` but the sharded ones.  The
reference runs on its 'numpy' filter and compaction backends; the port on
its own defaults, 'fused' and 'jax_packed' (the plain versions of
``fused_zone_filter``, ``unpack_codes``, ``remap_pack_codes`` and
``pack_codes`` on the CPU), so the kernels' paths read stacked levels of
overlapping runs and merge whole levels.  The trees hold no kernel state
that depends on the backends, so they must be the same SCT for SCT:

* bit identity: each policy x codec in sync mode (the tree after every
  flush and compaction, stacked levels in their run order, and every
  read), and each policy on 'opd' in background mode (the reads after
  ``drain``), all equal to the reference's leveled baseline;
* shape: tiering stacks runs where leveling never does, the lazy-leveled
  bottom stays one run, the throttle's gates float with the tiered
  trigger, tombstones survive a merge beside a stacked run;
* migration: a snapshot pinned across ``set_policy`` reads the same; a
  crash inside a migration merge restores the reference's tree, run order
  included; after a tiered -> leveled migration the live tree re-sorts the
  level and a restored one keeps the replay order, on both engines;
* tuning: ``PolicyTuner``'s decisions equal the reference's on the same
  stream (round trip, hysteresis, ``min_ops``), in sync mode and from the
  background compaction worker;
* validation, ``describe``, ``mode``, ``l0_trigger``, ``run_depth`` and
  the configuration values either engine takes.
"""

import dataclasses
import itertools
import os
import time

import numpy as np
import pytest

import repro.core as R
import repro.core.policy as RP
import repro_torch.core as T
import repro_torch.core.policy as TP
from repro.query import AggSpec as RAggSpec
from repro.testing.crashpoints import CRASH as RCRASH
from repro.testing.crashpoints import SimulatedCrash as RCrash
from repro_torch.core.maintenance import THROTTLE_NONE
from repro_torch.query import AggSpec as TAggSpec
from repro_torch.testing.crashpoints import CRASH as TCRASH
from repro_torch.testing.crashpoints import SimulatedCrash as TCrash
from repro_torch.testing.workload import (apply_op, gen_ops, mutations,
                                          oracle_state, value_for)
from test_torch_engine import assert_same_tree

VW = 24
KEY_SPACE = 900
PRED = ("prefix", b"pfx_0", b"")
PREDS = [PRED, ("prefix", b"pfx_01", b""),
         ("range", b"pfx_010", b"pfx_030"), ("eq", b"pfx_007", b"")]
CODECS = ["opd", "plain", "heavy", "blob"]
POLICIES = {
    "leveled": dict(compaction_policy="leveled"),
    "tiered": dict(compaction_policy="tiered", tier_runs=3),
    "lazy_leveled": dict(compaction_policy="lazy_leveled", tier_runs=3),
    "hybrid": dict(compaction_policy="hybrid",
                   level_modes=("L", "T", "T", "L", "L")),
}
OPS = gen_ops(11, 1200, KEY_SPACE)
SPECS = [("count", None), ("sum", None), ("min", None), ("max", None),
         ("sum", PRED)]
WAIT = 60   # seconds any background wait may take


def _kw(codec="opd", mode="sync", **extra):
    return dict(codec=codec, value_width=VW, memtable_bytes=8 * 1024,
                file_bytes=16 * 1024, l0_limit=2, size_ratio=3, max_levels=5,
                blob_gc_threshold=0.3, maintenance=mode, **extra)


def _ref(codec="opd", mode="sync", **extra):
    return R.LSMTree(R.LSMConfig(**_kw(codec, mode, **extra),
                                 filter_backend="numpy",
                                 compaction_backend="numpy"))


def _port(codec="opd", mode="sync", **extra):
    return T.LSMTree(T.LSMConfig(**_kw(codec, mode, **extra)), device="cpu")


def _fingerprint(tree, engine, snap=None):
    """Everything a reader observes, as plain Python values."""
    tree.drain(**({"timeout": WAIT} if engine is T else {}))
    specs = [(RAggSpec if engine is R else TAggSpec)(
        op, pred=None if p is None else engine.Predicate(*p))
        for op, p in SPECS]
    got = tree.filter_many([engine.Predicate(*p) for p in PREDS],
                           snapshot=snap)
    ka, va = tree.range_lookup(0, KEY_SPACE, snapshot=snap)
    aggs = [(r.op, r.count, r.total, r.min_value, r.max_value)
            for r in tree.aggregate_many(specs, snapshot=snap)]
    gets = [tree.get(k, snapshot=snap) for k in range(0, KEY_SPACE, 7)]
    return ([(r.keys.tolist(), r.values.tolist()) for r in got],
            ka.tolist(), va.tolist(), aggs, gets)


def _same_counters(ref, port):
    assert (ref.ingest_bytes, ref.n_policy_switches) == \
        (port.ingest_bytes, port.n_policy_switches)
    sa, sb = ref.shape_report(), port.shape_report()
    for k in ("policy", "n_policy_switches", "n_retunes"):
        assert sa[k] == sb[k], k


def _run_pair(ops, ref, port, check_every_state=True):
    """``ops`` into both trees; the trees compared after every flush and
    compaction (sync mode)."""
    done = set()
    for op in ops:
        apply_op(ref, op)
        apply_op(port, op)
        if not check_every_state:
            continue
        state = (port.n_flushes, port.n_compactions)
        assert (ref.n_flushes, ref.n_compactions) == state
        if state not in done:
            done.add(state)
            assert_same_tree(ref, port)
    return len(done)


_BASE = {}


def _baseline(codec):
    """The reference's leveled sync tree: the policy axis must not move a
    read."""
    if codec not in _BASE:
        with _ref(codec) as t:
            for op in OPS:
                apply_op(t, op)
            t.flush()
            _BASE[codec] = _fingerprint(t, R)
    return _BASE[codec]


CELLS = ([(kind, codec, "sync") for kind in POLICIES for codec in CODECS]
         + [(kind, "opd", "background") for kind in POLICIES])


@pytest.mark.parametrize("kind,codec,mode", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_policy_bit_identity(kind, codec, mode):
    """Sync mode: the port's tree equals the reference's after every flush
    and compaction, and its reads equal the leveled baseline.  Background
    mode (shapes follow thread timing): the reads after ``drain``."""
    with _ref(codec, "sync", **POLICIES[kind]) as ref, \
            _port(codec, mode, **POLICIES[kind]) as port:
        states = _run_pair(OPS, ref, port, check_every_state=mode == "sync")
        ref.flush()
        port.flush()
        got = _fingerprint(port, T)
        assert got == _fingerprint(ref, R) == _baseline(codec), kind
        assert ref.ingest_bytes == port.ingest_bytes
        if mode == "sync":
            assert states > 10
            assert_same_tree(ref, port)
            _same_counters(ref, port)


# --------------------------------------------------------------------------- #
# shape
# --------------------------------------------------------------------------- #
def _shuffled_ingest(trees, n=3000, batch=250, seed=5):
    """Both trees take the same shuffled batches, each flushed; the trees
    compared after every flush; returns the peak run depth below L0."""
    ref, port = trees
    rng = np.random.default_rng(seed)
    keys = rng.permutation(n).astype(np.uint64)
    vals = np.array([value_for(i, VW) for i in range(n)], f"S{VW}")
    peak = 0
    for lo in range(0, n, batch):
        for t in trees:
            t.put_batch(keys[lo:lo + batch], vals[lo:lo + batch])
            t.flush()
        assert_same_tree(ref, port)
        depths = port.shape_report()["run_depths"]
        peak = max(peak, max(depths[1:], default=0))
    return peak


def test_tiered_levels_stack_runs_leveled_never():
    with _ref(compaction_policy="tiered", tier_runs=4) as ref, \
            _port(compaction_policy="tiered", tier_runs=4) as port:
        peak = _shuffled_ingest((ref, port))
        assert 1 < peak <= 4
        assert port.shape_report()["policy"] == "tiered,K=4"
        ref.compact()
        port.compact()
        assert_same_tree(ref, port)
        assert max(port.shape_report()["run_depths"][1:]) <= 3
        assert _fingerprint(port, T) == _fingerprint(ref, R)
    with _ref() as ref, _port() as port:
        assert _shuffled_ingest((ref, port)) <= 1


def test_lazy_leveled_bottom_stays_single_run():
    kw = dict(compaction_policy="lazy_leveled", tier_runs=3)
    with _ref(**kw) as ref, _port(**kw) as port:
        _shuffled_ingest((ref, port), n=4000)
        ref.compact()
        port.compact()
        assert_same_tree(ref, port)
        depths = port.shape_report()["run_depths"]
        assert max(depths[1:3]) > 1     # the upper levels stack
        assert all(d <= 1 for d in depths[port.cfg.max_levels - 2:])


def test_throttle_gates_float_with_tiered_trigger():
    """A tiered L0 holds K-1 runs: the slowdown and stop gates keep their
    offsets above the policy's trigger (7 here), on both engines."""
    kw = dict(compaction_policy="tiered", tier_runs=8)
    with _ref(mode="background", **kw) as ref, \
            _port(mode="background", **kw) as port:
        for i in range(6):
            keys = np.arange(i * 50, i * 50 + 50).astype(np.uint64)
            vals = np.array([value_for(i * 50 + j, VW) for j in range(50)],
                            f"S{VW}")
            for t, wait in ((ref, {}), (port, {"timeout": WAIT})):
                t.put_batch(keys, vals)
                t.flush()
                t.drain(**wait)
        n_l0 = len(port.versions.current.levels[0])
        assert n_l0 == len(ref.versions.current.levels[0]) == 6
        assert n_l0 >= port.cfg.l0_slowdown_trigger
        assert port._throttle_level() == ref._throttle_level() \
            == THROTTLE_NONE
        assert (port.write_slowdowns, port.write_stalls) == (0, 0)


def test_tombstones_survive_a_merge_beside_a_stacked_run():
    """Tiered L0 -> L1 merges stack; a delete merged into L1 while an older
    stacked run there still holds the key must keep its tombstone."""
    kw = dict(compaction_policy="tiered", tier_runs=3)
    with _ref(**kw) as ref, _port(**kw) as port:
        for t in (ref, port):
            t.put_batch(np.arange(200, dtype=np.uint64),
                        np.array([value_for(i, VW) for i in range(200)],
                                 f"S{VW}"))
            t.compact()                     # stacked run 1 (bottom: no tombs)
            for k in range(0, 200, 5):
                t.delete(k)
            # a put beside the deletes: the reference's range scan cannot
            # decode a run of tombstones only (ROADMAP §3)
            t.put(1000, value_for(1000, VW))
            t.compact()                     # stacked run 2 beside run 1
        assert_same_tree(ref, port)
        l1 = port.levels[1]
        assert len(l1) == 2 and port.shape_report()["run_depths"][1] == 2
        assert int(l1[0].tombs.sum()) == 40 and not l1[1].tombs.any()
        assert all(port.get(k) is None for k in range(0, 200, 5))
        assert _fingerprint(port, T) == _fingerprint(ref, R)


# --------------------------------------------------------------------------- #
# migration
# --------------------------------------------------------------------------- #
def test_snapshot_pinned_across_policy_migration():
    with _ref() as ref, _port() as port:
        _run_pair(OPS, ref, port)
        ref.flush()
        port.flush()
        snaps = (ref.snapshot(), port.snapshot())
        want = _fingerprint(port, T, snaps[1])
        assert want == _fingerprint(ref, R, snaps[0])
        # leveled -> tiered: new writes land in stacked runs
        for engine, t in ((R, ref), (T, port)):
            t.set_policy(engine.CompactionPolicy(kind="tiered", tier_runs=3))
        _run_pair(gen_ops(13, 300, KEY_SPACE), ref, port)
        for t in (ref, port):
            t.flush()
            t.compact()
        assert_same_tree(ref, port)
        assert max(port.shape_report()["run_depths"][1:]) > 1
        # tiered -> leveled: the next merges fold the stacks back down
        for engine, t in ((R, ref), (T, port)):
            t.set_policy(engine.CompactionPolicy(kind="leveled"))
            t.compact()
        assert_same_tree(ref, port)
        _same_counters(ref, port)
        assert port.shape_report()["n_policy_switches"] == 2
        assert max(port.shape_report()["run_depths"][1:]) <= 1
        assert _fingerprint(port, T, snaps[1]) == want
        assert _fingerprint(port, T) == _fingerprint(ref, R)


@pytest.mark.parametrize("kind", ["leveled", "tiered", "lazy_leveled"])
def test_set_policy_with_its_own_size_ratio(kind):
    """A policy's own T (the tuner's knob) sets the level capacities; the
    trees stay equal through the switch, after every flush and
    compaction."""
    with _ref() as ref, _port() as port:
        _run_pair(OPS[:600], ref, port)
        for engine, t in ((R, ref), (T, port)):
            t.set_policy(engine.CompactionPolicy(kind=kind, size_ratio=2,
                                                 tier_runs=2))
        assert [port.level_capacity(i) for i in range(4)] == \
            [ref.level_capacity(i) for i in range(4)] == \
            [16 * 1024 * 2 ** i for i in range(4)]
        _run_pair(OPS[600:] + [("compact",)], ref, port)
        assert_same_tree(ref, port)
        _same_counters(ref, port)
        assert _fingerprint(port, T) == _fingerprint(ref, R)


MIGRATION_CRASH_POINTS = [
    "compact.mid_spill", "compact.before_manifest", "compact.after_manifest"]


def _armed_run(tree, engine, registry, crash_cls, point, ops, tail):
    """``ops``, then a tiered policy on the leveled tree and ``tail`` with
    ``point`` armed -> (fired, the WAL's durable floor)."""
    for op in ops:
        apply_op(tree, op)
    tree.set_policy(engine.CompactionPolicy(kind="tiered", tier_runs=3))
    with registry.armed(point):
        try:
            for op in tail:
                apply_op(tree, op)
        except crash_cls:
            pass
        fired = registry.fired == point
        floor = tree.wal.durable_seqno
        tree.wal.simulate_power_loss()
    return fired, floor


def _same_restored(rb, pb, muts):
    assert_same_tree(rb, pb)
    assert rb._seqno == pb._seqno and rb.wal_replayed == pb.wal_replayed
    got = _fingerprint(pb, T)
    assert got == _fingerprint(rb, R)
    k, v = pb.range_lookup(0, KEY_SPACE)
    assert dict(zip(k.tolist(), map(bytes, v))) == \
        oracle_state(muts, pb._seqno)


@pytest.mark.parametrize("point", MIGRATION_CRASH_POINTS)
def test_crash_during_policy_migration(tmp_path, point):
    """A crash inside a migration merge (a tiered policy freshly set on a
    leveled tree): both engines armed at ``point`` restore the same tree,
    the stacked edits replayed in the reference's run order, at an
    acknowledged prefix; each then finishes the migration and keeps
    writing, and the two stay equal."""
    ops = gen_ops(29, 350, KEY_SPACE)
    tail = gen_ops(31, 150, KEY_SPACE) + [("flush",), ("compact",)]
    dirs = [str(tmp_path / e) for e in ("ref", "port")]
    ref = R.LSMTree(R.LSMConfig(**_kw(wal_sync="every"),
                                filter_backend="numpy",
                                compaction_backend="numpy"),
                    spill_dir=dirs[0])
    port = T.LSMTree(T.LSMConfig(**_kw(wal_sync="every")),
                     spill_dir=dirs[1], device="cpu")
    outcome = [_armed_run(ref, R, RCRASH, RCrash, point, ops, tail),
               _armed_run(port, T, TCRASH, TCrash, point, ops, tail)]
    assert outcome[0] == outcome[1] and outcome[1][0], outcome
    floor = outcome[1][1]
    assert_same_tree(ref, port)
    muts = mutations(ops + tail)
    rb = R.LSMTree.restore(R.LSMConfig(**_kw(wal_sync="every"),
                                       filter_backend="numpy",
                                       compaction_backend="numpy"), dirs[0])
    pb = T.LSMTree.restore(T.LSMConfig(**_kw(wal_sync="every")), dirs[1],
                           device="cpu")
    assert floor <= pb._seqno <= len(muts)
    _same_restored(rb, pb, muts)
    for engine, t in ((R, rb), (T, pb)):
        t.set_policy(engine.CompactionPolicy(kind="tiered", tier_runs=3))
        t.flush()
        t.compact()
    _same_restored(rb, pb, muts)
    for t in (rb, pb):
        t.put(0, value_for(0))
    assert pb.get(0) == rb.get(0) == value_for(0)
    rb.close()
    pb.close()


def test_restored_order_after_tiered_to_leveled_follows_the_reference(
        tmp_path):
    """Two stacked L1 runs A (keys 0-99) and then B (500-599), then a
    leveled fold of keys 200-299 into L1: the live tree re-sorts L1 to
    [A, C, B]; a replay keeps a level that ever took a stacked run in its
    replay order, [B, A, C].  The port follows the reference on both
    sides."""
    dirs = [str(tmp_path / e) for e in ("ref", "port")]
    kw = _kw(compaction_policy="tiered", tier_runs=3)
    ref = R.LSMTree(R.LSMConfig(**kw, filter_backend="numpy",
                                compaction_backend="numpy"),
                    spill_dir=dirs[0])
    port = T.LSMTree(T.LSMConfig(**kw), spill_dir=dirs[1], device="cpu")
    for engine, t in ((R, ref), (T, port)):
        for i, lo in enumerate((0, 500, 200)):
            if i == 2:
                t.set_policy(engine.CompactionPolicy(kind="leveled"))
            keys = np.arange(lo, lo + 100, dtype=np.uint64)
            t.put_batch(keys, np.array([value_for(int(k), VW) for k in keys],
                                       f"S{VW}"))
            t.compact()
    assert_same_tree(ref, port)
    live = [s.min_key for s in port.levels[1]]
    assert live == [0, 200, 500]
    want = _fingerprint(port, T)
    assert want == _fingerprint(ref, R)
    ref.close()
    port.close()
    rb = R.LSMTree.restore(R.LSMConfig(**kw, filter_backend="numpy",
                                       compaction_backend="numpy"), dirs[0])
    pb = T.LSMTree.restore(T.LSMConfig(**kw), dirs[1], device="cpu")
    assert_same_tree(rb, pb)
    assert [s.min_key for s in pb.levels[1]] == [500, 0, 200]
    assert _fingerprint(pb, T) == want
    with open(os.path.join(dirs[1], "MANIFEST.log")) as f:
        assert sum('"stacked": [1]' in line for line in f) == 2


# --------------------------------------------------------------------------- #
# online tuning
# --------------------------------------------------------------------------- #
def _same_decisions(ref, port):
    assert port.tuner.history == [
        TP.TuneDecision(**dataclasses.asdict(d)) for d in ref.tuner.history]
    assert (port.tuner.n_retunes, port.tuner.n_switches) == \
        (ref.tuner.n_retunes, ref.tuner.n_switches)
    assert port.policy.describe() == ref.policy.describe()
    _same_counters(ref, port)


def test_tuner_write_heavy_then_scan_heavy_round_trip():
    """A write-only window moves the tuner off leveling, a scan-only window
    back to it; every decision equal to the reference's."""
    with _ref(policy_autotune=True) as ref, \
            _port(policy_autotune=True) as port:
        rng = np.random.default_rng(7)
        for lo in range(0, 6000, 500):
            keys = rng.integers(0, KEY_SPACE, 500).astype(np.uint64)
            vals = np.array([value_for(lo + j, VW) for j in range(500)],
                            f"S{VW}")
            for t in (ref, port):
                t.put_batch(keys, vals)
        for t in (ref, port):
            t.flush()
            t.compact()
        assert_same_tree(ref, port)
        _same_decisions(ref, port)
        assert port.tuner.n_retunes >= 1
        assert port.policy.kind in ("tiered", "lazy_leveled")
        assert port.shape_report()["n_policy_switches"] >= 1
        for engine, t in ((R, ref), (T, port)):
            for _ in range(100):
                t.filter(engine.Predicate(*PRED))
            t.compact()
        assert_same_tree(ref, port)
        _same_decisions(ref, port)
        assert port.policy.kind == "leveled"
        assert port.shape_report()["n_retunes"] == port.tuner.n_retunes
        assert _fingerprint(port, T) == _fingerprint(ref, R)


def test_tuner_hysteresis_holds_on_mixed_window():
    with _ref(policy_autotune=True) as ref, \
            _port(policy_autotune=True) as port:
        ref.tuner.hysteresis = 0.0     # nothing undercuts by 100 %
        port.tuner.HYSTERESIS = 0.0    # (the port's is a class constant)
        for t in (ref, port):
            for lo in range(0, 2000, 500):
                keys = np.arange(lo, lo + 500).astype(np.uint64)
                t.put_batch(keys, np.array(
                    [value_for(lo + j, VW) for j in range(500)], f"S{VW}"))
            t.flush()
            t.compact()
        _same_decisions(ref, port)
        assert port.tuner.n_retunes >= 1 and port.tuner.n_switches == 0
        assert port.policy.kind == "leveled"


def test_tuner_min_ops_gate_skips_empty_windows():
    with _ref(policy_autotune=True) as ref, \
            _port(policy_autotune=True) as port:
        for t in (ref, port):
            t.put(1, value_for(1))
            t.flush()
            assert t.tuner.maybe_retune(t) is None   # one put << 64 ops
            assert t.tuner.n_retunes == 0


def test_background_compaction_worker_retunes():
    """In background mode the compaction worker calls the tuner once the
    debt is zero, as the reference's does: a write-only stream leaves the
    leveled policy."""
    with _port("opd", "background", policy_autotune=True) as port:
        for op in mutations(OPS):
            apply_op(port, op)
        port.flush()
        port.drain(timeout=WAIT)
        assert port._sched.n_bg_compactions > 0
        # the worker retunes after it leaves the in-flight set, so drain
        # may return just before the call
        deadline = time.monotonic() + WAIT
        while port.tuner.n_retunes == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert port.tuner.n_retunes >= 1
        assert port.tuner.history[0].old == "leveled"
        assert port.tuner.history[0].w_scan == 0.0
        with _ref(policy_autotune=True) as ref:
            for op in mutations(OPS):
                apply_op(ref, op)
            ref.flush()
            assert _fingerprint(port, T) == _fingerprint(ref, R)


# --------------------------------------------------------------------------- #
# validation, describe, run_depth, configuration values
# --------------------------------------------------------------------------- #
def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


POLICY_ARGS = list(itertools.product(
    ("leveled", "tiered", "lazy_leveled", "hybrid", "nope"),
    (None, 6), (1, 2, 3, 8),
    (None, (), ("L",), ("T",), ("L", "T", "L"), ("T", "T", "L", "L"),
     ("L", "X"))))


def test_policy_validation_and_describe():
    """``tests/test_policy.py``'s cases on the port, then every policy of a
    grid: the same ``ValueError`` where the reference raises, else the
    same ``describe``, ``mode`` at each level and ``l0_trigger``."""
    for kwargs in (dict(kind="nope"), dict(kind="hybrid"),
                   dict(kind="tiered", tier_runs=1),
                   dict(kind="hybrid", level_modes=("L", "X"))):
        with pytest.raises(ValueError):
            TP.CompactionPolicy(**kwargs)
    p = TP.CompactionPolicy(kind="hybrid", level_modes=("L", "T", "L"),
                            size_ratio=6, tier_runs=3)
    assert p.describe() == "hybrid,T=6,K=3,LTL"
    assert p.mode(1, 5) == "T" and p.mode(4, 5) == "L"
    assert TP.make_policy(T.LSMConfig(**POLICIES["lazy_leveled"])).kind \
        == "lazy_leveled"
    n_ok = 0
    for kind, ratio, k, modes in POLICY_ARGS:
        kw = dict(kind=kind, size_ratio=ratio, tier_runs=k,
                  level_modes=modes)
        a = _outcome(lambda: RP.CompactionPolicy(**kw))
        b = _outcome(lambda: TP.CompactionPolicy(**kw))
        assert a[0] == b[0] and (a[0] == "ok" or a[1] == b[1]), kw
        if a[0] == "ok":
            n_ok += 1
            ra, pb = a[1], b[1]
            assert ra.describe() == pb.describe()
            assert ra.ratio(10) == pb.ratio(10)
            for lim in (1, 2, 4, 9):
                assert ra.l0_trigger(lim) == pb.l0_trigger(lim)
            for max_levels in (3, 5, 7):
                assert [ra.mode(i, max_levels) for i in range(1, 7)] == \
                    [pb.mode(i, max_levels) for i in range(1, 7)]
    assert n_ok > 50


def test_config_takes_every_policy_value_the_reference_takes():
    """``LSMConfig`` takes a (compaction_policy, tier_runs, level_modes,
    policy_autotune) combination exactly when the reference's tree does,
    and raises the reference's message where the reference's
    ``make_policy`` raises."""
    for kind, _ratio, k, modes in POLICY_ARGS:
        if kind == "nope":
            continue
        for auto in (False, True):
            kw = dict(compaction_policy=kind, tier_runs=k, level_modes=modes,
                      policy_autotune=auto)
            a = _outcome(lambda: R.LSMTree(R.LSMConfig(**kw)).policy)
            b = _outcome(lambda: T.LSMTree(T.LSMConfig(**kw),
                                           device="cpu").policy)
            assert a[0] == b[0], kw
            if a[0] == "ok":
                assert a[1].describe() == b[1].describe()
            else:
                assert a[1] == b[1]
    with pytest.raises(ValueError):
        R.LSMTree(R.LSMConfig(compaction_policy="nope"))
    with pytest.raises(ValueError, match="compaction_policy='nope'"):
        T.LSMConfig(compaction_policy="nope")
    tree = T.LSMTree(T.LSMConfig(policy_autotune=True), device="cpu")
    assert isinstance(tree.tuner, TP.PolicyTuner)
    assert T.LSMTree(T.LSMConfig(), device="cpu").tuner is None


def test_run_depth_counts_interval_overlap():
    class Run:
        def __init__(self, lo, hi, n=1):
            self.min_key, self.max_key, self.n = lo, hi, n

    cases = {(): 0, ((0, 5), (6, 9)): 1, ((0, 5), (5, 9)): 2,
             ((0, 9), (2, 5), (4, 8)): 3, ((0, 9, 0), (2, 3)): 1}
    for spans, want in cases.items():
        runs = [Run(*s) for s in spans]
        assert TP.run_depth(runs) == RP.run_depth(runs) == want
    rng = np.random.default_rng(3)
    for _ in range(200):
        lo = rng.integers(0, 50, int(rng.integers(0, 8)))
        runs = [Run(int(a), int(a + rng.integers(0, 20)),
                    int(rng.integers(0, 2))) for a in lo]
        assert TP.run_depth(runs) == RP.run_depth(runs)


def test_tuner_candidates_match_the_reference():
    """The hill-climb neighbourhood of each policy the tuner can reach,
    and the gates the port keeps as class constants."""
    rt, pt = RP.PolicyTuner(), TP.PolicyTuner()
    assert (pt.MIN_OPS, pt.HYSTERESIS, pt.KINDS) == \
        (rt.min_ops, rt.hysteresis, tuple(rt.kinds))
    for kind in ("leveled", "tiered", "lazy_leveled"):
        for ratio in (None, 4, 8, 14):
            for k in (2, 4, 8):
                cur = dict(kind=kind, size_ratio=ratio, tier_runs=k)
                a = [c.describe() for c in
                     rt.candidates(RP.CompactionPolicy(**cur), 10)]
                b = [c.describe() for c in
                     pt.candidates(TP.CompactionPolicy(**cur), 10)]
                assert a == b, cur
