"""The port's background maintenance against the JAX package's, on the CPU.

Following ``tests/test_maintenance.py``, for one tree (the sharded cases
come with scale-out):

* background equals sync at every ``drain`` barrier: one seeded stream
  into the reference in sync mode, the reference in background mode and
  the port in background mode, for the harness's five systems ('opd',
  'plain', 'heavy', 'blob', 'blob' + ``blob_compress`` as 'blob_zstd') on
  'numpy' backends and for 'opd' on the port's defaults ('fused',
  'jax_packed'); filter, range_lookup and gets on one snapshot must be the
  same in all three (tree shapes may differ);
* readers on their own threads during background flushes, compactions and
  blob GC, with the reference's oracle checks, and the drained end state
  equal to the reference's;
* the graduated throttle (slowdown, then stop) and sync mode without it;
* a failing flush worker: raised as ``MaintenanceError`` on the writer's
  next write, on ``drain`` and on ``ScanServer.step``, leaking no spill
  file, the memtable queued and readable; a kernel wrapper raising on the
  flush worker arrives with that error as the cause, and nothing falls
  back;
* the snapshot race: a flush installing between a snapshot's two reads
  never loses rows;
* a background-mode manifest round trip, two trees on one scheduler, the
  ``ScanServer`` knob and the executor.

Every threaded wait is bounded: ``drain(timeout=30)``, and each thread
joined with a timeout and checked dead; every tree in background mode is
closed, so no pool outlives its test.
"""

import threading
import time

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.serving.scan_server import ScanServer as RServer
from repro_torch import ScanServer
from repro_torch.core.maintenance import (MaintenanceError,
                                          MaintenanceScheduler)
from repro_torch.core.memtable import MemTable
from repro_torch.shard import ShardExecutor

VW = 32
WAIT = 30.0
SYSTEMS = {"opd": dict(codec="opd"), "plain": dict(codec="plain"),
           "heavy": dict(codec="heavy"), "blob": dict(codec="blob"),
           "blob_zstd": dict(codec="blob", blob_compress=True)}
NUMPY = dict(filter_backend="numpy", compaction_backend="numpy")


def _kw(system="opd", mode="background", **extra):
    base = dict(value_width=VW, file_bytes=32 * 1024, l0_limit=2,
                size_ratio=3, max_levels=5, maintenance=mode,
                **SYSTEMS[system])
    base.update(extra)
    return base


def _ref(system="opd", mode="background", **extra):
    return R.LSMTree(R.LSMConfig(**_kw(system, mode, **NUMPY, **extra)))


def _port(system="opd", mode="background", backend="numpy", **extra):
    kw = _kw(system, mode, **extra)
    if backend == "numpy":
        kw.update(NUMPY)
    return T.LSMTree(T.LSMConfig(**kw), device="cpu")


def _val(i):
    return (b"pfx_%03d_" % (i % 60)) + b"x" * 10


def _apply_ops(tree, rng, n, key_space=3000):
    for _ in range(n):
        k = int(rng.integers(0, key_space))
        if rng.random() < 0.12:
            tree.delete(k)
        else:
            tree.put(k, _val(int(rng.integers(0, 900))))


def _probe(tree, engine, rng, key_space=3000):
    """filter, range_lookup and 64 gets against one snapshot."""
    snap = tree.snapshot()
    res = tree.filter(engine.Predicate("prefix", b"pfx_0"), snapshot=snap)
    keys, vals = tree.range_lookup(100, key_space // 2, snapshot=snap)
    gets = [tree.get(int(k), snap) for k in rng.integers(0, key_space, 64)]
    return (res.keys.tolist(), res.values.tolist(), keys.tolist(),
            vals.tolist(), gets)


def _barriers(tree, engine, n_rounds=4, n_ops=1500):
    """The stream in rounds, each ended by a drain and a probe, then a
    flush, a drain and a last probe."""
    rng_ops = np.random.default_rng(7)
    rng_probe = np.random.default_rng(8)
    points = []
    for _ in range(n_rounds):
        _apply_ops(tree, rng_ops, n_ops)
        tree.drain(timeout=WAIT) if engine is T else tree.drain()
        points.append(_probe(tree, engine, rng_probe))
    tree.flush()
    tree.drain(timeout=WAIT) if engine is T else tree.drain()
    points.append(_probe(tree, engine, rng_probe))
    return points


def _state(tree, key_space=3000):
    keys, vals = tree.range_lookup(0, key_space)
    return {int(k): bytes(v) for k, v in zip(keys, vals)}


# --------------------------------------------------------------------------- #
# background == sync at every drain barrier
# --------------------------------------------------------------------------- #
CASES = [(s, "numpy") for s in SYSTEMS] + [("opd", "default")]


@pytest.mark.parametrize("system,backend", CASES,
                         ids=["-".join(c) for c in CASES])
def test_background_equals_sync_at_every_drain(system, backend):
    obs = {}
    with _ref(system, "sync") as t:
        obs["ref-sync"] = _barriers(t, R)
    with _ref(system, "background") as t:
        obs["ref-background"] = _barriers(t, R)
    with _port(system, "background", backend) as t:
        obs["port-background"] = _barriers(t, T)
        assert t._sched.n_bg_flushes > 0 and t._sched.n_bg_compactions > 0
        assert t._pending_flushes() == 0 and t._compaction_debt() == 0.0
        assert t.shape_report()["maintenance"] == "background"
    assert obs["port-background"] == obs["ref-sync"]
    assert obs["ref-background"] == obs["ref-sync"]


# --------------------------------------------------------------------------- #
# readers on their own threads during maintenance
# --------------------------------------------------------------------------- #
def _start(threads):
    for th in threads:
        th.start()


def _join(threads):
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive(), "a thread outlived its wait"


@pytest.mark.parametrize("system", ["opd", "blob"])
def test_concurrent_readers_during_maintenance(system):
    """Readers (a snapshot, a filter, gets) run while the writer ingests
    enough for background flushes, compactions and (for 'blob') GC; every
    result is sorted and unique and holds only written values, and the
    drained end state equals the oracle's and the reference's."""
    errors = []
    stop = threading.Event()
    history = {}   # key -> values ever written (grows only)
    lock = threading.Lock()
    with _port(system, "background", blob_gc_threshold=0.3) as t:

        def reader(seed):
            rng = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    snap = t.snapshot()
                    res = t.filter(T.Predicate("prefix", b"pfx_0"),
                                   snapshot=snap)
                    ks = res.keys.tolist()
                    assert ks == sorted(set(ks)), "unsorted or repeated keys"
                    with lock:
                        hist = {k: set(vs) for k, vs in history.items()}
                    for k, v in zip(ks[:50], res.values[:50]):
                        assert bytes(v) in hist.get(k, ()), \
                            f"filter returned a value never written to {k}"
                    for k in rng.integers(0, 3000, 32):
                        got = t.get(int(k), snap)
                        if got is not None:
                            assert got in hist.get(int(k), ()), \
                                "get returned a value never written"
            except BaseException as e:   # raised on the main thread
                errors.append(e)

        readers = [threading.Thread(target=reader, args=(i,))
                   for i in range(2)]
        _start(readers)
        rng = np.random.default_rng(3)
        stream, oracle = [], {}
        try:
            for _ in range(8000):
                k = int(rng.integers(0, 3000))
                if rng.random() < 0.15:
                    t.delete(k)
                    oracle.pop(k, None)
                    stream.append((k, None))
                else:
                    v = _val(int(rng.integers(0, 900)))
                    with lock:
                        history.setdefault(k, set()).add(v)
                    t.put(k, v)
                    oracle[k] = v
                    stream.append((k, v))
        finally:
            stop.set()
            _join(readers)
        assert not errors, errors[0]
        t.flush()
        t.drain(timeout=WAIT)
        if system == "blob" and t.blob_mgr.gc_runs == 0:
            # GC runs at the end of a merge, so whether the stream set it
            # off depends on the workers' timing: rewrite every live key
            # (all its old slots become garbage) and compact until it runs
            for k, v in oracle.items():
                t.put(k, v)
                stream.append((k, v))
            for _ in range(3):
                t.compact()
                if t.blob_mgr.gc_runs:
                    break
        if system == "blob":
            assert t.blob_mgr.gc_runs > 0, "the stream never ran blob GC"
        assert t.n_compactions > 0
        res = t.filter(T.Predicate("prefix", b"pfx_0"))
        got = {int(k): bytes(v) for k, v in zip(res.keys, res.values)}
        assert got == {k: v for k, v in oracle.items()
                       if v.startswith(b"pfx_0")}
        end = _state(t)
    with _ref(system, "sync", blob_gc_threshold=0.3) as ref:
        for k, v in stream:
            ref.put(k, v) if v is not None else ref.delete(k)
        assert _state(ref) == end == oracle


def test_snapshot_reads_memtables_before_the_version():
    """A flush that installs between a snapshot's two reads: with the
    memtables read first (under the tree lock) its rows show in the frozen
    memtable, the new version or both, never in neither.  The hook runs
    the flush right after the version is read, which loses the rows when
    the version is read before the memtables."""
    with _port("opd", "background") as t:
        for i in range(300):
            t.put(i, _val(i))
        real = t.versions

        class Hooked:
            """The tree's version set; reading ``current`` once installs
            the oldest frozen memtable right after the read."""
            armed = True

            def __getattr__(self, name):
                return getattr(real, name)

            @property
            def current(self):
                v = real.current
                if Hooked.armed:
                    Hooked.armed = False
                    assert t._flush_oldest_immutable()
                return v

        # freeze the memtable without scheduling its flush, so the hook
        # is the only flush
        with t._lock:
            t._immutables.insert(0, t.memtable)
            t.memtable = MemTable(VW, 16)
        t.versions = Hooked()
        snap = t.snapshot()
        t.versions = real
        assert not Hooked.armed and t.n_flushes == 1
        res = t.filter(T.Predicate("prefix", b"pfx_"), snapshot=snap)
        assert res.keys.tolist() == list(range(300))
        assert [t.get(i, snap) for i in range(300)] == \
            [_val(i) for i in range(300)]
        t.drain(timeout=WAIT)


class ContendedLock:
    """The tree lock, noting when a thread had to wait for it."""

    def __init__(self, real):
        self.real, self.contended = real, threading.Event()

    def __enter__(self):
        if not self.real.acquire(blocking=False):
            self.contended.set()
            self.real.acquire()
        return self

    def __exit__(self, *exc):
        self.real.release()


def test_snapshot_registers_in_the_lock_section_that_reads_it():
    """A compaction and blob GC that run between a snapshot's read of the
    version and its registration with GC do not see the snapshot, and
    delete a log its runs still point into.  The hook overwrites every
    key and compacts on another thread right after the read; with the
    registration in the read's lock section that thread waits for it, and
    the snapshot still reads the old values from their log."""
    old = [b"old_%03d" % i for i in range(600)]
    with _port("blob", "background", blob_gc_threshold=0.3) as t:
        for i in range(600):
            t.put(i, old[i])
        t.flush()
        t.drain(timeout=WAIT)
        logs = set(np.unique(np.concatenate(
            [s.vfids for s in t.all_runs()])).tolist())

        def overwrite():
            for i in range(600):
                t.put(i, _val(i))
            t.compact()   # flush, merge both runs, blob GC

        th = threading.Thread(target=overwrite)
        lock = t._lock = ContendedLock(t._lock)
        real = t._read_state

        def hooked():
            state = real()
            del t._read_state   # once
            th.start()
            deadline = time.perf_counter() + WAIT
            while th.is_alive() and not lock.contended.is_set() \
                    and time.perf_counter() < deadline:
                th.join(timeout=0.01)
            return state

        t._read_state = hooked
        snap = t.snapshot()
        _join([th])
        t._lock = lock.real
        assert not logs & set(np.unique(np.concatenate(
            [s.vfids for s in t.all_runs()])).tolist()), \
            "the merge still points into the old log"
        assert all(t.store.contains(f) for f in logs), \
            "GC deleted a log the snapshot points into"
        assert logs <= set(t.blob_mgr.gc_candidates())   # only pinned
        res = t.filter(T.Predicate("prefix", b"old_"), snapshot=snap)
        assert res.keys.tolist() == list(range(600))
        assert res.values.tolist() == old
        assert [t.get(i, snap) for i in range(0, 600, 7)] == old[::7]
        assert [t.get(i) for i in range(0, 600, 7)] == \
            [_val(i) for i in range(0, 600, 7)]


def test_snapshot_excludes_a_write_not_yet_applied():
    """A snapshot taken after ``put_batch`` has numbered a run but before
    the run is in the memtable does not count the run: it reads the
    applied seqno, so two reads of it agree (the writer's seqno counts
    the run already)."""
    vals = np.asarray([_val(i) for i in range(200)], f"S{VW}")
    with _port("opd", "background") as t:
        t.put_batch(np.arange(100, dtype=np.uint64), vals[:100])
        real = t.memtable.put_many
        seen = {}

        def hooked(keys, seqnos, values):
            seen["snap"] = snap = t.snapshot()
            seen["before"] = t.range_lookup(0, 1000, snapshot=snap)
            real(keys, seqnos, values)

        t.memtable.put_many = hooked
        t.put_batch(np.arange(100, 200, dtype=np.uint64), vals[100:])
        del t.memtable.put_many
        snap = seen["snap"]
        assert (snap.seqno, t._seqno) == (100, 200)
        after = t.range_lookup(0, 1000, snapshot=snap)
        assert [a.tolist() for a in after] == \
            [b.tolist() for b in seen["before"]]
        assert after[0].tolist() == list(range(100))
        assert t.range_lookup(0, 1000)[0].tolist() == list(range(200))


# --------------------------------------------------------------------------- #
# graduated throttling
# --------------------------------------------------------------------------- #
def test_graduated_throttle_slowdown_then_stop():
    """Small gates: the writer passes the slowdown band and hits the stop
    gate, both counted, and every write is kept."""
    with _port("opd", "background", memtable_bytes=2 * 1024, l0_slowdown=2,
               l0_stop=4, max_immutables=2, slowdown_seconds=1e-4) as t:
        cfg = t.cfg
        assert (cfg.l0_slowdown_trigger, cfg.l0_stop_trigger) == (2, 4)
        for i in range(4000):
            t.put(i % 1200, _val(i))
        t.flush()
        t.drain(timeout=WAIT)
        rep = t.shape_report()
        assert rep["write_slowdowns"] > 0 and rep["slowdown_seconds"] > 0
        assert t.throttle_stats.counts.get("slowdown", 0) > 0
        assert rep["write_stalls"] > 0 and rep["stall_seconds"] > 0
        last = {i % 1200: i for i in range(4000)}
        assert [t.get(k) for k in range(1200)] == \
            [_val(last[k]) for k in range(1200)]


def test_sync_mode_never_throttles_gradually():
    with _port("opd", "sync", memtable_bytes=2 * 1024) as t:
        for i in range(3000):
            t.put(i % 900, _val(i))
        assert t.write_slowdowns == 0
        assert t.throttle_stats.total() == 0.0
        assert t.write_stalls > 0   # the inline stall is still counted
        assert t._sched is None and t._throttle_level() == 0


@pytest.mark.parametrize("extra", [{}, dict(l0_limit=3), dict(l0_slowdown=5),
                                   dict(l0_stop=9, l0_limit=6)])
def test_throttle_triggers_match_reference(extra):
    r, p = R.LSMConfig(**extra), T.LSMConfig(**extra)
    assert (r.l0_slowdown_trigger, r.l0_stop_trigger) == \
        (p.l0_slowdown_trigger, p.l0_stop_trigger)


# --------------------------------------------------------------------------- #
# worker failures surface and nothing falls back
# --------------------------------------------------------------------------- #
class FlakySpill:
    """``build_sct`` whose ``fail_at``-th call raises an ordinary error (a
    real fault, unlike ``SimulatedCrash``, which models a kill)."""

    def __init__(self, real, fail_at=2):
        self.real, self.fail_at, self.calls, self.broken = real, fail_at, 0, True

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.broken and self.calls >= self.fail_at:
            raise RuntimeError("injected spill fault")
        return self.real(*a, **kw)


def _wait_for_error(sched):
    deadline = time.perf_counter() + WAIT
    while time.perf_counter() < deadline:
        if sched._errors:
            return True
        time.sleep(0.01)
    return False


# a 600-row memtable of ~2 KB files: each flush spills 2-3 chunks
FAIL_KW = dict(memtable_bytes=64 * 1024, file_bytes=2 * 1024)


def _write(tree, how, i):
    if how == "put":
        tree.put(i, _val(i))
    elif how == "put_batch":
        tree.put_batch(np.asarray([i], np.uint64),
                       np.asarray([_val(i)], f"S{VW}"))
    else:
        tree.delete(i)


@pytest.mark.parametrize("how", ["put", "put_batch", "delete"])
def test_flush_worker_failure_surfaces_on_ingest_and_leaks_nothing(
        monkeypatch, how):
    import repro_torch.core.lsm as lsm_mod
    flaky = FlakySpill(lsm_mod.build_sct, fail_at=2)
    monkeypatch.setattr(lsm_mod, "build_sct", flaky)
    with _port("opd", "background", **FAIL_KW) as t:
        for i in range(600):
            t.put(i, _val(i))
        before = set(t.store.fids())
        t.flush()
        assert _wait_for_error(t._sched), "the flush worker never failed"
        assert flaky.calls >= 2, "the fault was not mid-spill"
        assert set(t.store.fids()) == before   # chunk 1 deleted
        assert t._pending_flushes() == 1
        with pytest.raises(MaintenanceError) as ei:
            _write(t, how, 999)
        assert isinstance(ei.value.__cause__, RuntimeError)
        # the error is raised once; a healed spill path retries the same
        # memtable whole
        flaky.broken = False
        _write(t, how, 999)
        t.flush()
        t.drain(timeout=WAIT)
        assert t._pending_flushes() == 0 and t.n_flushes >= 1
        assert [t.get(i) for i in range(600)] == [_val(i) for i in range(600)]
        assert t.get(999) == (None if how == "delete" else _val(999))


def test_flush_worker_failure_surfaces_on_drain(monkeypatch):
    import repro_torch.core.lsm as lsm_mod
    flaky = FlakySpill(lsm_mod.build_sct, fail_at=1)
    monkeypatch.setattr(lsm_mod, "build_sct", flaky)
    with _port("opd", "background", **FAIL_KW) as t:
        for i in range(600):
            t.put(i, _val(i))
        before = set(t.store.fids())
        t.flush()
        assert _wait_for_error(t._sched)
        with pytest.raises(MaintenanceError):
            t.drain(timeout=WAIT)
        assert set(t.store.fids()) == before
        flaky.broken = False
        t.flush()
        t.drain(timeout=WAIT)   # healed: the barrier settles
        assert t._pending_flushes() == 0


@pytest.mark.parametrize("backend", ["numpy", "default"])
def test_kernel_error_on_the_flush_worker_reaches_the_server(monkeypatch,
                                                             backend):
    """``pack_codes`` raising on the flush worker, as a failed launch
    raises in ``_build.launch``, arrives at ``ScanServer.step`` as
    ``MaintenanceError`` with that error as its cause; the flush installed
    nothing, no plain version ran in its place, and the frozen memtable
    answers the batch once the error is raised."""
    from repro_torch.kernels import ops
    calls = []

    def failing(*a, **k):
        calls.append(threading.current_thread().name)
        raise RuntimeError("pack_codes launch failed: CUDA error 700")
    monkeypatch.setattr(ops, "pack_codes", failing)
    with _port("opd", "background", backend, **FAIL_KW) as t:
        for i in range(600):
            t.put(i, _val(i))
        srv = ScanServer(t, max_batch=4)
        t.flush()
        assert _wait_for_error(t._sched)
        assert calls and all(name.startswith("shard") for name in calls)
        rid = srv.submit(T.Predicate("prefix", b"pfx_00"))
        for _ in range(2):   # a reader leaves the failure recorded
            with pytest.raises(MaintenanceError) as ei:
                srv.step()
            assert isinstance(ei.value.__cause__, RuntimeError)
            assert "pack_codes launch failed" in str(ei.value.__cause__)
        assert t.n_flushes == 0 and t._pending_flushes() == 1
        assert not t.all_runs() and len(calls) == 1
        # the writer still sees it, and consumes it
        with pytest.raises(MaintenanceError) as ei:
            t.put(600, _val(600))
        assert "pack_codes launch failed" in str(ei.value.__cause__)
        assert t.get(600) is None
        out = srv.step()
        want = [i for i in range(600) if _val(i).startswith(b"pfx_00")]
        assert out[rid].keys.tolist() == want
        assert [t.get(i) for i in range(0, 600, 7)] == \
            [_val(i) for i in range(0, 600, 7)]
        monkeypatch.undo()
        t.flush()
        t.drain(timeout=WAIT)
        assert t.n_flushes == 1 and t._pending_flushes() == 0


# --------------------------------------------------------------------------- #
# restart, schedulers, the server knob
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("system", ["opd", "blob"])
def test_manifest_recovery_round_trip(tmp_path, system):
    """A background tree with a spill directory, drained and closed, comes
    back with the same shape, seqno and answers (which equal a sync
    reference tree's), and keeps working on its own workers."""
    spill = str(tmp_path / "spill")
    rng = np.random.default_rng(5)
    t = T.LSMTree(T.LSMConfig(**_kw(system), **NUMPY), spill_dir=spill,
                  device="cpu")
    _apply_ops(t, rng, 6000)
    t.flush()
    t.drain(timeout=WAIT)
    shape = [[s.file_id for s in lvl] for lvl in t.levels]
    res = t.filter(T.Predicate("prefix", b"pfx_01"))
    seqno = t._seqno
    t.close()
    with _ref(system, "sync") as ref:
        _apply_ops(ref, np.random.default_rng(5), 6000)
        want = ref.filter(R.Predicate("prefix", b"pfx_01"))
    assert res.keys.tolist() == want.keys.tolist()
    assert res.values.tolist() == want.values.tolist()
    with T.LSMTree.restore(T.LSMConfig(**_kw(system), **NUMPY), spill,
                           device="cpu") as back:
        assert [[s.file_id for s in lvl] for lvl in back.levels] == shape
        assert back._seqno == seqno
        res2 = back.filter(T.Predicate("prefix", b"pfx_01"))
        assert res2.keys.tolist() == res.keys.tolist()
        assert res2.values.tolist() == res.values.tolist()
        _apply_ops(back, rng, 3000)
        back.flush()
        back.drain(timeout=WAIT)
        assert back._sched.n_bg_flushes > 0


def test_shared_scheduler_standalone_trees():
    """Two trees on one scheduler the caller owns: ``drain`` settles both,
    closing a tree leaves the scheduler running, and each tree answers as
    a sync reference tree of its stream."""
    with MaintenanceScheduler() as sched:
        t1 = T.LSMTree(T.LSMConfig(**_kw("opd"), **NUMPY), device="cpu",
                       scheduler=sched)
        t2 = T.LSMTree(T.LSMConfig(**_kw("plain"), **NUMPY), device="cpu",
                       scheduler=sched)
        assert t1._sched is sched is t2._sched and not t1._owns_sched
        rng = np.random.default_rng(2)
        _apply_ops(t1, rng, 3000)
        _apply_ops(t2, rng, 3000)
        t1.flush(), t2.flush()
        sched.drain(timeout=WAIT)
        for t in (t1, t2):
            assert t._pending_flushes() == 0
            assert t._compaction_debt() == 0.0
        t1.close()
        t2.put(1, _val(1))
        t2.flush()
        t2.drain(timeout=WAIT)
        assert sched.n_bg_flushes > 0 and t2.get(1) == _val(1)
    rng = np.random.default_rng(2)
    for t, system in ((t1, "opd"), (t2, "plain")):
        with _ref(system, "sync") as ref:
            _apply_ops(ref, rng, 3000)
            if t is t2:
                ref.put(1, _val(1))
            assert _state(t) == _state(ref)
        t.close()


def test_scan_server_maintenance_knob():
    """'background' serves whatever version is current, 'sync' drains
    first; the answers equal the reference servers', and any other value
    raises as the reference's does."""
    preds = [("prefix", b"pfx_%03d" % i) for i in range(6)]
    out = {}
    for engine, make, Server in ((R, _ref, RServer), (T, _port, ScanServer)):
        with make("opd", "background") as t:
            _apply_ops(t, np.random.default_rng(1), 3000)
            bg = Server(t, max_batch=4, maintenance="background")
            sync = Server(t, max_batch=4, maintenance="sync")
            assert bg.maintenance == "background"
            got_bg = bg.run([engine.Predicate(*p) for p in preds])
            got_sync = sync.run([engine.Predicate(*p) for p in preds])
            assert t._pending_flushes() == 0
            assert t._compaction_debt() == 0.0
            for q in range(len(preds)):
                assert got_bg[q].keys.tolist() == got_sync[q].keys.tolist()
            out[engine] = [(r.keys.tolist(), r.values.tolist())
                           for _, r in sorted(got_sync.items())]
            assert sync.stats.batch_sizes == bg.stats.batch_sizes == [4, 2]
    assert out[R] == out[T]
    for bad in ("nope", "eager"):
        with pytest.raises(ValueError):
            ScanServer(_port("opd", "sync"), maintenance=bad)
        with pytest.raises(ValueError):
            RServer(_ref("opd", "sync"), maintenance=bad)


def test_sync_mode_drain_and_server_do_nothing_extra():
    with _port("opd", "sync") as t:
        _apply_ops(t, np.random.default_rng(4), 2000)
        flushes = t.n_flushes
        t.drain(timeout=WAIT)
        srv = ScanServer(t, maintenance="sync")
        srv.run([T.Predicate("prefix", b"pfx_0")])
        assert t.n_flushes == flushes and t._sched is None


def test_executor_submit_uses_the_pool_and_map_runs_inline():
    main = threading.current_thread().name
    with ShardExecutor(1) as ex:
        assert ex.submit(lambda: threading.current_thread().name).result(
            timeout=WAIT).startswith("shard")
        assert ex.map(lambda x: (x, threading.current_thread().name),
                      [1, 2]) == [(1, main), (2, main)]
    with ShardExecutor(3) as ex:
        assert ex.map(lambda x: x * x, list(range(10))) == \
            [x * x for x in range(10)]
    assert ex._pool is None


def test_closing_an_owned_scheduler_stops_its_threads():
    before = set(threading.enumerate())
    with _port("opd", "background") as t:
        _apply_ops(t, np.random.default_rng(6), 3000)
        t.flush()
        assert t._owns_sched
    assert t._sched.executor._pool is None
    assert t._sched.n_bg_flushes > 0
    assert not [th for th in set(threading.enumerate()) - before
                if th.is_alive()]
