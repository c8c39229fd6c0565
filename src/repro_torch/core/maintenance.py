"""Background maintenance: flush workers, a debt-scored compaction
scheduler and graduated write throttling.

Port of ``repro/core/maintenance.py``.  One ``MaintenanceScheduler`` may
drive several trees on one ``ShardExecutor`` thread pool (the sharded
engine's shards, on the engine's pool); per tree at most two jobs are in
flight:

  flush worker       drains the tree's queue of frozen memtables oldest
                     first (L0's recency order depends on it), installing
                     one ``VersionEdit`` per memtable; on an 'opd' tree
                     each flush packs its codes with the ``pack_codes``
                     kernel;
  compaction worker  runs the single highest-debt merge again and again
                     until the tree's debt (``LSMTree._compaction_debt``:
                     L0 runs past the trigger plus each level's pressure)
                     is zero; on an 'opd' tree each merge unpacks its
                     inputs and remaps and packs its output with the
                     ``unpack_codes`` and ``remap_pack_codes`` kernels
                     ('jax_packed').  The debt follows the tree's
                     compaction policy (bytes over capacity at leveled
                     levels, run depth past K-1 at tiered ones).  When the
                     debt reaches zero it calls the tree's retune hook
                     (``_maybe_retune``): a tree with
                     ``policy_autotune`` lets its ``PolicyTuner`` refit the
                     workload and switch the policy, off the writer's
                     thread.

The workers launch their kernels on the device's current stream of their
own thread, the default stream, as the writer and the readers do, so every
kernel stays ordered on one stream.  A kernel launch that fails raises on
the worker like any other exception.

Jobs never wait on other jobs, so any pool size is free of deadlock.

``throttle`` runs on the writer's thread after a memtable rotation: past
``l0_slowdown`` runs in L0 (or with half the frozen queue full) the writer
sleeps ``slowdown_seconds``; past ``l0_stop`` (or with more than
``max_immutables`` frozen memtables) it blocks until maintenance catches
up.  Both are timed in ``LSMTree.throttle_stats`` ('slowdown' / 'stop').

A worker's exception is recorded and raised as ``MaintenanceError`` (the
original as its ``__cause__``) on the writer's next write, ``drain`` or
``throttle``, which consume it, and on every reader's
``raise_maintenance_errors(consume=False)`` (``ScanServer.step``) until
then, so a reader that sees the failure first does not hide it from the
writer; a failed worker does not schedule itself again.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    from repro_torch.shard.executor import ShardExecutor

THROTTLE_NONE = 0
THROTTLE_SLOWDOWN = 1
THROTTLE_STOP = 2


class MaintenanceError(RuntimeError):
    """A background flush or compaction job raised; carries the original
    as ``__cause__``."""


class MaintenanceScheduler:
    def __init__(self, executor: Optional["ShardExecutor"] = None):
        """``executor``: the pool the workers run on (the sharded engine
        passes its own, so one pool serves its scans and every shard's
        maintenance; ``close`` leaves a given pool open).  Without one the
        scheduler owns a pool of two threads: one flush and one compaction
        worker, a tree's two jobs at once."""
        self._owns_executor = executor is None
        if executor is None:
            # imported here: the shard package imports the engine
            from repro_torch.shard.executor import ShardExecutor
            executor = ShardExecutor(2)
        self.executor = executor
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._flush_inflight: set = set()     # id(tree)
        self._compact_inflight: set = set()   # id(tree)
        self._trees: List[object] = []
        self._errors: List[BaseException] = []
        self.n_bg_flushes = 0
        self.n_bg_compactions = 0

    # ------------------------------------------------------------------ #
    # registration
    # ------------------------------------------------------------------ #
    def register(self, tree) -> None:
        with self._lock:
            if all(t is not tree for t in self._trees):
                self._trees.append(tree)

    def unregister(self, tree) -> None:
        """Stop driving ``tree`` (a shard retired by a split); a job in
        flight for it runs to its end."""
        with self._lock:
            self._trees = [t for t in self._trees if t is not tree]

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def schedule_flush(self, tree) -> None:
        """Make sure a flush worker is (or will be) draining the tree's
        frozen queue; one worker a tree."""
        with self._lock:
            if id(tree) in self._flush_inflight:
                return
            self._flush_inflight.add(id(tree))
        self.executor.submit(self._flush_worker, tree)

    def schedule_compaction(self, tree) -> None:
        if tree._compaction_debt() <= 0.0:
            return
        with self._lock:
            if id(tree) in self._compact_inflight:
                return
            self._compact_inflight.add(id(tree))
        self.executor.submit(self._compact_worker, tree)

    def _flush_worker(self, tree) -> None:
        failed = False
        try:
            while tree._flush_oldest_immutable():
                with self._lock:   # '+=' from pool threads loses counts
                    self.n_bg_flushes += 1
                    self._cond.notify_all()
                self.schedule_compaction(tree)
        except BaseException as e:   # raised on the writer's next op
            failed = True
            self._record_error(e)
        finally:
            with self._lock:
                self._flush_inflight.discard(id(tree))
                self._cond.notify_all()
            # a rotation may have raced the empty-queue check: schedule
            # again, but never after a failure, or a lasting fault (or a
            # simulated crash) becomes a hot retry loop
            if not failed and tree._pending_flushes():
                self.schedule_flush(tree)

    def _compact_worker(self, tree) -> None:
        failed = False
        try:
            while tree._compact_one_step():
                with self._lock:
                    self.n_bg_compactions += 1
                    self._cond.notify_all()
        except BaseException as e:
            failed = True
            self._record_error(e)
        finally:
            with self._lock:
                self._compact_inflight.discard(id(tree))
                self._cond.notify_all()
            if not failed:
                if tree._compaction_debt() > 0.0:
                    self.schedule_compaction(tree)
                else:
                    # the round is complete: the tree's policy tuner, if
                    # any, may retune between rounds
                    try:
                        tree._maybe_retune()
                    except BaseException as e:
                        self._record_error(e)

    def _record_error(self, e: BaseException) -> None:
        with self._lock:
            self._errors.append(e)
            self._cond.notify_all()

    def check_errors(self, consume: bool = True) -> None:
        """Raise the recorded failures as one ``MaintenanceError``; the
        writer's paths consume them, a reader (``consume=False``) leaves
        them for the writer.  While healthy, one unlocked list check (it
        guards every write)."""
        if not self._errors:
            return
        with self._lock:
            errs = list(self._errors)
            if consume:
                self._errors = []
        if errs:
            raise MaintenanceError(
                f"{len(errs)} background maintenance job(s) failed: "
                f"{errs[0]!r}") from errs[0]

    # ------------------------------------------------------------------ #
    # the writer's throttle (graduated: none -> slowdown -> stop)
    # ------------------------------------------------------------------ #
    def throttle(self, tree) -> None:
        """Called on the writer's thread after a rotation; the fast path
        is two comparisons."""
        level = tree._throttle_level()
        if level == THROTTLE_NONE:
            return
        self.check_errors()
        # make sure something is working the backlog down
        self.schedule_flush(tree)
        self.schedule_compaction(tree)
        if level == THROTTLE_SLOWDOWN:
            delay = tree.cfg.slowdown_seconds
            tree.write_slowdowns += 1
            tree.slowdown_seconds += delay
            with tree.throttle_stats.time("slowdown"):
                time.sleep(delay)
            return
        # THROTTLE_STOP: block until maintenance brings the tree under it
        tree.write_stalls += 1
        t0 = time.perf_counter()
        with tree.throttle_stats.time("stop"):
            with self._lock:
                while tree._throttle_level() >= THROTTLE_STOP:
                    if self._errors:
                        break
                    self._cond.wait(timeout=0.05)
        tree.stall_seconds += time.perf_counter() - t0
        self.check_errors()

    # ------------------------------------------------------------------ #
    # the drain barrier
    # ------------------------------------------------------------------ #
    def drain(self, trees: Optional[List[object]] = None,
              timeout: float = 120.0) -> None:
        """Block until every tree has an empty frozen queue, no compaction
        debt and no job in flight (the point where background answers
        equal sync ones); ``TimeoutError`` after ``timeout`` seconds."""
        if trees is None:
            with self._lock:
                trees = list(self._trees)
        deadline = time.perf_counter() + timeout
        while True:
            self.check_errors()
            busy = False
            for tree in trees:
                if tree._pending_flushes():
                    busy = True
                    self.schedule_flush(tree)
                if tree._compaction_debt() > 0.0:
                    busy = True
                    self.schedule_compaction(tree)
            with self._lock:
                inflight = bool(self._flush_inflight
                                or self._compact_inflight)
                if not busy and not inflight:
                    break
                self._cond.wait(timeout=0.05)
            if time.perf_counter() > deadline:
                raise TimeoutError("maintenance drain timed out")
        self.check_errors()

    def close(self) -> None:
        """Wait for the jobs in flight and stop the pool's threads, where
        the pool is the scheduler's own."""
        if self._owns_executor:
            self.executor.close()

    def __enter__(self) -> "MaintenanceScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
