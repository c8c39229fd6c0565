"""Continuous-batching scan server over the LSM-OPD engine.

Port of ``repro/serving/scan_server.py`` for one ``LSMTree``.  The server
keeps up to ``max_batch`` request slots busy and drains them through the
tree's batched calls: every scan slot of a batch rides one
``LSMTree.filter_many`` (on 'jax_packed', one ``multi_range_filter_packed``
launch per run, amortized over the batch) and every aggregate slot one
``aggregate_many``.

Flow: clients ``submit`` predicates (or ``submit_agg`` aggregate specs)
-> requests queue -> each ``step`` fills up to ``max_batch`` slots, pins
ONE snapshot for the whole batch (its filters and aggregates observe one
consistent version), executes the batch, completes the slots and dequeues
them.  A failing engine call leaves the batch queued for a retry.
``drain`` steps until the queue is empty.  Writes may interleave between
batches: each batch takes a new snapshot.

``maintenance`` sets how batches relate to the tree's maintenance:
'background' (the default) pins whatever version is current, so flushes
and compactions overlap with serving; 'sync' drains the tree's pending
maintenance before each batch, so every batch sees a fully flushed and
compacted tree.  Each step first raises a failed background worker as
``MaintenanceError``, and leaves the failure recorded for the tree's
writer, whose next write raises it too.

The reference also serves a ``ShardedLSM``; the shard layer is not ported
yet (ROADMAP §1 scale-out), so the engine here is the port's ``LSMTree``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

from repro_torch.core.filter_exec import FilterResult
from repro_torch.core.lsm import LSMTree, Snapshot
from repro_torch.core.opd import Predicate
from repro_torch.query import AggResult, AggSpec


@dataclasses.dataclass
class ScanRequest:
    rid: int
    pred: Predicate
    submitted_at: float = 0.0
    result: Optional[FilterResult] = None
    done: bool = False


@dataclasses.dataclass
class AggRequest:
    rid: int
    spec: AggSpec
    submitted_at: float = 0.0
    result: Optional[AggResult] = None
    done: bool = False


QueryResult = Union[FilterResult, AggResult]


@dataclasses.dataclass
class ScanServerStats:
    n_submitted: int = 0
    n_served: int = 0
    n_batches: int = 0
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    wait_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def mean_batch(self) -> float:
        return (sum(self.batch_sizes) / len(self.batch_sizes)
                if self.batch_sizes else 0.0)


class ScanServer:
    def __init__(self, tree: LSMTree, max_batch: int = 16,
                 maintenance: str = "background"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be at least 1, got {max_batch}")
        if maintenance not in ("background", "sync"):
            raise ValueError(f"unknown maintenance mode {maintenance!r}")
        self.tree = tree
        self.max_batch = max_batch
        self.maintenance = maintenance
        self.queue: List[Union[ScanRequest, AggRequest]] = []
        self.stats = ScanServerStats()
        self._next_rid = 0

    # ------------------------------------------------------------------ #
    # client side
    # ------------------------------------------------------------------ #
    def _enqueue(self, req) -> int:
        self.queue.append(req)
        self.stats.n_submitted += 1
        return req.rid

    def _rid(self) -> int:
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def submit(self, pred: Predicate) -> int:
        """Enqueue one predicate; returns a request id resolved by a step."""
        return self._enqueue(ScanRequest(self._rid(), pred,
                                         time.perf_counter()))

    def submit_many(self, preds: List[Predicate]) -> List[int]:
        return [self.submit(p) for p in preds]

    def submit_agg(self, spec: AggSpec) -> int:
        """Enqueue one aggregate; batched with filters in ``step``."""
        return self._enqueue(AggRequest(self._rid(), spec,
                                        time.perf_counter()))

    def submit_aggs(self, specs: List[AggSpec]) -> List[int]:
        return [self.submit_agg(s) for s in specs]

    # ------------------------------------------------------------------ #
    # server side
    # ------------------------------------------------------------------ #
    def step(self, snapshot: Optional[Snapshot] = None
             ) -> Dict[int, QueryResult]:
        """Fill up to ``max_batch`` slots from the queue and execute them
        as ONE batched filter and ONE batched aggregate, both against a
        single pinned snapshot."""
        # a read-only server must not serve over failed maintenance; the
        # failure stays recorded for the writer
        self.tree.raise_maintenance_errors(consume=False)
        if not self.queue:
            return {}
        if self.maintenance == "sync":
            self.tree.drain()   # observe a fully maintained tree
        slots = self.queue[: self.max_batch]
        scans = [r for r in slots if isinstance(r, ScanRequest)]
        aggs = [r for r in slots if isinstance(r, AggRequest)]
        if snapshot is None:
            snapshot = self.tree.snapshot()
        now = time.perf_counter()
        # dequeue only after the batch succeeds
        filter_res = self.tree.filter_many(
            [r.pred for r in scans], snapshot=snapshot) if scans else []
        agg_res = self.tree.aggregate_many(
            [r.spec for r in aggs], snapshot=snapshot) if aggs else []
        del self.queue[: len(slots)]
        out: Dict[int, QueryResult] = {}
        for r, res in list(zip(scans, filter_res)) + list(zip(aggs, agg_res)):
            r.result = res
            r.done = True
            out[r.rid] = res
            self.stats.wait_seconds.append(now - r.submitted_at)
        self.stats.n_batches += 1
        self.stats.n_served += len(slots)
        self.stats.batch_sizes.append(len(slots))
        return out

    def drain(self) -> Dict[int, QueryResult]:
        """Step until the queue is empty (each step refills from whatever
        has been submitted since)."""
        out: Dict[int, QueryResult] = {}
        while self.queue:
            out.update(self.step())
        return out

    def run(self, preds: List[Predicate]) -> Dict[int, QueryResult]:
        """Submit a workload of predicates and drain it."""
        self.submit_many(preds)
        return self.drain()
