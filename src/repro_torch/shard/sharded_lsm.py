"""Range-sharded LSM-OPD engine: N trees behind a key router, on one card.

Port of ``repro/shard/sharded_lsm.py``.  Each shard is a full ``LSMTree``
(its own memtable, levels, OPD dictionaries, stats) owning a contiguous
key range; the shards share one ``FileStore``, so I/O accounting stays
global and split-rebuilt shards keep addressing existing blob value
logs, and one device: the engine resolves it once (``resolve_device``,
the card unless the caller passes ``device='cpu'``) and hands it to every
shard tree it builds, in a split and in ``restore`` too.  Writes route by
key (``ShardRouter``, host numpy); scans scatter per shard and gather
into one result.  Every shard's kernels (the flush's ``pack_codes``, the
fused filter, the aggregates' ``fused_zone_agg`` and ``zone_histogram``,
the merges' ``unpack_codes`` and ``remap_pack_codes``) launch on the
device's default stream, from the caller's thread or, once the pinned
shards hold ``SCAN_PARALLEL_MIN`` entries each, from the executor's pool
threads.

Ordering contract: shard order equals key order and every per-shard
result is key-sorted, so the gather stage concatenates in shard order
and the merged ``filter`` / ``filter_many`` / ``range_lookup`` output is
key-ascending; ``ShardedLSM(n_shards=1)`` is bit for bit a plain
``LSMTree``.

MVCC: ``snapshot()`` pins a vector of per-shard snapshots plus the
boundary table at pin time.  Reads against it route with the pinned
boundaries to the pinned trees, so a hot-shard split between pin and
read is invisible: the retired tree's runs (and, for 'blob', its value
logs) stay readable because the snapshot holds them directly.

Durability: with a ``spill_dir`` each shard tree logs to its own
manifest (``MANIFEST-<n>.log``) and WAL (``WAL-<n>-*.wal``) in the one
directory, and ``SHARDS.json`` holds the router's boundaries and the
shards' manifest names; ``ShardedLSM.restore`` rebuilds the engine from
them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.filter_exec import FilterResult
from repro_torch.core.lsm import LSMConfig, LSMTree, Snapshot, resolve_device
from repro_torch.core.maintenance import MaintenanceScheduler
from repro_torch.core.opd import Predicate
from repro_torch.core.stats import StageStats
from repro_torch.core.version import gc_orphan_scts
from repro_torch.core.wal import wal_prefix_for
from repro_torch.query import finalize_partial, merge_partials, resolve_specs
from repro_torch.query.planner import collect_domain
from repro_torch.shard.executor import ShardExecutor
from repro_torch.shard.rebalance import (HotShardSplitter, RebalanceConfig,
                                         split_shard)
from repro_torch.shard.router import KEY_MAX, ShardRouter
from repro_torch.storage.devices import DeviceModel
from repro_torch.storage.io import FileStore
from repro_torch.testing.crashpoints import crashpoint

_STAGE_STATS = ("filter_stats", "compaction_stats", "flush_stats",
                "lookup_stats", "throttle_stats", "agg_stats")
_COUNTERS = ("n_flushes", "n_compactions", "write_stalls", "stall_seconds",
             "write_slowdowns", "slowdown_seconds", "cascade_truncations",
             "dict_compares", "compaction_in_bytes", "compaction_out_bytes",
             "ingest_bytes")

_SHARDS_JSON = "SHARDS.json"  # router boundaries + per-shard manifest names


@dataclasses.dataclass
class ShardSnapshot:
    """Cross-shard MVCC snapshot: per-shard snapshots pinned together
    with the boundary table that was live at pin time."""

    uppers: List[int]          # exclusive upper bound per pinned shard
    trees: List[LSMTree]       # the trees those bounds routed to
    snaps: List[Snapshot]      # one engine snapshot per pinned tree

    def __post_init__(self) -> None:
        self._search = np.asarray(self.uppers[:-1], np.uint64)

    def shard_of(self, key: int) -> int:
        if not (0 <= key < self.uppers[-1]):  # same contract as the router
            raise KeyError(f"key {key} outside [0, {self.uppers[-1]})")
        return int(np.searchsorted(self._search, np.uint64(key),
                                   side="right"))

    def entries(self) -> List[Tuple[LSMTree, Snapshot]]:
        return list(zip(self.trees, self.snaps))


class ShardedLSM:
    # average SCT entries per pinned shard above which scatter reads use
    # the thread pool; below it threading only adds convoy latency
    SCAN_PARALLEL_MIN = 100_000

    def __init__(
        self,
        cfg: LSMConfig,
        n_shards: int = 4,
        *,
        key_max: int = KEY_MAX,
        n_workers: Optional[int] = None,
        rebalance: Optional[RebalanceConfig] = None,
        spill_dir: Optional[str] = None,
        device=None,
    ):
        """``put_batch`` fans its per-shard groups out on the pool only for
        the codecs whose write path is dominated by GIL-releasing zlib
        ('heavy', compressed 'blob'); scatter reads use the pool past
        ``SCAN_PARALLEL_MIN``.  Both rules are the reference's defaults.
        Flushes and compactions are always shard-parallel through
        ``compact_all``; with ``cfg.maintenance='background'`` ONE
        ``MaintenanceScheduler`` on this engine's pool drives every
        shard's flush queue and compaction debt.  ``device`` is every
        shard tree's (the card by default)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = FileStore(spill_dir)
        self.router = ShardRouter(n_shards, key_max)
        if n_workers is None:  # oversubscribing cores only adds GIL churn
            n_workers = min(n_shards, os.cpu_count() or 1)
        self.executor = ShardExecutor(n_workers)
        self.scheduler: Optional[MaintenanceScheduler] = (
            MaintenanceScheduler(executor=self.executor)
            if cfg.maintenance == "background" else None)
        self._manifest_seq = 0
        self.shards: List[LSMTree] = [
            LSMTree(cfg, store=self.store, scheduler=self.scheduler,
                    manifest=self._next_manifest(), device=self.device)
            for _ in range(n_shards)]
        self._persist_shard_table()
        self.parallel_ingest = cfg.codec == "heavy" or (
            cfg.codec == "blob" and cfg.blob_compress)
        self._splitter = (HotShardSplitter(rebalance)
                          if rebalance is not None else None)
        self.n_splits = 0
        self._reb_ticks = 0
        # the engine's own stage times (an aggregate's bucket planning)
        # and those of trees retired by splits, folded in so engine-level
        # reports stay monotonic across rebalancing
        self._engine_stages: Dict[str, StageStats] = {
            name: StageStats() for name in _STAGE_STATS}
        self._retired_counts: Dict[str, int] = {c: 0 for c in _COUNTERS}

    # ------------------------------------------------------------------ #
    # manifests + restart
    # ------------------------------------------------------------------ #
    def _next_manifest(self) -> Optional[str]:
        """Distinct per-shard manifest names: all shard trees share one
        spill dir, so each needs its own version log."""
        if not self.store.spill_dir:
            return None
        name = f"MANIFEST-{self._manifest_seq:04d}.log"
        self._manifest_seq += 1
        return name

    def _persist_shard_table(self) -> None:
        """Write the router's boundaries and the shard -> manifest map
        (tmp + rename); with the per-shard manifests this makes the whole
        sharded shape recoverable (``restore``)."""
        if not self.store.spill_dir:
            return
        table = {
            "key_max": self.router.key_max,
            "uppers": self.router.uppers,
            "manifests": [t.versions.manifest_name for t in self.shards],
            "next_manifest": self._manifest_seq,
        }
        path = os.path.join(self.store.spill_dir, _SHARDS_JSON)
        with open(path + ".tmp", "w") as f:
            json.dump(table, f)
        os.replace(path + ".tmp", path)

    @classmethod
    def restore(cls, cfg: LSMConfig, spill_dir: str, **kw) -> "ShardedLSM":
        """Rebuild a sharded engine after a crash or a restart: one
        ``FileStore.restore`` for the shared files, the shard table for the
        router's boundaries, and one manifest replay per shard tree, each
        building only its own runs on the engine's device and replaying
        its own WAL tail when ``cfg.wal_sync`` is on.  Manifests and WAL
        segments the table does not name (a crash mid-split) are purged
        first; then one orphan collection runs over every shard's
        version, and 'blob' value logs that two shards share leave every
        shard's GC (``_untrack_shared_logs``).  ``kw`` are ``__init__``'s (``device``, ``n_workers``,
        ...)."""
        store = FileStore.restore(spill_dir)
        path = os.path.join(spill_dir, _SHARDS_JSON)
        with open(path) as f:
            table = json.load(f)
        # size the pool for the restored shard count, not the placeholder's
        kw.setdefault("n_workers",
                      min(len(table["manifests"]), os.cpu_count() or 1))
        # the placeholder shard has no spill dir, so it cannot hold a WAL:
        # built with the WAL off, then the real shards take the caller's cfg
        eng = cls(dataclasses.replace(cfg, wal_sync="off"), n_shards=1,
                  key_max=int(table["key_max"]), spill_dir=None, **kw)
        eng.cfg = cfg
        eng.store = store
        eng.router = ShardRouter.from_uppers(table["uppers"],
                                             int(table["key_max"]))
        eng._manifest_seq = int(table["next_manifest"])
        if eng.scheduler is not None:  # drop the placeholder shard
            for t in eng.shards:
                eng.scheduler.unregister(t)
        # a crash mid-split can leave the manifests (and WAL segments) of
        # halves the durable table never adopted: purge them before the
        # restore, or a reallocated manifest name would append onto stale
        # edits or replay a dead shard's records
        referenced = set(table["manifests"])
        wal_prefixes = {wal_prefix_for(m) for m in referenced}
        for name in os.listdir(spill_dir):
            full = os.path.join(spill_dir, name)
            if (name.startswith("MANIFEST") and name.endswith(".log")
                    and name not in referenced):
                os.remove(full)
            elif name.endswith(".wal") \
                    and name.rsplit("-", 1)[0] not in wal_prefixes:
                os.remove(full)
        eng.shards = [
            LSMTree.restore(cfg, spill_dir, device=eng.device,
                            scheduler=eng.scheduler, manifest=name,
                            store=store, gc_orphans=False)
            for name in table["manifests"]
        ]
        gc_orphan_scts(store, [t.versions.current for t in eng.shards])
        if cfg.codec == "blob":
            eng._untrack_shared_logs()
        eng._persist_shard_table()
        return eng

    def _untrack_shared_logs(self) -> None:
        """Each restored shard rebuilt its blob manager from the pointers
        of its own runs, so a value log written before a split is tracked
        by both halves.  Take such logs (those that runs of another shard
        point into) out of every manager, as a half keeps them without a
        restart: else one half's GC would delete a log its sibling still
        reads."""
        owners: Dict[int, int] = {}
        for t in self.shards:
            for fid in t.blob_mgr.live_fids():
                owners[fid] = owners.get(fid, 0) + 1
        for t in self.shards:
            for fid in t.blob_mgr.live_fids():
                if owners[fid] > 1:
                    t.blob_mgr.forget(fid)

    # ------------------------------------------------------------------ #
    # geometry
    # ------------------------------------------------------------------ #
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def disk_bytes(self) -> int:
        return sum(t.disk_bytes for t in self.shards)

    @property
    def dict_bytes(self) -> int:
        return sum(t.dict_bytes for t in self.shards)

    @property
    def n_files(self) -> int:
        return sum(t.n_files for t in self.shards)

    def _stage(self, name: str) -> StageStats:
        return StageStats.merge_all(
            [getattr(t, name) for t in self.shards]
            + [self._engine_stages[name]])

    @property
    def filter_stats(self) -> StageStats:
        return self._stage("filter_stats")

    @property
    def compaction_stats(self) -> StageStats:
        return self._stage("compaction_stats")

    @property
    def flush_stats(self) -> StageStats:
        return self._stage("flush_stats")

    @property
    def lookup_stats(self) -> StageStats:
        return self._stage("lookup_stats")

    @property
    def agg_stats(self) -> StageStats:
        return self._stage("agg_stats")

    # ------------------------------------------------------------------ #
    # writes
    # ------------------------------------------------------------------ #
    def put(self, key: int, value: bytes) -> None:
        self.shards[self.router.shard_of(key)].put(key, value)
        self._tick_rebalance()

    def delete(self, key: int) -> None:
        self.shards[self.router.shard_of(key)].delete(key)
        self._tick_rebalance()

    def put_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        """Scatter the batch by shard (one vectorized route) and run the
        per-shard inserts, with any flushes and compactions they set off.
        Within a shard the batch order is kept (boolean-mask selection is
        stable), so versions of one key keep their order.  Thread fan-out
        follows ``parallel_ingest``."""
        keys = np.asarray(keys)
        values = np.asarray(values)
        sids = self.router.shard_of_batch(keys)
        jobs = []
        for i in range(self.n_shards):
            m = sids == i
            if m.any():
                jobs.append((self.shards[i], keys[m], values[m]))
        if self.parallel_ingest:
            self.executor.map(lambda j: j[0].put_batch(j[1], j[2]), jobs)
        else:
            for tree, k, v in jobs:
                tree.put_batch(k, v)
        self._maybe_rebalance()

    def flush(self) -> None:
        """Every shard's flush on the pool: background, a rotation and a
        schedule each; sync, the inline flushes."""
        self.executor.map(lambda t: t.flush(), self.shards)

    def drain(self, timeout: float = 120.0) -> None:
        """Barrier: wait until every shard's flush queue is empty and all
        compaction debt is paid (background mode; sync mode returns at
        once)."""
        if self.scheduler is not None:
            self.scheduler.drain(self.shards, timeout=timeout)

    def compact_all(self) -> None:
        """Shard-parallel maintenance: every shard flushes and compacts on
        the pool.  Background mode rotates, drains, then folds inline: a
        per-shard ``compact()`` would drain from inside a pool thread and
        could starve the very workers it waits on."""
        if self.scheduler is None:
            self.executor.map(lambda t: t.compact(), self.shards)
            return
        self.flush()
        self.scheduler.drain(self.shards)

        def fold(t):
            t._force_compact_inline()
            t._maybe_retune()  # per-shard tuner hook, round complete
        self.executor.map(fold, self.shards)

    # ------------------------------------------------------------------ #
    # per-shard compaction policy
    # ------------------------------------------------------------------ #
    def set_policy(self, shard: int, policy) -> None:
        """Install a ``CompactionPolicy`` on ONE shard: a write-heavy shard
        can run tiering while its scan-heavy sibling stays leveled.  With
        ``cfg.policy_autotune`` each shard tree carries its own
        ``PolicyTuner``; this is the manual override."""
        self.shards[shard].set_policy(policy)

    def policies(self) -> List[str]:
        return [t.policy.describe() for t in self.shards]

    # ------------------------------------------------------------------ #
    # rebalancing (hot-shard splits)
    # ------------------------------------------------------------------ #
    _REBALANCE_EVERY = 256  # single-key writes between splitter checks

    def _tick_rebalance(self) -> None:
        """Per-key write path: the O(n_shards) splitter scan runs only
        every ``_REBALANCE_EVERY`` ops (batches check every time: they
        move threshold-sized volumes at once)."""
        if self._splitter is None:
            return
        self._reb_ticks += 1
        if self._reb_ticks >= self._REBALANCE_EVERY:
            self._reb_ticks = 0
            self._maybe_rebalance()

    def _maybe_rebalance(self) -> None:
        if self._splitter is None:
            return
        while True:
            i = self._splitter.pick(self.shards)
            if i is None:
                return
            old = self.shards[i]
            if self.scheduler is not None:
                # quiesce the shard first: a split rebuilds from a fixed
                # run set, so no background job may change it meanwhile
                old.drain()
            got = split_shard(old, self.router.bounds(i),
                              manifests=(self._next_manifest(),
                                         self._next_manifest()),
                              scheduler=self.scheduler)
            if got is None:
                self._splitter.defer(old)  # unsplittable: back off
                continue
            pivot, left, right = got
            # the halves inherit the retired shard's (possibly tuned)
            # policy: a split must not silently undo a migration
            left.policy = old.policy
            right.policy = old.policy
            old_runs = old.all_runs()
            self.router.split(i, pivot)
            self.shards[i:i + 1] = [left, right]
            self._retire(old)
            self.n_splits += 1
            crashpoint("split.before_table")
            self._persist_shard_table()
            # the old shard's files leave the store only after the new
            # table is durable: a crash before the rename finds the old
            # shard's manifest still fully backed (the halves' files are
            # then orphans, collected by the next restore)
            for s in old_runs:
                self.store.delete(s.file_id)

    def _fold(self, tree: LSMTree) -> None:
        """Fold a tree leaving the engine into the engine's stage stats and
        counters (so its reports stay monotonic) and unregister it from
        the shared scheduler."""
        for name in _STAGE_STATS:
            self._engine_stages[name] = (
                self._engine_stages[name].merged(getattr(tree, name)))
        for c in _COUNTERS:
            self._retired_counts[c] += getattr(tree, c)
        if self.scheduler is not None:
            self.scheduler.unregister(tree)

    def _retire(self, tree: LSMTree) -> None:
        self._fold(tree)
        if tree.wal is not None:
            # the split flushed and drained the tree, so its WAL holds
            # nothing above the manifest's watermark: drop the segments
            tree.wal.discard()

    def replace_shard(self, i: int, tree: LSMTree) -> LSMTree:
        """Swap shard ``i``'s tree for ``tree`` and return the old one: the
        serving-side failover hook (``repro_torch.replica``), which
        re-points routing to a promoted follower without touching the
        boundary table.

        This is a routing swap in the process, not a durable change of
        topology: the incoming tree keeps its own spill directory,
        manifest and WAL (the replica group's EPOCH file owns that
        durability), so ``SHARDS.json`` is not rewritten and the old
        tree's WAL is not discarded (it may be a demoted leader whose
        segments are its recovery record).  The old tree's stats fold into
        the engine's, as across a split."""
        old = self.shards[i]
        self._fold(old)
        self.shards[i] = tree
        return old

    def raise_maintenance_errors(self, consume: bool = True) -> None:
        """Raise a background worker's failure as ``MaintenanceError``.
        A read-only caller (``ScanServer.step``) passes ``consume=False``
        and leaves the failure for the writer, as ``LSMTree``'s does."""
        if self.scheduler is not None:
            self.scheduler.check_errors(consume)
        for t in self.shards:
            t.raise_maintenance_errors(consume)

    # ------------------------------------------------------------------ #
    # reads (scatter-gather against a pinned snapshot vector)
    # ------------------------------------------------------------------ #
    def snapshot(self) -> ShardSnapshot:
        """Pin all shards together (one writer: no put can interleave
        mid-vector) with the current boundary table."""
        return ShardSnapshot(
            uppers=self.router.uppers,
            trees=list(self.shards),
            snaps=[t.snapshot() for t in self.shards],
        )

    def _scan_map(self, fn, items, snap: ShardSnapshot):
        """Scatter a read across shards: on the pool only when the pinned
        shards carry ``SCAN_PARALLEL_MIN`` SCT entries each on average."""
        if len(items) > 1:
            entries = sum(s.n for t_snap in snap.snaps for s in t_snap.runs)
            if entries >= self.SCAN_PARALLEL_MIN * len(items):
                return self.executor.map(fn, items)
        return [fn(x) for x in items]

    def get(self, key: int,
            snapshot: Optional[ShardSnapshot] = None) -> Optional[bytes]:
        if snapshot is not None:
            i = snapshot.shard_of(key)
            return snapshot.trees[i].get(key, snapshot.snaps[i])
        return self.shards[self.router.shard_of(key)].get(key)

    def filter(self, pred: Predicate,
               snapshot: Optional[ShardSnapshot] = None) -> FilterResult:
        snap = snapshot or self.snapshot()
        results = self._scan_map(
            lambda e: e[0].filter(pred, snapshot=e[1]), snap.entries(), snap)
        return self._gather(results)

    def filter_many(self, preds: List[Predicate],
                    snapshot: Optional[ShardSnapshot] = None
                    ) -> List[FilterResult]:
        """Batched scatter-gather: each shard runs ONE ``filter_many`` over
        the whole batch ('fused': one zone-gated launch per level;
        'jax_packed': one ``multi_range_filter_packed`` launch per run),
        then the results merge per predicate in shard order."""
        snap = snapshot or self.snapshot()
        per_shard = self._scan_map(
            lambda e: e[0].filter_many(preds, snapshot=e[1]),
            snap.entries(), snap)
        return [self._gather([shard_res[q] for shard_res in per_shard])
                for q in range(len(preds))]

    def aggregate(self, spec, snapshot: Optional[ShardSnapshot] = None):
        """One aggregate, scatter-gathered -> ``AggResult``."""
        return self.aggregate_many([spec], snapshot)[0]

    def aggregate_many(self, specs,
                       snapshot: Optional[ShardSnapshot] = None):
        """Batched scatter-gather aggregation: bucket groupings are
        resolved ONCE over every pinned shard's value domain (so the
        shards' partials share labels), each shard reduces the batch to
        mergeable ``AggPartial``s against its pinned snapshot, and the
        partials merge in shard order.  Top-k is applied only after the
        merge: a shard-local top-k could drop a group that is globally
        top-k."""
        specs = list(specs)
        snap = snapshot or self.snapshot()
        if any(spec.group is not None and not spec.group.resolved()
               for spec in specs):
            with self._engine_stages["agg_stats"].time("plan"):
                domains = [collect_domain(t_snap.runs, t_snap.mems,
                                          self.cfg.value_width)
                           for t_snap in snap.snaps]
                domains = [d for d in domains if d.shape[0]]
                domain = (np.unique(np.concatenate(domains)) if domains
                          else np.zeros(0, f"S{self.cfg.value_width}"))
            specs = resolve_specs(specs, domain)
        per_shard = self._scan_map(
            lambda e: e[0].aggregate_partials(specs, snapshot=e[1]),
            snap.entries(), snap)
        return [finalize_partial(
                    spec, merge_partials([parts[q] for parts in per_shard]))
                for q, spec in enumerate(specs)]

    def range_lookup(self, lo: int, hi: int,
                     snapshot: Optional[ShardSnapshot] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        snap = snapshot or self.snapshot()
        hits = [i for i, up in enumerate(snap.uppers)
                if not (hi < (0 if i == 0 else snap.uppers[i - 1])
                        or lo >= up)]
        parts = self._scan_map(
            lambda i: snap.trees[i].range_lookup(lo, hi, snap.snaps[i]),
            hits, snap)
        if len(parts) == 1:
            return parts[0]
        width = self.cfg.value_width
        if not parts:
            return np.zeros(0, np.uint64), np.zeros(0, f"S{width}")
        keys = np.concatenate([p[0] for p in parts])
        vals = np.concatenate([p[1] for p in parts]).astype(f"S{width}")
        return keys, vals

    def _gather(self, results: List[FilterResult]) -> FilterResult:
        """Merge per-shard filter results: the shards partition the key
        space in order and each result is key-sorted, so concatenation is
        the global key order; one shard passes its result through."""
        if len(results) == 1:
            return results[0]
        want = np.dtype(f"S{self.cfg.value_width}")
        # every shard tree threads cfg.value_width through to its empty
        # results: a mismatch would truncate silently on the concatenation
        assert all(r.values.dtype == want for r in results), \
            [r.values.dtype for r in results]
        keys = np.concatenate([r.keys for r in results])
        vals = np.concatenate([r.values for r in results]).astype(want)
        return FilterResult(
            keys, vals,
            n_scanned=sum(r.n_scanned for r in results),
            n_matched_raw=sum(r.n_matched_raw for r in results),
        )

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def io_report(self, device: DeviceModel) -> Dict[str, float]:
        st = self.store.stats  # shared store: engine-global counters
        return {
            "read_bytes": st.bytes_read,
            "write_bytes": st.bytes_written,
            "read_ios": st.read_ios,
            "write_ios": st.write_ios,
            "modeled_read_s": device.read_seconds(st.bytes_read, st.read_ios),
            "modeled_write_s": device.write_seconds(st.bytes_written,
                                                    st.write_ios),
        }

    def shape_report(self) -> Dict[str, object]:
        agg = {c: self._retired_counts[c] for c in _COUNTERS}
        for t in self.shards:
            for c in _COUNTERS:
                agg[c] += getattr(t, c)
        return {
            "n_shards": self.n_shards,
            "n_splits": self.n_splits,
            "boundaries": self.router.uppers,
            "n_files": self.n_files,
            "disk_bytes": self.disk_bytes,
            "dict_bytes": self.dict_bytes,
            "policies": self.policies(),
            "n_policy_switches": sum(t.n_policy_switches
                                     for t in self.shards),
            "n_retunes": sum(t.tuner.n_retunes for t in self.shards
                             if t.tuner is not None),
            **agg,
            "per_shard": [t.shape_report() for t in self.shards],
        }

    def close(self) -> None:
        """Stop the pool (and with it the shared scheduler's workers),
        then close every shard tree, which syncs its WAL's tail."""
        self.executor.close()
        for t in self.shards:
            t.close()

    def __enter__(self) -> "ShardedLSM":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
