"""LSM-OPD storage engine (paper §3/§4) on the card.

Port of ``repro/core/lsm.py`` for the paper's main loop on one tree:
``put`` / ``put_batch`` / ``delete`` go into the memtable; a flush writes
OPD-encoded SCTs whose packed words and zone maps live on the card;
``filter`` / ``filter_many`` run the zone-gated fused scan on the packed
words, one launch per level; compaction merges the dictionaries on the
host and rewrites the codes, packed on the card, shaped by the compaction
policy (``core/policy.py``: leveled by default, or tiered, lazy-leveled or
hybrid, whose tiered levels stack overlapping runs; ``set_policy`` swaps
it on a live tree and ``policy_autotune`` lets a ``PolicyTuner`` do so
between compaction rounds); ``get`` is the point
lookup and ``range_lookup`` the merged range scan; ``aggregate`` /
``aggregate_many`` compute COUNT, SUM, MIN/MAX and GROUP BY on the packed
codes (``repro_torch.query``).  ``filter_backend`` 'jax_packed' (one
multi-range launch per SCT, the reference's serving path), 'jax' (one
range launch per SCT and predicate over an unpacked column) and 'numpy'
(the reference's default: the codes unpacked and compared on the host, no
kernel) are the alternatives to 'fused'; ``compaction_backend``
'jax' (the ``remap_codes`` kernel) and 'numpy' (the remap on the host) are
the alternatives to 'jax_packed'.

``codec`` 'plain', 'heavy' and 'blob' are the paper's baselines: raw
rows, rows zlib-compressed per block, and keys with pointers into
append-only value logs (``blob_compress`` compresses each log whole).  They
stay on the host, as in the reference, through writes, ``get``,
``range_lookup``, the filters, the aggregates (the general path's raw-value
pool) and compaction, and launch no kernel.  A 'blob' tree rewrites every
log past ``blob_gc_threshold`` garbage after each compaction (blob GC).
Results are bit-identical to the reference engine configured as
``LSMConfig(codec=<the same>, filter_backend=<the same>,
compaction_backend=<the same>)``.

Maintenance runs in one of the reference's two modes
(``LSMConfig.maintenance``):

  'sync'        (default) flushes and compactions run inline on the
                writer's thread.
  'background'  the active memtable rotates into a queue of frozen (still
                readable) memtables at ``mem_bytes``; a flush worker drains
                the queue and a compaction worker pays the compaction debt
                on a thread pool (``core/maintenance.py``), launching their
                kernels off the writer's thread.  The writer is throttled
                in two steps (a short sleep, then a stop) as L0 or the
                queue grows; ``drain`` waits until both workers are idle
                and the debt is zero, where every answer equals sync
                mode's.

MVCC follows the paper's file-snapshot scheme: a snapshot pins (seqno, the
memtables, the current version's runs), taken under the tree lock with the
memtables read before the version, so a flush that installs in between
shows its rows twice (the seqno merges keep one) and never not at all.
Blob GC is copy-on-write: a run whose pointers move is rebuilt and swapped
in by a replace edit, and a log is deleted only while no live snapshot
points into it.

Durability follows the reference.  With a ``spill_dir`` the store writes
every SCT and value log there, and the version set appends every edit to
``MANIFEST.log``; with ``wal_sync`` 'group' or 'every' each write is
logged to the WAL (``core/wal.py``) before it is applied, the flush seals
the WAL segment of the memtable it writes and deletes the segments its
edit covers.  ``LSMTree.restore`` rebuilds the tree after a crash at any
crash point (``repro_torch.testing``): the manifest's runs come back as
SCTs on the device, orphaned SCT files are deleted and the WAL tail above
the manifest's watermark is replayed into the memtable.  The spill format
is the port's own (``FileStore``); ``from_arrays`` trees stay in memory.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.compaction import merge_scts
from repro_torch.core.filter_exec import (FilterResult, evaluate_filter,
                                          evaluate_filter_many)
from repro_torch.core.iterator import range_scan
from repro_torch.core.maintenance import (THROTTLE_NONE, THROTTLE_SLOWDOWN,
                                          THROTTLE_STOP, MaintenanceScheduler)
from repro_torch.core.memtable import MemTable
from repro_torch.core.opd import Predicate
from repro_torch.core.policy import (POLICY_KINDS, CompactionPolicy,
                                     PolicyTuner, make_policy, run_depth)
from repro_torch.core.sct import (CODECS, SCT, BlobManager, build_sct,
                                  record_disk_bytes, sct_from_arrays)
from repro_torch.core.stats import StageStats
from repro_torch.core.version import Version, VersionEdit, VersionSet
from repro_torch.core.wal import OP_DELETE, OP_PUT, WALWriter, wal_prefix_for
from repro_torch.query.executor import evaluate_aggregates
from repro_torch.query.planner import collect_domain, resolve_specs
from repro_torch.query.spec import (AggPartial, AggResult, AggSpec,
                                    finalize_partial)
from repro_torch.storage.devices import DeviceModel
from repro_torch.storage.io import FileStore
from repro_torch.testing.crashpoints import crashpoint

# the values each enumerated configuration field takes (every value the
# reference takes); ``level_modes`` (None here) takes any vector of 'L' /
# 'T': ``make_policy`` checks it with ``compaction_policy`` and
# ``tier_runs``, raising the reference's errors
SUPPORTED = {
    "codec": CODECS,
    "filter_backend": ("fused", "jax_packed", "jax", "numpy"),
    "compaction_backend": ("numpy", "jax", "jax_packed"),
    "compaction_policy": POLICY_KINDS,
    "policy_autotune": (False, True),
    "maintenance": ("sync", "background"),
    "wal_sync": ("off", "group", "every"),
    "blob_compress": (False, True),
    "level_modes": None,
}


@dataclasses.dataclass(frozen=True)
class LSMConfig:
    """The reference's configuration fields; a value the reference does
    not take raises ``ValueError``."""

    codec: str = "opd"
    key_bytes: int = 16                # S_K
    value_width: int = 64              # S_V
    file_bytes: int = 4 * 2**20        # F
    memtable_bytes: Optional[int] = None
    size_ratio: int = 10               # T
    l0_limit: int = 4                  # L0 compaction trigger
    block_bytes: int = 4096
    bloom_bits_per_key: int = 10
    max_levels: int = 7
    blob_compress: bool = False
    blob_gc_threshold: float = 0.5
    filter_backend: str = "fused"
    compaction_backend: str = "jax_packed"
    compaction_policy: str = "leveled"
    tier_runs: int = 4
    level_modes: Optional[tuple] = None
    policy_autotune: bool = False
    maintenance: str = "sync"
    l0_slowdown: Optional[int] = None
    l0_stop: Optional[int] = None
    slowdown_seconds: float = 0.002
    max_immutables: int = 4
    wal_sync: str = "off"
    wal_group_bytes: int = 64 * 1024

    def __post_init__(self):
        for name, accepted in SUPPORTED.items():
            got = getattr(self, name)
            if accepted is not None and got not in accepted:
                raise ValueError(f"LSMConfig.{name}={got!r} is not one of "
                                 + " or ".join(map(repr, accepted)))
        make_policy(self)

    @property
    def mem_bytes(self) -> int:
        return self.memtable_bytes or self.file_bytes

    @property
    def l0_slowdown_trigger(self) -> int:
        return self.l0_slowdown if self.l0_slowdown is not None \
            else self.l0_limit + 4

    @property
    def l0_stop_trigger(self) -> int:
        return self.l0_stop if self.l0_stop is not None \
            else self.l0_limit + 8


@dataclasses.dataclass
class Snapshot:
    seqno: int
    # the active memtable and the frozen ones a flush has not installed
    # yet, newest first
    mems: List[MemTable]
    runs: List[SCT]
    version: Optional[Version] = None


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for another device; no card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA card and none is "
                           "available; pass device='cpu' to run the plain "
                           "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class LSMTree:
    def __init__(self, cfg: LSMConfig, spill_dir: Optional[str] = None,
                 device=None, store: Optional[FileStore] = None,
                 scheduler: Optional[MaintenanceScheduler] = None,
                 blob_mgr: Optional[BlobManager] = None,
                 manifest: Optional[str] = None):
        """``store`` replaces the tree's own ``FileStore(spill_dir)``
        (``restore`` passes the restored one; the sharded engine one store
        for all its shards) and ``blob_mgr`` a 'blob' tree's own manager.
        ``manifest`` names the tree's manifest log in the store's spill
        directory (shard trees sharing one need distinct names); its WAL
        segments take a prefix derived from it (``wal_prefix_for``).  With
        ``cfg.maintenance='background'`` the tree registers with
        ``scheduler``, or with a scheduler of its own (closed by
        ``close``) where none is given; a caller's scheduler is the
        caller's to close."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = store if store is not None else FileStore(spill_dir)
        # 'blob' keeps its values in logs of the tree's store ('blob_compress'
        # is ignored by the other codecs, as in the reference)
        if blob_mgr is None and cfg.codec == "blob":
            blob_mgr = BlobManager(self.store, cfg.value_width,
                                   cfg.blob_compress, cfg.blob_gc_threshold)
        self.blob_mgr: Optional[BlobManager] = blob_mgr
        self.memtable = MemTable(cfg.value_width, cfg.key_bytes)
        self.versions = VersionSet(self.store, cfg.max_levels,
                                   manifest=manifest)
        # the write-ahead log: segments in the spill directory
        self.wal: Optional[WALWriter] = None
        self.wal_replayed = 0
        if cfg.wal_sync != "off":
            if not self.store.spill_dir:
                raise ValueError("wal_sync requires a spill_dir-backed store")
            self.wal = WALWriter(
                self.store.spill_dir,
                prefix=wal_prefix_for(self.versions.manifest_name),
                sync=cfg.wal_sync, group_bytes=cfg.wal_group_bytes)
        # frozen memtables not installed yet, newest first; a flush pops
        # the oldest once its version is installed
        self._immutables: List[MemTable] = []
        # guards the memtable swap, the frozen queue and the snapshot and
        # zombie-log registries against the maintenance workers
        self._lock = threading.RLock()
        self._seqno = 0
        # the newest seqno whose write is in the memtable: snapshots read
        # it, so a write numbered (and logged) but not yet applied stays
        # out of them rather than showing up partway through a read
        self._applied = 0
        self._cursors: Dict[int, int] = {}  # round-robin compaction cursors
        # the compaction policy: an immutable value the trigger, victim and
        # output hooks consult; ``set_policy`` swaps it and later
        # compactions move the tree toward the new shape
        self.policy: CompactionPolicy = make_policy(cfg)
        self.tuner: Optional[PolicyTuner] = (
            PolicyTuner() if cfg.policy_autotune else None)
        self._owns_sched = False
        self._sched: Optional[MaintenanceScheduler] = None
        if cfg.maintenance == "background":
            if scheduler is None:
                scheduler = MaintenanceScheduler()
                self._owns_sched = True
            scheduler.register(self)
            self._sched = scheduler
        self.compaction_stats = StageStats()
        self.filter_stats = StageStats()
        self.flush_stats = StageStats()
        self.lookup_stats = StageStats()
        self.throttle_stats = StageStats()  # 'slowdown' / 'stop' stages
        self.agg_stats = StageStats()       # analytics (repro_torch.query)
        # stages of ``restore``: store, manifest, build, wal_replay
        self.restore_stats = StageStats()
        self.n_flushes = 0
        self.n_compactions = 0
        self.write_stalls = 0
        self.stall_seconds = 0.0
        self.write_slowdowns = 0
        self.slowdown_seconds = 0.0
        self.cascade_truncations = 0
        self.compaction_in_bytes = 0
        self.compaction_out_bytes = 0
        self.dict_compares = 0  # cumulative D_i terms across compactions
        self.ingest_bytes = 0   # logical bytes written (the tuner's signal)
        self.n_policy_switches = 0  # set_policy calls
        # weak references to handed-out snapshots: blob GC must not delete
        # a log a live snapshot can still read
        self._snapshots: List["weakref.ref[Snapshot]"] = []
        # logs replaced by GC, deleted one pass later while no snapshot
        # points into them
        self._zombie_blobs: List[int] = []

    @classmethod
    def from_arrays(cls, cfg: LSMConfig, levels: Sequence[Sequence[dict]],
                    seqno: int, device=None,
                    blob_logs: Optional[Dict[int, np.ndarray]] = None,
                    blob_live: Optional[Dict[int, int]] = None,
                    blob_total: Optional[Dict[int, int]] = None
                    ) -> "LSMTree":
        """A tree over SCTs given as the reference's per-SCT arrays
        (``sct_from_arrays``), ``levels[i]`` in the reference's run order,
        with the seqno watermark ``seqno`` and an empty memtable.  Every
        SCT must carry ``cfg.codec``: flushes write that codec and a merge
        takes one codec, so a tree holds one.  A 'blob' tree also takes its
        logs as ``{log id: values}``, written under the same ids (and
        compressed where ``cfg.blob_compress`` is set), and the reference
        manager's ``live`` and ``total`` tables as they stand, so that the
        next GC pass decides as the reference's would."""
        tree = cls(cfg, device=device)
        mgr = tree.blob_mgr
        if mgr is not None:
            for fid, values in sorted((blob_logs or {}).items()):
                mgr.write_log(np.asarray(values, f"S{cfg.value_width}"),
                              fid=fid)
            mgr.live, mgr.total = dict(blob_live or {}), dict(blob_total or {})
        lv = [tuple(sct_from_arrays(f, tree.device, mgr) for f in runs)
              for runs in levels]
        other = sorted({s.codec for runs in lv for s in runs} - {cfg.codec})
        if other:
            raise ValueError(f"SCTs of codec {other[0]!r} in a tree "
                             f"configured for codec {cfg.codec!r}")
        lv += [()] * (cfg.max_levels - len(lv))
        for s in (s for runs in lv for s in runs):
            tree.store.write(s, s.disk_bytes, fid=s.file_id)
        tree.versions.current = Version(tuple(lv))
        tree.versions.last_seqno = tree._seqno = tree._applied = seqno
        return tree

    # ------------------------------------------------------------------ #
    # restart
    # ------------------------------------------------------------------ #
    @classmethod
    def restore(cls, cfg: LSMConfig, spill_dir: str, device=None,
                scheduler: Optional[MaintenanceScheduler] = None,
                manifest: Optional[str] = None,
                store: Optional[FileStore] = None,
                gc_orphans: bool = True) -> "LSMTree":
        """Rebuild a tree after a crash or a restart: ``FileStore.restore``
        recovers the spilled files as host records, the manifest replay
        the tree shape and the seqno watermark, the runs it keeps are built
        as SCTs on ``device`` (the card by default) and SCT files a crash
        stranded between spill and manifest append are deleted.  A 'blob'
        tree's ``live`` and ``total`` tables are rebuilt from the runs
        (garbage ratios restart at zero).  With ``cfg.wal_sync != 'off'``
        the WAL tail is then replayed into the memtable: the records above
        the manifest's watermark, up to the first torn one, so every
        acknowledged write survives.  ``restore_stats`` times the stages
        ``store``, ``manifest`` (the replay), ``build`` and
        ``wal_replay``.  ``scheduler`` and ``manifest`` are
        ``__init__``'s.  A sharded restore passes the one ``store`` it
        restored for all its shards (``store`` then times nothing) and
        ``gc_orphans=False``: another shard's live files are not this
        tree's orphans, so the engine collects over every shard's version
        at once."""
        stats = StageStats()
        with stats.time("store"):
            if store is None:
                store = FileStore.restore(spill_dir)
        tree = cls(cfg, device=device, store=store, scheduler=scheduler,
                   manifest=manifest)
        tree.restore_stats = stats
        with stats.time("manifest"):
            tree.versions = VersionSet.recover(store, cfg.max_levels,
                                               load=tree._build_spilled,
                                               manifest=manifest)
        stats.seconds["manifest"] -= stats.seconds["build"]
        if gc_orphans:
            tree.versions.gc_orphans()
        tree._seqno = tree.versions.last_seqno
        if tree.blob_mgr is not None:
            live: Dict[int, int] = {}
            for s in tree.versions.current.all_runs():
                if s.vfids is None or not s.n:
                    continue
                fids, counts = np.unique(s.vfids[s.vfids >= 0],
                                         return_counts=True)
                for f, c in zip(fids.tolist(), counts.tolist()):
                    live[f] = live.get(f, 0) + c
            tree.blob_mgr.live = dict(live)
            tree.blob_mgr.total = dict(live)
        if cfg.wal_sync != "off":
            with stats.time("wal_replay"):
                tree._replay_wal()
        tree._applied = tree._seqno
        return tree

    def _build_spilled(self, fid: int) -> SCT:
        """The SCT of restored file ``fid`` built on the tree's device from
        the fields of its spill record (``SCT.spill_record``), and put back
        as the file's payload (compaction reads its inputs through the
        store)."""
        _tag, fields = self.store.payload(fid)
        with self.restore_stats.time("build"):
            sct = sct_from_arrays(fields, self.device, self.blob_mgr)
        self.store.put_payload(fid, sct)
        return sct

    def _replay_wal(self) -> None:
        """Reopen the WAL and replay the records the manifest's watermark
        does not cover (a crash may have raced the flush's truncation)."""
        wal, records = WALWriter.restore(
            self.store.spill_dir,
            prefix=wal_prefix_for(self.versions.manifest_name),
            sync=self.cfg.wal_sync, group_bytes=self.cfg.wal_group_bytes)
        self.wal = wal
        watermark = self.versions.last_seqno
        replayed = 0
        for rec in records:
            if rec.seqno <= watermark:
                continue
            if rec.op == OP_PUT:
                self.memtable.put(rec.key, rec.value, rec.seqno)
            else:
                self.memtable.delete(rec.key, rec.seqno)
            self._seqno = max(self._seqno, rec.seqno)
            replayed += 1
        self.wal_replayed = replayed

    def close(self) -> None:
        """Planned shutdown: an owned scheduler waits for its jobs in
        flight and stops its threads, then the WAL's tail is synced and its
        segments kept (the next ``restore`` replays them)."""
        if self._sched is not None and self._owns_sched:
            self._sched.close()
        if self.wal is not None:
            self.wal.close()

    def __enter__(self) -> "LSMTree":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # geometry
    # ------------------------------------------------------------------ #
    @property
    def levels(self) -> List[List[SCT]]:
        return [list(lvl) for lvl in self.versions.current.levels]

    @property
    def file_entries(self) -> int:
        rec = record_disk_bytes(self.cfg.codec, self.cfg.key_bytes,
                                self.cfg.value_width)
        return max(256, int(self.cfg.file_bytes / rec))

    def level_bytes(self, i: int) -> int:
        return self.versions.current.level_bytes(i)

    def level_capacity(self, i: int) -> int:
        """L1 holds T files, each deeper level T times more; T is the
        policy's (the tuner varies it), by default the configuration's."""
        return self.cfg.file_bytes * (
            self.policy.ratio(self.cfg.size_ratio) ** i)

    # ------------------------------------------------------------------ #
    # compaction policy hooks
    # ------------------------------------------------------------------ #
    def set_policy(self, policy: CompactionPolicy) -> None:
        """Swap the compaction policy.  The installed version is untouched:
        later triggers and merges rewrite the tree toward the new shape
        (stacked levels drain through whole-level merges, leveled ones
        start stacking); every read path is seqno-correct over
        overlapping runs, so readers are unaffected."""
        with self._lock:
            self.policy = policy
            self.n_policy_switches += 1

    def _mode(self, level: int) -> str:
        """'L' (one sorted run) or 'T' (stacked runs) for one level."""
        return self.policy.mode(level, self.cfg.max_levels)

    def _l0_trigger(self) -> int:
        return self.policy.l0_trigger(self.cfg.l0_limit)

    def _level_pressure(self, i: int) -> float:
        """Compaction urgency of level i under the policy (0: in shape).
        Leveled: bytes over capacity, plus any run depth past 1 (stacked
        runs a migration left, or ``from_arrays``'s).  Tiered: run depth
        past K-1, plus bytes past 4x capacity (a safety valve against a
        mis-sized K)."""
        v = self.versions.current
        if not v.levels[i]:
            return 0.0
        over = self.level_bytes(i) / self.level_capacity(i) - 1.0
        depth = run_depth(v.levels[i])
        if self._mode(i) == "T":
            pressure = float(max(0, depth - (self.policy.tier_runs - 1)))
            if over > 3.0:
                pressure += over - 3.0
            return pressure
        pressure = max(0.0, over)
        if depth > 1:
            pressure += float(depth - 1)
        return pressure

    @property
    def dict_bytes(self) -> int:
        return sum(s.dict_nbytes for s in self.versions.current.all_runs())

    @property
    def n_files(self) -> int:
        return self.versions.current.n_files

    @property
    def disk_bytes(self) -> int:
        """The runs' bytes, and a 'blob' tree's logs that runs point into."""
        total = sum(s.disk_bytes for s in self.versions.current.all_runs())
        if self.blob_mgr is not None:
            total += sum(self.store.size_of(f)
                         for f in self.blob_mgr.live_fids()
                         if self.store.contains(f))
        return total

    def all_runs(self) -> List[SCT]:
        """L0 runs newest first, then L1..Ln."""
        return self.versions.current.all_runs()

    # ------------------------------------------------------------------ #
    # writes
    # ------------------------------------------------------------------ #
    def put(self, key: int, value: bytes) -> None:
        self.raise_maintenance_errors()
        self._seqno += 1
        self.ingest_bytes += self.cfg.key_bytes + 8 + self.cfg.value_width
        if self.wal is not None:
            # log before apply: the record is on its way to disk before
            # the memtable can serve it
            self.wal.append(OP_PUT, key, self._seqno, value)
        self.memtable.put(key, value, self._seqno)
        self._applied = self._seqno
        self._after_write()

    def put_batch(self, keys: np.ndarray, values) -> None:
        """Bulk insertion: rows go into the memtable in columnar runs cut
        where the memtable fills, so flushes land exactly where per-row
        ``put`` calls would put them.  With a WAL each run's records are
        appended one at a time, in seqno order, before the run is applied,
        and the whole batch is acknowledged by one sync at the end (the
        group-commit barrier), as the reference's per-record loop does.
        In background mode each cut rotates the memtable and may throttle
        the writer."""
        self.raise_maintenance_errors()
        raw = values
        keys = np.asarray(keys, np.uint64)
        values = np.asarray(values, f"S{self.cfg.value_width}")
        rec = self.cfg.key_bytes + 8 + self.cfg.value_width
        self.ingest_bytes += keys.shape[0] * rec
        i = 0
        while i < keys.shape[0]:
            room = -(-(self.cfg.mem_bytes - self.memtable.approx_bytes) // rec)
            j = min(keys.shape[0], i + max(1, room))
            first = self._seqno + 1
            if self.wal is not None:
                vals = raw[i:j]
                vals = (vals.tolist() if isinstance(vals, np.ndarray)
                        else [bytes(v) for v in vals])
                for k, v in zip(keys[i:j].tolist(), vals):
                    self._seqno += 1
                    self.wal.append(OP_PUT, k, self._seqno, v)
            self._seqno = first - 1 + (j - i)
            self.memtable.put_many(
                keys[i:j], np.arange(first, self._seqno + 1, dtype=np.uint64),
                values[i:j])
            self._applied = self._seqno
            self._after_write()
            i = j
        if self.wal is not None:
            self.wal.sync()

    def delete(self, key: int) -> None:
        self.raise_maintenance_errors()
        self._seqno += 1
        self.ingest_bytes += self.cfg.key_bytes + 8
        if self.wal is not None:
            self.wal.append(OP_DELETE, key, self._seqno)
        self.memtable.delete(key, self._seqno)
        self._applied = self._seqno
        self._after_write()

    def raise_maintenance_errors(self, consume: bool = True) -> None:
        """Raise a background worker's failure as ``MaintenanceError``.
        Every write runs it first, consuming the failure, rather than
        accept writes a dead flush pipeline would never persist; a
        read-only caller (``ScanServer.step``) passes ``consume=False``,
        so it does not serve over failed maintenance and the writer still
        sees the failure."""
        if self._sched is not None:
            self._sched.check_errors(consume)

    # ------------------------------------------------------------------ #
    # replication apply (follower side; repro_torch.replica)
    # ------------------------------------------------------------------ #
    def replicate(self, records) -> int:
        """Follower apply path: install the leader's WAL records through
        this tree's own WAL, memtable, flush and compaction.

        Seqnos come from the leader (a follower assigns none of its own),
        so ``_seqno`` is the follower's contiguous applied watermark.
        Records at or below it are skipped (a resume after a partition
        re-ships from the watermark, and duplicates must be harmless); a
        gap above it raises, since applying past a hole would break the
        prefix every failover differential holds.  Each record sets
        ``_applied`` as well, so a snapshot of the follower sees it.
        Returns the number of records newly applied."""
        applied = 0
        for rec in records:
            if rec.seqno <= self._seqno:
                continue   # duplicate from a resume: already applied
            if rec.seqno != self._seqno + 1:
                raise ValueError(
                    f"replication gap: applied through {self._seqno}, "
                    f"next shipped record is {rec.seqno}")
            self.raise_maintenance_errors()
            crashpoint("apply.record")
            if self.wal is not None:
                self.wal.append(rec.op, rec.key, rec.seqno, rec.value)
            if rec.op == OP_PUT:
                self.ingest_bytes += (self.cfg.key_bytes + 8
                                      + self.cfg.value_width)
                self.memtable.put(rec.key, rec.value, rec.seqno)
            elif rec.op == OP_DELETE:
                self.ingest_bytes += self.cfg.key_bytes + 8
                self.memtable.delete(rec.key, rec.seqno)
            else:
                raise ValueError(f"unknown WAL op {rec.op!r}")
            self._seqno = self._applied = rec.seqno
            applied += 1
            self._after_write()
        if applied and self.wal is not None:
            # one group barrier per shipped batch: the follower's durable
            # watermark (its promotion floor) advances with delivery
            self.wal.sync()
        return applied

    def _after_write(self) -> None:
        if self.memtable.approx_bytes >= self.cfg.mem_bytes:
            self._handle_full_memtable()

    def _handle_full_memtable(self) -> None:
        if self._sched is None:
            self._sync_flush()
        else:
            self._rotate_memtable()
            self._sched.throttle(self)

    def _rotate_memtable(self) -> None:
        """Freeze a non-empty active memtable into the queue of frozen ones
        and seal its WAL segment under the same lock, so segment k holds
        exactly memtable k's records; in background mode schedule its
        flush.  A frozen memtable stays readable until its SCTs are in an
        installed version."""
        with self._lock:
            if self.memtable.n_versions == 0:
                return
            self._immutables.insert(0, self.memtable)
            self.memtable = MemTable(self.cfg.value_width, self.cfg.key_bytes)
            if self.wal is not None:
                self.wal.rotate()
        if self._sched is not None:
            self._sched.schedule_flush(self)

    def flush(self) -> None:
        """Sync mode: freeze + OPD-encode + write to L0, then compact if L0
        is over its trigger (the forced write stall).  Background mode:
        rotate the active memtable and return; ``drain`` is the barrier."""
        if self._sched is None:
            self._sync_flush()
        else:
            self._rotate_memtable()

    def _sync_flush(self) -> None:
        if self.memtable.n_versions == 0 and not self._immutables:
            return
        self._rotate_memtable()
        while self._flush_oldest_immutable():
            pass
        if len(self.versions.current.levels[0]) > self._l0_trigger():
            self.write_stalls += 1
            t0 = time.perf_counter()
            self._compact_l0()
            self._cascade()
            self.stall_seconds += time.perf_counter() - t0

    def _pending_flushes(self) -> int:
        return len(self._immutables)

    def _flush_oldest_immutable(self) -> bool:
        """Encode and install the oldest frozen memtable (inline in sync
        mode, on the flush worker in background mode); it leaves the
        readable queue only after its version is installed, so a reader
        sees its rows in one place or both, never in neither."""
        with self._lock:
            if not self._immutables:
                return False
            imm = self._immutables[-1]
        frozen = imm.freeze()
        fe = self.file_entries
        new: List[SCT] = []
        try:
            with self.flush_stats.time("encode"):
                for lo in range(0, frozen.n, fe):
                    hi = min(lo + fe, frozen.n)
                    new.append(build_sct(
                        keys=frozen.keys[lo:hi], seqnos=frozen.seqnos[lo:hi],
                        tombs=frozen.tombs[lo:hi],
                        raw_values=frozen.values[lo:hi],
                        level=0, key_bytes=self.cfg.key_bytes,
                        value_width=self.cfg.value_width,
                        block_bytes=self.cfg.block_bytes,
                        bloom_bits_per_key=self.cfg.bloom_bits_per_key,
                        store=self.store, device=self.device,
                        codec=self.cfg.codec, blob_mgr=self.blob_mgr))
                    crashpoint("flush.mid_spill")
        except Exception:
            # no version references the chunks spilled so far: delete them
            # before re-raising (the memtable stays queued, and a retry
            # encodes it whole).  Not on a SimulatedCrash: a kill leaves
            # them for the restore's orphan collection.
            for s in new:
                self.store.delete(s.file_id)
            raise
        last = int(frozen.seqnos.max())
        crashpoint("flush.before_manifest")
        # adds listed oldest-chunk-first; L0 prepends them reversed
        self.versions.apply(VersionEdit(adds=[(0, s) for s in new],
                                        last_seqno=last))
        crashpoint("flush.after_manifest")
        with self._lock:
            self._immutables.pop()
        if self.wal is not None:
            # every record <= last is reachable through the manifest now
            self.wal.truncate_upto(last)
        self.n_flushes += 1
        return True

    def drain(self, timeout: float = 120.0) -> None:
        """Barrier: wait until every queued flush is installed and the
        compaction debt is paid (background mode; ``TimeoutError`` after
        ``timeout`` seconds).  In sync mode nothing is ever queued, so it
        returns at once."""
        if self._sched is not None:
            self._sched.drain([self], timeout=timeout)

    def compact(self) -> None:
        """Full maintenance pass: flush, fold L0 into L1, cascade.  In
        background mode the workers are drained first, so the fold runs
        inline with no worker compacting beside it."""
        self.flush()
        if self._sched is not None:
            self._sched.drain([self])
        self._force_compact_inline()
        self._maybe_retune()

    def _force_compact_inline(self) -> None:
        """Fold L0 into L1 and cascade, inline.  A background caller drains
        first, so no worker job compacts the tree beside it
        (``ShardedLSM.compact_all``)."""
        if self.versions.current.levels[0]:
            self._compact_l0()
        self._cascade()

    def _maybe_retune(self) -> None:
        """The policy tuner's hook between compaction rounds (sync: the
        end of ``compact``; background: the compaction worker once the
        debt is zero); a no-op while the tree has no tuner."""
        if self.tuner is not None:
            self.tuner.maybe_retune(self)

    # ------------------------------------------------------------------ #
    # compaction scheduling (policy-driven; paper Figure 2 for leveling)
    # ------------------------------------------------------------------ #
    def _merge_is_bottom(self, inputs: List[SCT], out_level: int) -> bool:
        """Tombstones may be dropped only if no run outside the inputs can
        hold an older version of an input key: every deeper level is empty
        and no surviving run at ``out_level`` overlaps the inputs' key span
        (a stacked run left beside a tiered merge keeps them)."""
        v = self.versions.current
        if any(len(v.levels[j])
               for j in range(out_level + 1, self.cfg.max_levels)):
            return False
        live = [s for s in inputs if s.n]
        if not live:
            return True
        lo = min(s.min_key for s in live)
        hi = max(s.max_key for s in live)
        consumed = {s.file_id for s in inputs}
        return all(s.file_id in consumed or not s.n or not s.overlaps(lo, hi)
                   for s in v.levels[out_level])

    def _compaction_debt(self) -> float:
        """The background scheduler's debt: L0 runs past the trigger (each
        one a run every read consults) plus each level's pressure."""
        v = self.versions.current
        debt = float(max(0, len(v.levels[0]) - self._l0_trigger()))
        for i in range(1, self.cfg.max_levels - 1):
            debt += self._level_pressure(i)
        return debt

    def _compact_one_step(self) -> bool:
        """One merge of the compaction worker: L0 first when it is over its
        trigger (it taxes every read), else one step at the level of the
        highest pressure; False when there is no debt."""
        v = self.versions.current
        if len(v.levels[0]) > self._l0_trigger():
            self._compact_l0()
            return True
        best, best_over = None, 0.0
        for i in range(1, self.cfg.max_levels - 1):
            over = self._level_pressure(i)
            if over > best_over:
                best, best_over = i, over
        if best is None:
            return False
        self._compact_level_step(best)
        return True

    def _throttle_level(self) -> int:
        """The writer's graduated backpressure: a stop past
        ``l0_stop_trigger`` L0 runs or ``max_immutables`` frozen
        memtables, a slowdown past ``l0_slowdown_trigger`` runs or with
        half the frozen queue full (so the sleeps hand the GIL to the
        workers well before the stop).  The gates keep their offsets above
        the policy's L0 trigger."""
        if self._sched is None:
            return THROTTLE_NONE
        l0_trig = self._l0_trigger()
        stop_at = l0_trig + (self.cfg.l0_stop_trigger - self.cfg.l0_limit)
        slow_at = l0_trig + (self.cfg.l0_slowdown_trigger
                             - self.cfg.l0_limit)
        n_l0 = len(self.versions.current.levels[0])
        n_imm = len(self._immutables)
        if n_l0 >= stop_at or n_imm > self.cfg.max_immutables:
            return THROTTLE_STOP
        if n_l0 >= slow_at \
                or n_imm >= max(1, self.cfg.max_immutables // 2):
            return THROTTLE_SLOWDOWN
        return THROTTLE_NONE

    def _compact_l0(self) -> None:
        v = self.versions.current
        inputs = list(v.levels[0])
        if not inputs:
            return
        if self._mode(1) == "T":
            # tiering: the merged L0 runs become one new run stacked on L1;
            # nothing at L1 is consumed (the write saving)
            self._run_merge(inputs, out_level=1, drop_in=[(0, inputs)],
                            stacked=True)
            return
        lo = min(s.min_key for s in inputs)
        hi = max(s.max_key for s in inputs)
        overlaps = [s for s in v.levels[1] if s.overlaps(lo, hi)]
        self._run_merge(inputs + overlaps, out_level=1,
                        drop_in=[(0, inputs), (1, overlaps)])

    def _compact_level_step(self, i: int) -> None:
        """One step at level i, shaped by the policy.  A leveled level of
        one sorted run: a round-robin victim file and its overlaps below.
        A tiered level, or a leveled one still holding stacked runs from a
        migration: the whole level merged K-way into one run below, stacked
        there if that level is tiered (and not the last), else folded into
        its sorted run."""
        v = self.versions.current
        runs = list(v.levels[i])
        if not runs:
            return
        if not (self._mode(i) == "T" or run_depth(runs) > 1):
            victim = self._pick_victim(i)
            if victim is None:
                return
            overlaps = [s for s in v.levels[i + 1]
                        if s.overlaps(victim.min_key, victim.max_key)]
            self._run_merge([victim] + overlaps, out_level=i + 1,
                            drop_in=[(i, [victim]), (i + 1, overlaps)])
            return
        if self._mode(i + 1) == "T" and i + 1 < self.cfg.max_levels - 1:
            self._run_merge(runs, out_level=i + 1, drop_in=[(i, runs)],
                            stacked=True)
            return
        lo = min(s.min_key for s in runs if s.n)
        hi = max(s.max_key for s in runs if s.n)
        overlaps = [s for s in v.levels[i + 1] if s.overlaps(lo, hi)]
        self._run_merge(runs + overlaps, out_level=i + 1,
                        drop_in=[(i, runs), (i + 1, overlaps)])

    def _cascade(self) -> None:
        for i in range(1, self.cfg.max_levels - 1):
            guard = 0
            while self.versions.current.levels[i] \
                    and self._level_pressure(i) > 0.0:
                self._compact_level_step(i)
                guard += 1
                if guard > 64:
                    self.cascade_truncations += 1
                    warnings.warn(
                        f"cascade truncated at level {i} after {guard} "
                        f"merges (level still {self.level_bytes(i)}B over "
                        f"{self.level_capacity(i)}B capacity)",
                        RuntimeWarning, stacklevel=2)
                    break

    def _pick_victim(self, level: int) -> Optional[SCT]:
        runs = self.versions.current.levels[level]
        if not runs:
            return None
        cur = self._cursors.get(level, 0) % len(runs)
        self._cursors[level] = cur + 1
        return runs[cur]

    def _run_merge(self, inputs: List[SCT], out_level: int,
                   drop_in: List[tuple], stacked: bool = False) -> None:
        """K-way merge ``inputs`` into ``out_level``; ``stacked`` installs
        the output as one new run prepended (newest first) at a tiered
        level instead of folding it into the sorted layout."""
        res = merge_scts(
            inputs, out_level=out_level,
            is_bottom=self._merge_is_bottom(inputs, out_level),
            file_entries=self.file_entries, store=self.store,
            stats=self.compaction_stats, device=self.device,
            blob_mgr=self.blob_mgr, block_bytes=self.cfg.block_bytes,
            bloom_bits_per_key=self.cfg.bloom_bits_per_key,
            backend=self.cfg.compaction_backend)
        self.n_compactions += 1
        self.dict_compares += res.dict_compares
        self.compaction_in_bytes += sum(s.disk_bytes for s in inputs)
        self.compaction_out_bytes += sum(s.disk_bytes for s in res.outputs)
        crashpoint("compact.before_manifest")
        self.versions.apply(VersionEdit(
            adds=[(out_level, s) for s in res.outputs],
            drops=[(lvl, s.file_id) for lvl, gone in drop_in for s in gone],
            stacked=[out_level] if stacked else []))
        crashpoint("compact.after_manifest")
        # inputs leave the store only after the edit is logged: a crash in
        # between leaves orphans (collected on restore), never a dangling
        # reference
        for _, gone in drop_in:
            for s in gone:
                self.store.delete(s.file_id)
        if self.blob_mgr is not None:
            self._gc_blobs()

    # ------------------------------------------------------------------ #
    # blob GC (copy-on-write)
    # ------------------------------------------------------------------ #
    def _pinned_blob_fids(self) -> Set[int]:
        """Logs a live snapshot's runs point into.  Snapshots hold their SCTs
        directly, but the values live in the store, so GC must not delete
        these logs.  Dead references are pruned here: a released snapshot
        frees its logs at the next GC pass."""
        pinned: Set[int] = set()
        for snap in self._live_snapshots():
            for s in snap.runs:
                if s.vfids is not None and s.n:
                    pinned.update(f for f in np.unique(s.vfids).tolist()
                                  if f >= 0)
        return pinned

    def _live_snapshots(self) -> List[Snapshot]:
        """The handed-out snapshots still alive; the registry forgets the
        others (under the tree lock: a reader may register one while the
        compaction worker's GC prunes)."""
        with self._lock:
            snaps = [s for s in (r() for r in self._snapshots)
                     if s is not None]
            self._snapshots = [weakref.ref(s) for s in snaps]
        return snaps

    def _gc_blobs(self) -> None:
        """Rewrite every log past the garbage threshold that no live
        snapshot pins (BlobDB GC), copy-on-write: its live values go to a
        new log, each run pointing into it is rebuilt with the new pointers
        under a new id and swapped in by one replace edit, and the old log
        is deleted one pass later, while no snapshot pins it.  A log no run
        points into any more is deleted at once."""
        pinned = self._pinned_blob_fids()
        with self._lock:
            zombies, self._zombie_blobs = self._zombie_blobs, []
        survivors = []
        for fid in zombies:
            if fid in pinned:
                survivors.append(fid)
            else:
                self.store.delete(fid)
        with self._lock:
            self._zombie_blobs.extend(survivors)
        mgr = self.blob_mgr
        for fid in mgr.gc_candidates():
            if fid in pinned:
                continue
            refs = []   # (level, run, its entries pointing into the log)
            for i, lvl in enumerate(self.versions.current.levels):
                for s in lvl:
                    sel = np.nonzero(s.vfids == fid)[0]
                    if sel.shape[0]:
                        refs.append((i, s, sel))
            self.store.stats.add_read(self.store.size_of(fid), 1)
            if not refs:
                self.store.delete(fid)
                mgr.forget(fid)
                continue
            values = mgr.log_values(fid)
            new_vals = np.concatenate(
                [values[s.vptrs[sel].astype(np.int64)] for _, s, sel in refs])
            new_fid, _ = mgr.append(new_vals)
            crashpoint("gc.mid_blob")
            replaces, off = [], 0
            for lvl, s, sel in refs:
                vfids, vptrs = s.vfids.copy(), s.vptrs.copy()
                vfids[sel] = new_fid
                vptrs[sel] = np.arange(off, off + sel.shape[0],
                                       dtype=np.uint64)
                off += sel.shape[0]
                new = dataclasses.replace(s, vfids=vfids, vptrs=vptrs,
                                          facts={})
                new.file_id = self.store.alloc_id()
                self.store.write(new, new.disk_bytes, fid=new.file_id)
                replaces.append((lvl, s.file_id, new))
            self.versions.apply(VersionEdit(replaces=replaces))
            crashpoint("gc.after_replace")
            for _, s, _ in refs:
                self.store.delete(s.file_id)
            mgr.forget(fid)
            with self._lock:
                self._zombie_blobs.append(fid)
            mgr.gc_runs += 1
            mgr.gc_bytes_rewritten += int(new_vals.nbytes)

    # ------------------------------------------------------------------ #
    # reads
    # ------------------------------------------------------------------ #
    def _read_state(self) -> Tuple[int, List[MemTable], Version]:
        """(the applied seqno, the memtables newest first, the current
        version), taken under the tree lock with the memtables before the
        version: a flush installing in between shows its rows in both (the
        seqno merges keep one), never in neither."""
        with self._lock:
            return (self._applied, [self.memtable] + list(self._immutables),
                    self.versions.current)

    def snapshot(self) -> Snapshot:
        with self._lock:
            seqno, mems, v = self._read_state()
            snap = Snapshot(seqno, mems, v.all_runs(), version=v)
            if self.blob_mgr is not None:
                # registered in the lock section that read the version:
                # a compaction and blob GC in between would not see the
                # snapshot and could delete a log its runs point into.
                # The registry feeds GC's pinning only; pruned on the way
                # in, it never grows past the live snapshots
                self._live_snapshots()
                self._snapshots.append(weakref.ref(snap))
        return snap

    def get(self, key: int, snapshot: Optional[Snapshot] = None) -> Optional[bytes]:
        """point_lookup: memtable, then every candidate run; the newest
        visible version across runs wins."""
        if snapshot is not None:
            snap_seq: Optional[int] = snapshot.seqno
            mems, runs = snapshot.mems, snapshot.runs
        else:
            snap_seq = None
            _, mems, version = self._read_state()
            runs = version.all_runs()
        with self.lookup_stats.time("lookup"):
            for mem in mems:   # newest first; the first hit decides
                got = mem.get(key, snap_seq)
                if got is not None:
                    return got[1]
            k = np.uint64(key)
            best_seq = -1
            best = None
            for s in runs:
                if s.n == 0 or not (s.min_key <= key <= s.max_key):
                    continue
                _b_lo, _b_hi, maybe = s.blocks.probe_range(k)
                if not maybe:
                    continue
                # the block is fetched to search it: bloom false positives
                # are real I/O too
                self.store.stats.add_read(self.cfg.block_bytes, 1)
                epb = s.blocks.entries_per_block
                pos = int(np.searchsorted(s.keys, k, side="left"))
                cur_blk = pos // epb
                while pos < s.n and s.keys[pos] == k:
                    if pos // epb != cur_blk:
                        cur_blk = pos // epb
                        self.store.stats.add_read(self.cfg.block_bytes, 1)
                    if snap_seq is None or s.seqnos[pos] <= snap_seq:
                        seq = int(s.seqnos[pos])
                        if seq > best_seq:
                            best_seq = seq
                            best = None if s.tombs[pos] else (s, pos)
                        break
                    pos += 1
            if best is None:
                return None
            return best[0].value_at(best[1])

    def range_lookup(self, lo: int, hi: int,
                     snapshot: Optional[Snapshot] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Newest visible (keys, values) with lo <= key <= hi, tombstones
        elided (the merged range scan)."""
        snap = snapshot or self.snapshot()
        return range_scan(
            snap.runs, snap.mems, lo, hi, stats=self.lookup_stats,
            store=self.store, snapshot_seqno=snap.seqno,
            block_bytes=self.cfg.block_bytes)

    def filter(self, pred: Predicate,
               snapshot: Optional[Snapshot] = None) -> FilterResult:
        snap = snapshot or self.snapshot()
        return evaluate_filter(
            snap.runs, snap.mems, pred, stats=self.filter_stats,
            store=self.store, snapshot_seqno=snap.seqno,
            backend=self.cfg.filter_backend,
            value_width=self.cfg.value_width)

    def filter_many(self, preds: List[Predicate],
                    snapshot: Optional[Snapshot] = None) -> List[FilterResult]:
        """Batched filter against one snapshot: all predicates share one
        pass over each run's codes ('fused': one zone-gated launch per
        level; 'jax_packed': one launch per run)."""
        snap = snapshot or self.snapshot()
        return evaluate_filter_many(
            snap.runs, snap.mems, preds, stats=self.filter_stats,
            store=self.store, snapshot_seqno=snap.seqno,
            backend=self.cfg.filter_backend,
            value_width=self.cfg.value_width)

    # ------------------------------------------------------------------ #
    # analytics pushdown (aggregates on packed codes; repro_torch.query)
    # ------------------------------------------------------------------ #
    def aggregate(self, spec: AggSpec,
                  snapshot: Optional[Snapshot] = None) -> AggResult:
        """One aggregate against a consistent snapshot."""
        return self.aggregate_many([spec], snapshot)[0]

    def aggregate_many(self, specs: Sequence[AggSpec],
                       snapshot: Optional[Snapshot] = None) -> List[AggResult]:
        """Batched aggregates against one snapshot: on a quiescent tree the
        scalar specs share one ``fused_zone_agg`` launch per level and each
        GROUP BY one ``zone_histogram`` launch; otherwise the fused filter
        feeds the visibility merge."""
        snap = snapshot or self.snapshot()
        specs = self._resolve_agg_specs(specs, snap)
        parts = self._aggregate_partials(specs, snap)
        return [finalize_partial(spec, part)
                for spec, part in zip(specs, parts)]

    def aggregate_partials(self, specs: Sequence[AggSpec],
                           snapshot: Optional[Snapshot] = None
                           ) -> List[AggPartial]:
        """Mergeable per-tree partials.  Specs must arrive resolved (bucket
        edges fixed over every tree whose partials are merged)."""
        snap = snapshot or self.snapshot()
        return self._aggregate_partials(specs, snap)

    def _aggregate_partials(self, specs, snap: Snapshot) -> List[AggPartial]:
        return evaluate_aggregates(
            snap.runs, snap.mems, specs, stats=self.agg_stats,
            store=self.store, snapshot_seqno=snap.seqno,
            backend=self.cfg.filter_backend,
            value_width=self.cfg.value_width)

    def _resolve_agg_specs(self, specs, snap: Snapshot) -> List[AggSpec]:
        specs = list(specs)
        if all(spec.group is None or spec.group.resolved()
               for spec in specs):
            return specs
        with self.agg_stats.time("plan"):
            domain = collect_domain(snap.runs, snap.mems,
                                    self.cfg.value_width)
        return resolve_specs(specs, domain)

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def io_report(self, device: DeviceModel) -> Dict[str, float]:
        """The store's I/O counts and their modeled seconds on ``device``
        (``repro_torch.storage.devices``)."""
        st = self.store.stats
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
        v = self.versions.current
        return {
            "levels": [len(l) for l in v.levels],
            "level_bytes": [v.level_bytes(i) for i in range(self.cfg.max_levels)],
            "run_depths": [run_depth(l) for l in v.levels],
            "policy": self.policy.describe(),
            "n_policy_switches": self.n_policy_switches,
            "n_retunes": self.tuner.n_retunes if self.tuner else 0,
            "n_files": self.n_files,
            "disk_bytes": self.disk_bytes,
            "dict_bytes": self.dict_bytes,
            "n_flushes": self.n_flushes,
            "n_compactions": self.n_compactions,
            "write_stalls": self.write_stalls,
            "stall_seconds": self.stall_seconds,
            "write_slowdowns": self.write_slowdowns,
            "slowdown_seconds": self.slowdown_seconds,
            "cascade_truncations": self.cascade_truncations,
            "dict_compares": self.dict_compares,
            "version": v.vid,
            "n_immutables": len(self._immutables),
            "maintenance": self.cfg.maintenance,
            "wal_sync": self.cfg.wal_sync,
            "wal_appends": self.wal.appends if self.wal else 0,
            "wal_syncs": self.wal.syncs if self.wal else 0,
            "wal_bytes": self.wal.bytes_written if self.wal else 0,
            "wal_replayed": self.wal_replayed,
        }
