"""LSM-OPD storage engine (paper §3/§4) on the card.

Port of ``repro/core/lsm.py`` for the paper's main loop on one tree:
``put`` / ``put_batch`` / ``delete`` go into the memtable; a flush writes
OPD-encoded SCTs whose packed words and zone maps live on the card;
``filter`` / ``filter_many`` run the zone-gated fused scan on the packed
words, one launch per level; leveled compaction merges the dictionaries on
the host and rewrites the codes, packed on the card; ``get`` is the point
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

Maintenance is synchronous: flushes and compactions run inline on the
writer's thread.  MVCC follows the paper's file-snapshot scheme: a snapshot
pins (seqno, memtable, the current version's runs).  Blob GC is
copy-on-write: a run whose pointers move is rebuilt and swapped in by a
replace edit, and a log is deleted only while no live snapshot points into
it.
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.core.memtable import MemTable
from repro_torch.core.opd import Predicate
from repro_torch.core.policy import CompactionPolicy, make_policy, run_depth
from repro_torch.core.sct import (CODECS, SCT, BlobManager, build_sct,
                                  record_disk_bytes, sct_from_arrays)
from repro_torch.core.stats import StageStats
from repro_torch.core.version import Version, VersionEdit, VersionSet
from repro_torch.query.executor import evaluate_aggregates
from repro_torch.query.planner import collect_domain, resolve_specs
from repro_torch.query.spec import (AggPartial, AggResult, AggSpec,
                                    finalize_partial)
from repro_torch.storage.io import FileStore

# the values each configuration field takes in this slice, and the ROADMAP
# item that ports the others (kernels named by their function); None where
# the port takes every value the reference takes
SUPPORTED = {
    "codec": (CODECS, None),
    "filter_backend": (("fused", "jax_packed", "jax", "numpy"), None),
    "compaction_backend": (("numpy", "jax", "jax_packed"), None),
    "compaction_policy": (("leveled",), "§1 policy"),
    "policy_autotune": ((False,), "§1 policy"),
    "maintenance": (("sync",), "§1 durability and maintenance"),
    "wal_sync": (("off",), "§1 durability and maintenance"),
    "blob_compress": ((False, True), None),
    "level_modes": ((None,), "§1 policy"),
}


@dataclasses.dataclass(frozen=True)
class LSMConfig:
    """The reference's configuration fields; values outside this slice
    raise ``ValueError`` naming the ROADMAP item that will port them, and
    values the reference does not take raise as well."""

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
        for name, (accepted, item) in SUPPORTED.items():
            got = getattr(self, name)
            if got in accepted:
                continue
            takes = " or ".join(map(repr, accepted))
            if item is None:
                raise ValueError(f"LSMConfig.{name}={got!r} is not one of "
                                 f"{takes}")
            raise ValueError(
                f"LSMConfig.{name}={got!r} is not ported yet (this port "
                f"supports {takes}); see ROADMAP {item}")

    @property
    def mem_bytes(self) -> int:
        return self.memtable_bytes or self.file_bytes


@dataclasses.dataclass
class Snapshot:
    seqno: int
    memtable: MemTable
    runs: List[SCT]
    version: Optional[Version] = None

    @property
    def mems(self) -> List[MemTable]:
        return [self.memtable]


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
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = FileStore(spill_dir)
        # 'blob' keeps its values in logs of the tree's store ('blob_compress'
        # is ignored by the other codecs, as in the reference)
        self.blob_mgr: Optional[BlobManager] = (
            BlobManager(self.store, cfg.value_width, cfg.blob_compress,
                        cfg.blob_gc_threshold)
            if cfg.codec == "blob" else None)
        self.memtable = MemTable(cfg.value_width, cfg.key_bytes)
        self.versions = VersionSet(cfg.max_levels)
        self._seqno = 0
        self._cursors: Dict[int, int] = {}  # round-robin compaction cursors
        self.policy: CompactionPolicy = make_policy(cfg)
        self.compaction_stats = StageStats()
        self.filter_stats = StageStats()
        self.flush_stats = StageStats()
        self.lookup_stats = StageStats()
        self.agg_stats = StageStats()       # analytics (repro_torch.query)
        self.n_flushes = 0
        self.n_compactions = 0
        self.write_stalls = 0
        self.stall_seconds = 0.0
        self.cascade_truncations = 0
        self.compaction_in_bytes = 0
        self.compaction_out_bytes = 0
        self.dict_compares = 0  # cumulative D_i terms across compactions
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
        tree.versions = VersionSet(cfg.max_levels, Version(tuple(lv)),
                                   last_seqno=seqno)
        tree._seqno = seqno
        return tree

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
        return self.cfg.file_bytes * self.cfg.size_ratio ** i

    def _l0_trigger(self) -> int:
        return self.policy.l0_trigger(self.cfg.l0_limit)

    def _level_pressure(self, i: int) -> float:
        """Compaction urgency of leveled level i: bytes over capacity, plus
        any run depth past 1 (overlapping runs, e.g. from ``from_arrays``)."""
        v = self.versions.current
        if not v.levels[i]:
            return 0.0
        pressure = max(0.0, self.level_bytes(i) / self.level_capacity(i) - 1.0)
        depth = run_depth(v.levels[i])
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
            total += sum(self.store.size_of(f) for f in self.blob_mgr.live)
        return total

    def all_runs(self) -> List[SCT]:
        """L0 runs newest first, then L1..Ln."""
        return self.versions.current.all_runs()

    # ------------------------------------------------------------------ #
    # writes
    # ------------------------------------------------------------------ #
    def put(self, key: int, value: bytes) -> None:
        self._seqno += 1
        self.memtable.put(key, value, self._seqno)
        self._after_write()

    def put_batch(self, keys: np.ndarray, values) -> None:
        """Bulk insertion: rows go into the memtable in columnar runs cut
        where the memtable fills, so flushes land exactly where per-row
        ``put`` calls would put them."""
        keys = np.asarray(keys, np.uint64)
        values = np.asarray(values, f"S{self.cfg.value_width}")
        rec = self.cfg.key_bytes + 8 + self.cfg.value_width
        i = 0
        while i < keys.shape[0]:
            room = -(-(self.cfg.mem_bytes - self.memtable.approx_bytes) // rec)
            j = min(keys.shape[0], i + max(1, room))
            seqs = np.arange(self._seqno + 1, self._seqno + 1 + (j - i),
                             dtype=np.uint64)
            self.memtable.put_many(keys[i:j], seqs, values[i:j])
            self._seqno += j - i
            self._after_write()
            i = j

    def delete(self, key: int) -> None:
        self._seqno += 1
        self.memtable.delete(key, self._seqno)
        self._after_write()

    def _after_write(self) -> None:
        if self.memtable.approx_bytes >= self.cfg.mem_bytes:
            self.flush()

    def flush(self) -> None:
        """Freeze + OPD-encode + write to L0, then compact if L0 is over
        its trigger (the forced write stall)."""
        if self.memtable.n_versions == 0:
            return
        frozen = self.memtable.freeze()
        self.memtable = MemTable(self.cfg.value_width, self.cfg.key_bytes)
        fe = self.file_entries
        new: List[SCT] = []
        with self.flush_stats.time("encode"):
            for lo in range(0, frozen.n, fe):
                hi = min(lo + fe, frozen.n)
                new.append(build_sct(
                    keys=frozen.keys[lo:hi], seqnos=frozen.seqnos[lo:hi],
                    tombs=frozen.tombs[lo:hi], raw_values=frozen.values[lo:hi],
                    level=0, key_bytes=self.cfg.key_bytes,
                    value_width=self.cfg.value_width,
                    block_bytes=self.cfg.block_bytes,
                    bloom_bits_per_key=self.cfg.bloom_bits_per_key,
                    store=self.store, device=self.device,
                    codec=self.cfg.codec, blob_mgr=self.blob_mgr))
        # adds listed oldest-chunk-first; L0 prepends them reversed
        self.versions.apply(VersionEdit(adds=[(0, s) for s in new],
                                        last_seqno=int(frozen.seqnos.max())))
        self.n_flushes += 1
        if len(self.versions.current.levels[0]) > self._l0_trigger():
            self.write_stalls += 1
            t0 = time.perf_counter()
            self._compact_l0()
            self._cascade()
            self.stall_seconds += time.perf_counter() - t0

    def raise_maintenance_errors(self) -> None:
        """Raise a failed background flush or compaction to a read-only
        caller.  With synchronous maintenance a failure raises on the
        writer's own call, so there is never one to raise here."""

    def compact(self) -> None:
        """Full maintenance pass: flush, fold L0 into L1, cascade."""
        self.flush()
        if self.versions.current.levels[0]:
            self._compact_l0()
        self._cascade()

    # ------------------------------------------------------------------ #
    # compaction scheduling (leveling, paper Figure 2)
    # ------------------------------------------------------------------ #
    def _merge_is_bottom(self, inputs: List[SCT], out_level: int) -> bool:
        """Tombstones may be dropped only if no run outside the inputs can
        hold an older version of an input key."""
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

    def _compact_l0(self) -> None:
        v = self.versions.current
        inputs = list(v.levels[0])
        if not inputs:
            return
        lo = min(s.min_key for s in inputs)
        hi = max(s.max_key for s in inputs)
        overlaps = [s for s in v.levels[1] if s.overlaps(lo, hi)]
        self._run_merge(inputs + overlaps, out_level=1,
                        drop_in=[(0, inputs), (1, overlaps)])

    def _compact_level_step(self, i: int) -> None:
        """One step at level i: a round-robin victim file + its overlaps
        below; a level holding overlapping runs merges whole."""
        v = self.versions.current
        runs = list(v.levels[i])
        if not runs:
            return
        if run_depth(runs) <= 1:
            victim = self._pick_victim(i)
            overlaps = [s for s in v.levels[i + 1]
                        if s.overlaps(victim.min_key, victim.max_key)]
            self._run_merge([victim] + overlaps, out_level=i + 1,
                            drop_in=[(i, [victim]), (i + 1, overlaps)])
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

    def _pick_victim(self, level: int) -> SCT:
        runs = self.versions.current.levels[level]
        cur = self._cursors.get(level, 0) % len(runs)
        self._cursors[level] = cur + 1
        return runs[cur]

    def _run_merge(self, inputs: List[SCT], out_level: int,
                   drop_in: List[tuple]) -> None:
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
        self.versions.apply(VersionEdit(
            adds=[(out_level, s) for s in res.outputs],
            drops=[(lvl, s.file_id) for lvl, gone in drop_in for s in gone]))
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
        others."""
        snaps = [s for s in (r() for r in self._snapshots) if s is not None]
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
        zombies, self._zombie_blobs = self._zombie_blobs, []
        for fid in zombies:
            if fid in pinned:
                self._zombie_blobs.append(fid)
            else:
                self.store.delete(fid)
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
            for _, s, _ in refs:
                self.store.delete(s.file_id)
            mgr.forget(fid)
            self._zombie_blobs.append(fid)
            mgr.gc_runs += 1
            mgr.gc_bytes_rewritten += int(new_vals.nbytes)

    # ------------------------------------------------------------------ #
    # reads
    # ------------------------------------------------------------------ #
    def snapshot(self) -> Snapshot:
        v = self.versions.current
        snap = Snapshot(self._seqno, self.memtable, v.all_runs(), version=v)
        if self.blob_mgr is not None:
            # the registry feeds blob GC's pinning only; pruned on the way
            # in, it never grows past the live snapshots
            self._live_snapshots()
            self._snapshots.append(weakref.ref(snap))
        return snap

    def get(self, key: int, snapshot: Optional[Snapshot] = None) -> Optional[bytes]:
        """point_lookup: memtable, then every candidate run; the newest
        visible version across runs wins."""
        snap = snapshot or self.snapshot()
        snap_seq = snap.seqno if snapshot is not None else None
        with self.lookup_stats.time("lookup"):
            got = snap.memtable.get(key, snap_seq)
            if got is not None:
                return got[1]
            k = np.uint64(key)
            best_seq = -1
            best = None
            for s in snap.runs:
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
    def shape_report(self) -> Dict[str, object]:
        v = self.versions.current
        return {
            "levels": [len(l) for l in v.levels],
            "level_bytes": [v.level_bytes(i) for i in range(self.cfg.max_levels)],
            "run_depths": [run_depth(l) for l in v.levels],
            "policy": self.policy.describe(),
            "n_files": self.n_files,
            "disk_bytes": self.disk_bytes,
            "dict_bytes": self.dict_bytes,
            "n_flushes": self.n_flushes,
            "n_compactions": self.n_compactions,
            "write_stalls": self.write_stalls,
            "stall_seconds": self.stall_seconds,
            "cascade_truncations": self.cascade_truncations,
            "dict_compares": self.dict_compares,
            "version": v.vid,
            "maintenance": self.cfg.maintenance,
            "wal_sync": self.cfg.wal_sync,
        }
