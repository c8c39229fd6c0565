"""Batched group-commit write-ahead log.

Port of ``repro/core/wal.py``, host code only: the segment files are byte
for byte the reference's after the same operations.

The version set (``core.version``) makes the tree *shape* durable, but
everything still buffered in the memtable dies with the process.  This
WAL closes that gap: every put/delete appends one CRC32-framed record
to an append-only segment file *before* touching the memtable, so
``LSMTree.restore`` can replay the tail of the log above the manifest's
seqno watermark and recover exactly the acknowledged writes.

Record framing (little-endian)::

    +----------+----------+---------------------------------------+
    | len u32  | crc u32  | payload (op u8, seqno u64, key u64,   |
    |          |          |          value bytes — puts only)     |
    +----------+----------+---------------------------------------+

``crc`` covers the payload; replay stops at the first record whose
length runs past EOF or whose CRC mismatches — a torn final record
(crash mid-append) truncates cleanly to the last good prefix instead
of poisoning recovery.

Sync policy (``LSMConfig.wal_sync``):

  'every'   write + flush + fsync per record.  An op is durable when
            the call that wrote it returns.  The paranoid baseline.
  'group'   group commit: records are written through to the OS
            immediately but fsync'd in batches — whenever the unsynced
            tail passes ``wal_group_bytes``, at every segment seal
            (memtable rotation), and at each ``put_batch`` return (one
            flush barrier acknowledges the whole batch).  A power loss
            forfeits at most the unsynced tail, never a prefix hole.
  'off'     no WAL at all (the pre-WAL engine; unflushed writes die
            with the process).

Segment lifecycle mirrors the memtable's: the active segment receives
records for the active memtable; ``rotate()`` (called under the same
lock that swaps the memtable into the frozen queue) seals it under a
final fsync and opens a fresh one, so segment k holds exactly memtable
k's ops.  Once a flush's ``VersionEdit`` commits with watermark S,
``truncate_upto(S)`` deletes every sealed segment whose records are
all <= S — the log never grows past the un-flushed suffix.

``simulate_power_loss`` is the deterministic fault-injection hook
(``repro_torch.testing``): it truncates the on-disk segments to exactly the
fsync-covered prefix (optionally leaving a torn half-record), which is
the strongest loss a real power cut could inflict on this write
pattern.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
import threading
import zlib
from typing import Callable, List, Optional, Tuple

from repro_torch.testing.crashpoints import crashpoint

OP_PUT = 1
OP_DELETE = 2


class WALError(RuntimeError):
    """The WAL writer is unusable — a previous fsync failed (fsyncgate:
    the kernel may have dropped the dirty pages, so nothing appended
    since the last *successful* sync can be trusted to reach disk) and
    every subsequent append/sync must fail rather than silently
    acknowledge writes into an unsyncable tail."""

_HDR = struct.Struct("<II")    # record length, crc32(payload)
_FIX = struct.Struct("<BQQ")   # op, seqno, key
_MAX_RECORD = 1 << 24          # parse sanity bound (16 MiB)
_SEG_FMT = "{prefix}-{segno:08d}.wal"
_SEG_RE = r"-(\d{8})\.wal$"


def wal_prefix_for(manifest_name: str) -> str:
    """Per-tree WAL file prefix, derived from the tree's manifest name
    so shard trees sharing one spill dir never collide:
    ``MANIFEST.log -> WAL``, ``MANIFEST-0007.log -> WAL-0007``."""
    base = manifest_name.rsplit(".", 1)[0]
    if base.startswith("MANIFEST"):
        return "WAL" + base[len("MANIFEST"):]
    return "WAL-" + base


@dataclasses.dataclass(frozen=True)
class WALRecord:
    op: int
    seqno: int
    key: int
    value: bytes = b""


def encode_record(op: int, seqno: int, key: int, value: bytes = b"") -> bytes:
    payload = _FIX.pack(op, seqno, key) + value
    return _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def parse_segment(data: bytes) -> Tuple[List[WALRecord], int, bool]:
    """-> (records, good_prefix_bytes, clean).  ``clean`` is False when
    parsing stopped before EOF (torn or corrupt tail)."""
    records: List[WALRecord] = []
    off = 0
    n = len(data)
    while off + _HDR.size <= n:
        ln, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln
        if ln < _FIX.size or ln > _MAX_RECORD or end > n:
            break
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        op, seqno, key = _FIX.unpack_from(payload, 0)
        records.append(WALRecord(op, seqno, key, payload[_FIX.size:]))
        off = end
    return records, off, off == n


@dataclasses.dataclass
class _Sealed:
    segno: int
    path: str
    max_seqno: Optional[int]  # None: no records (nothing to preserve)


class WALWriter:
    """Single-writer WAL over numbered segment files in a spill dir.

    Thread safety: the engine has one writer; segment truncation after a
    flush may come from another thread than the appends (the reference's
    background flush worker), so all file and bookkeeping mutation
    serializes on an internal lock."""

    def __init__(self, dirpath: str, prefix: str = "WAL",
                 sync: str = "group", group_bytes: int = 64 * 1024):
        if sync not in ("group", "every"):
            raise ValueError(f"unknown wal sync mode {sync!r}")
        self.dir = dirpath
        self.prefix = prefix
        self.mode = sync
        self.group_bytes = int(group_bytes)
        self._lock = threading.Lock()
        self._f = None                      # active segment handle (lazy)
        self._path: Optional[str] = None
        self._segno = 0                     # next segment number to open
        self._written = 0                   # bytes written to the active seg
        self._durable = 0                   # bytes covered by fsync
        self._tail_lens: List[int] = []     # unsynced record lengths
        self._max_seq: Optional[int] = None  # highest seqno in active seg
        self._sealed: List[_Sealed] = []
        self._poisoned: Optional[BaseException] = None  # first fsync failure
        # optional replication tap: called under the writer lock with every
        # appended record, in seqno order.  The leader of a replicated
        # group (repro_torch.replica) registers its retention log here, so
        # the replication stream is the durability stream, bit for bit
        self.tap: Optional[Callable[[int, int, int, bytes], None]] = None
        # cumulative, across segments
        self.durable_seqno = 0   # highest seqno covered by an fsync
        self.appends = 0
        self.syncs = 0
        self.rotations = 0
        self.truncations = 0
        self.bytes_written = 0
        self.replayed = 0        # records recovered by ``restore``

    # ------------------------------------------------------------------ #
    # append path
    # ------------------------------------------------------------------ #
    def _ensure_segment(self):
        if self._f is None:
            self._path = os.path.join(
                self.dir, _SEG_FMT.format(prefix=self.prefix,
                                          segno=self._segno))
            self._f = open(self._path, "ab")
        return self._f

    def append(self, op: int, key: int, seqno: int,
               value: bytes = b"") -> None:
        rec = encode_record(op, seqno, key, value)
        with self._lock:
            self._check_poisoned()
            f = self._ensure_segment()
            f.write(rec)
            self._written += len(rec)
            self._tail_lens.append(len(rec))
            self._max_seq = seqno
            self.appends += 1
            self.bytes_written += len(rec)
            if self.tap is not None:
                self.tap(op, seqno, key, value)
            crashpoint("wal.after_append")
            if self.mode == "every" or (
                    self._written - self._durable >= self.group_bytes):
                self._sync_locked()

    def sync(self) -> None:
        """Group-commit barrier: everything appended so far is durable
        when this returns (``put_batch`` calls it once per batch)."""
        with self._lock:
            self._sync_locked()

    def _check_poisoned(self) -> None:
        if self._poisoned is not None:
            raise WALError(
                "WAL writer poisoned by an earlier fsync failure; the "
                "unsynced tail may never reach disk — restart and "
                "restore from the durable prefix") from self._poisoned

    def _sync_locked(self) -> None:
        self._check_poisoned()
        if self._f is None or self._written == self._durable:
            return
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            # fsyncgate: after a failed fsync the kernel may have
            # discarded the dirty pages, so retrying could "succeed"
            # while the data is gone.  Poison the writer: the durable
            # watermark never advances past the failure and every later
            # append/sync raises instead of silently growing an
            # unsyncable tail.
            self._poisoned = e
            raise WALError(
                f"WAL fsync failed on {self._path!r}: {e}") from e
        self._durable = self._written
        self._tail_lens = []
        if self._max_seq is not None:
            self.durable_seqno = max(self.durable_seqno, self._max_seq)
        self.syncs += 1
        crashpoint("wal.after_sync")

    # ------------------------------------------------------------------ #
    # segment lifecycle
    # ------------------------------------------------------------------ #
    def rotate(self) -> None:
        """Seal the active segment under a final fsync (its memtable
        just rotated into the frozen queue) and start a fresh one for
        the new active memtable.  No-op when nothing was appended."""
        with self._lock:
            if self._f is None:
                return
            self._sync_locked()
            self._f.close()
            self._sealed.append(_Sealed(self._segno, self._path,
                                        self._max_seq))
            self._f = None
            self._path = None
            self._segno += 1
            self._written = self._durable = 0
            self._tail_lens = []
            self._max_seq = None
            self.rotations += 1

    def truncate_upto(self, seqno: int) -> None:
        """Delete sealed segments fully covered by the flushed watermark
        ``seqno`` — their every record is now durable in an SCT that an
        installed (and manifest-logged) version references."""
        with self._lock:
            keep: List[_Sealed] = []
            for seg in self._sealed:
                if seg.max_seqno is None or seg.max_seqno <= seqno:
                    try:
                        os.remove(seg.path)
                    except FileNotFoundError:
                        pass
                    self.truncations += 1
                else:
                    keep.append(seg)
            self._sealed = keep

    def discard(self) -> None:
        """Remove every segment file (a shard tree retired by a split:
        its data was flushed and drained before the halves took over)."""
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            for path in ([s.path for s in self._sealed]
                         + ([self._path] if self._path else [])):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
            self._sealed = []
            self._path = None

    def close(self) -> None:
        """Planned shutdown: make the tail durable, keep the files (a
        restart replays them).  A poisoned writer closes WITHOUT the
        final sync — the tail past the last good fsync is already lost
        and restore must see only the durable prefix."""
        with self._lock:
            if self._f is not None:
                if self._poisoned is None:
                    self._sync_locked()
                self._f.close()
                self._f = None

    # ------------------------------------------------------------------ #
    # recovery + fault injection
    # ------------------------------------------------------------------ #
    @classmethod
    def restore(cls, dirpath: str, prefix: str = "WAL",
                sync: str = "group", group_bytes: int = 64 * 1024
                ) -> Tuple["WALWriter", List[WALRecord]]:
        """Replay every segment under ``dirpath`` in segment order.

        Stops at the FIRST torn/corrupt record anywhere in the sequence:
        records past it were never acknowledged as durable, and replaying
        a later segment across a hole would break prefix consistency.
        The torn file is physically truncated to its good prefix and any
        later segments are deleted, so a second crash + restore sees the
        same durable prefix and new appends never interleave with
        garbage.  Returns the ready writer (replayed segments registered
        as sealed, so flush watermarks still truncate them) plus the
        recovered records in seqno order."""
        pat = re.compile(re.escape(prefix) + _SEG_RE)
        found = []
        for name in sorted(os.listdir(dirpath)):
            m = pat.fullmatch(name)
            if m:
                found.append((int(m.group(1)), os.path.join(dirpath, name)))
        found.sort()
        w = cls(dirpath, prefix=prefix, sync=sync, group_bytes=group_bytes)
        records: List[WALRecord] = []
        torn = False
        for segno, path in found:
            w._segno = max(w._segno, segno + 1)
            if torn:  # beyond the durable prefix: unreachable by replay
                os.remove(path)
                continue
            with open(path, "rb") as f:
                data = f.read()
            recs, good, clean = parse_segment(data)
            if not clean:
                torn = True
                with open(path, "r+b") as f:
                    f.truncate(good)
            records.extend(recs)
            if recs:
                w._sealed.append(_Sealed(segno, path, recs[-1].seqno))
            else:
                os.remove(path)
        w.replayed = len(records)
        if records:
            w.durable_seqno = records[-1].seqno
        return w, records

    def simulate_power_loss(self, tear: bool = False) -> None:
        """Fault-injection hook: truncate the active segment to exactly
        the fsync-covered prefix, modeling a power cut that loses every
        unsynced byte.  ``tear=True`` instead leaves a partial first
        unsynced record — the torn-tail case replay must absorb.  The
        writer is unusable afterwards (the "process" is dead)."""
        with self._lock:
            if self._f is None:
                return
            keep = self._durable
            if tear and self._tail_lens:
                keep += max(1, self._tail_lens[0] - 3)
            self._f.flush()   # surface the tail so the tear is real
            self._f.close()
            self._f = None
            with open(self._path, "r+b") as f:
                f.truncate(keep)
