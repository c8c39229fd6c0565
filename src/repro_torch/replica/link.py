"""Leader->follower replication links over the WAL record stream.

Port of ``repro/replica/link.py``; host code.  Each follower the links
feed is a full ``LSMTree`` on the card, so the records they ship go
through its flush (``pack_codes``) and compactions (``unpack_codes``,
``remap_pack_codes``) there.

``ReplicationLog`` is the leader-side retention buffer: the leader's
``WALWriter`` tap appends every record (op, seqno, key, value) in seqno
order the instant it enters the WAL, so the replication stream is the
durability stream, bit for bit.  The log retains records until every
registered follower watermark has passed them (``trim_below``) — the
leader's own WAL segments truncate at flush time, so the log, not the
segments, is what a lagging follower resumes from.

``ReplicationLink`` is one in-process leader->follower channel.
Delivery is pull-based: ``pump(head)`` ships every record the follower
is missing, subject to the link's fault state —

  partition     nothing is delivered until ``heal()``; the follower's
                applied watermark freezes and reads against it grow
                stale (the read policy routes around it).
  lag           the newest ``lag_seqnos`` records are withheld,
                modeling a slow link whose follower trails the leader
                by a bounded suffix.
  kill          the ``ship.send`` fault site raises ``SimulatedCrash``
                (sticky, like every crash point) — the coordinator died
                mid-ship.

Resume is reorder-safe by construction: the link always ships from the
follower's *applied* watermark (``LSMTree.replicate`` skips duplicates
at or below it and refuses gaps above it), so a heal after any
partition/lag schedule delivers exactly the missing suffix.
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional

from repro_torch.core.wal import WALRecord
from repro_torch.testing.crashpoints import fault_at


class ResyncRequired(RuntimeError):
    """A follower's watermark fell below the retention floor (it was
    dropped from the group while the log trimmed past it); it can no
    longer catch up record-by-record and needs a snapshot bootstrap
    (``ReplicatedShard.resync_follower``)."""


class ReplicationLag(RuntimeError):
    """Raised by a routed read when no replica satisfies the staleness
    bound and the leader, which would serve it otherwise, is dead."""


class ReplicationLog:
    """Seqno-ordered retention buffer of the leader's WAL stream."""

    def __init__(self) -> None:
        self._recs: Deque[WALRecord] = collections.deque()
        self._floor = 0          # every seqno <= floor has been trimmed
        self.appended = 0
        self.trimmed = 0

    # ------------------------------------------------------------------ #
    @property
    def floor(self) -> int:
        return self._floor

    @property
    def head(self) -> int:
        """Highest retained seqno (== the leader's last append)."""
        return self._recs[-1].seqno if self._recs else self._floor

    def __len__(self) -> int:
        return len(self._recs)

    def append(self, op: int, seqno: int, key: int, value: bytes) -> None:
        """WALWriter tap signature — called under the leader's WAL lock
        with every appended record, in seqno order."""
        self._recs.append(WALRecord(op, seqno, key, value))
        self.appended += 1

    def since(self, seqno: int, upto: Optional[int] = None
              ) -> List[WALRecord]:
        """Records with ``seqno < s <= upto`` — the suffix a follower at
        watermark ``seqno`` is missing."""
        if seqno < self._floor:
            raise ResyncRequired(
                f"follower watermark {seqno} is below the retention "
                f"floor {self._floor}; snapshot bootstrap required")
        out = []
        for r in self._recs:
            if r.seqno <= seqno:
                continue
            if upto is not None and r.seqno > upto:
                break
            out.append(r)
        return out

    def trim_below(self, seqno: int) -> None:
        """Drop records every follower has durably passed."""
        while self._recs and self._recs[0].seqno <= seqno:
            self._recs.popleft()
            self.trimmed += 1
        self._floor = max(self._floor, seqno)

    def truncate_above(self, seqno: int) -> int:
        """Failover: records past the promoted leader's watermark were
        never acknowledged by the new epoch — discard them.  Returns the
        number of orphaned records."""
        dropped = 0
        while self._recs and self._recs[-1].seqno > seqno:
            self._recs.pop()
            dropped += 1
        return dropped

    def reset_floor(self, seqno: int) -> None:
        """Post-restore: the in-memory log died with the process; the
        new retention floor is the restored leader's watermark."""
        self._recs.clear()
        self._floor = seqno


class ReplicationLink:
    """One leader->follower channel (see module docstring)."""

    def __init__(self, log: ReplicationLog, follower, name: str = "") -> None:
        self.log = log
        self.follower = follower
        self.name = name
        self.partitioned = False
        self.lag_seqnos = 0
        self.alive = True
        # telemetry
        self.shipped = 0          # records delivered
        self.pumps = 0
        self.blocked_pumps = 0    # pump rounds that delivered nothing
        self.resumes = 0          # catch-up rounds after a blocked spell
        self._was_blocked = False

    # ------------------------------------------------------------------ #
    # fault controls (direct, or scheduled via the FaultRegistry)
    # ------------------------------------------------------------------ #
    def partition(self) -> None:
        self.partitioned = True

    def heal(self) -> None:
        self.partitioned = False

    @property
    def applied_seqno(self) -> int:
        return self.follower._seqno

    @property
    def durable_seqno(self) -> int:
        w = self.follower.wal
        return w.durable_seqno if w is not None else self.follower._seqno

    # ------------------------------------------------------------------ #
    def pump(self, head: int) -> int:
        """Deliver every record the follower is missing up to ``head``
        minus the effective lag.  Returns records newly applied."""
        if not self.alive:
            return 0
        self.pumps += 1
        lag = self.lag_seqnos
        fault = fault_at("ship.send")   # raises on an armed kill
        blocked = self.partitioned
        if fault is not None:
            if fault.kind == "partition":
                blocked = True
            elif fault.kind == "lag":
                lag = max(lag, int(fault.params.get("seqnos", 0)))
        if blocked:
            self.blocked_pumps += 1
            self._was_blocked = True
            return 0
        upto = head - lag
        have = self.applied_seqno
        if upto <= have:
            return 0
        recs = self.log.since(have, upto=upto)
        applied = self.follower.replicate(recs)
        self.shipped += applied
        if self._was_blocked and applied:
            self.resumes += 1     # reorder-safe catch-up from watermark
            self._was_blocked = False
        return applied
