"""Deterministic fault injection: crash points and replication faults.

Port of ``repro/testing/crashpoints.py``.  The write,
flush, compaction, manifest and blob GC paths are threaded with named
crash sites: ``crashpoint("flush.before_manifest")`` is a two-attribute
check in production, but once the registry is armed at that name the site
raises ``SimulatedCrash``, and from that instant the registry is sticky:
every instrumented site raises, as every thread of a killed process dies.

Two kill modes:

  action='raise'  (default) the site raises ``SimulatedCrash``, a
                  BaseException, so ``except Exception`` cleanup handlers
                  do not run (a real SIGKILL would not run them either).
                  The harness then abandons the in-memory engine, truncates
                  the WAL to its durable prefix
                  (``WALWriter.simulate_power_loss``) and restores from the
                  spill directory.
  action='exit'   the site calls ``os._exit(137)``: the subprocess driver
                  (``repro_torch.testing.crash_driver``) uses this for a
                  true process kill; the parent test recovers the spill
                  directory it left behind.

``skip=N`` lets the first N hits of the armed site pass, so one site can
be exercised at several depths of the same workload.

Replication generalises kills to a fault registry (ROADMAP §1 item 4(b)):
the leader/follower protocol (``repro_torch.replica``) has sites where a
fault is not a process death but a network condition, a partitioned or a
lagging link.  ``inject(site, kind=...)`` arms such a fault and the
replication link queries it with ``injected(site)``:

  kind='kill'       identical to ``arm`` (sticky SimulatedCrash): the
                    leader-kill / follower-kill / crash-during-promote
                    schedules.
  kind='partition'  ``injected`` returns the fault while armed; the link
                    drops the send and the follower falls behind until
                    ``heal`` (the resume then re-ships from the follower's
                    applied watermark).
  kind='lag'        ``injected`` returns the fault; the link withholds the
                    newest ``params['seqnos']`` records, a slow link whose
                    follower trails the leader by a bounded suffix.

Non-kill faults are per site, may be armed at several sites at once, and
take ``skip`` (activate after N hits) and ``count`` (heal by themselves
after N active hits), so one schedule can partition, deliver and
re-partition deterministically.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, Iterator, Optional

#: Every instrumented site, in rough write-path order; the reference's
#: tuple, so a crash matrix names the same sites on both engines.
#: ``split.before_table`` is reached by ``ShardedLSM``'s hot-shard split.
CRASH_POINTS = (
    "wal.after_append",        # record in the segment file, fsync pending
    "wal.after_sync",          # fsync returned: the record is durable
    "flush.mid_spill",         # between SCT chunk spills of one flush
    "flush.before_manifest",   # SCTs spilled, VersionEdit not yet applied
    "flush.after_manifest",    # edit durable, WAL not yet truncated
    "compact.mid_spill",       # between output-file spills of one merge
    "compact.before_manifest", # outputs spilled, edit not yet applied
    "compact.after_manifest",  # edit durable, inputs not yet deleted
    "gc.mid_blob",             # new value log appended, replaces pending
    "gc.after_replace",        # replace edit durable, old runs not deleted
    "split.before_table",      # halves installed, SHARDS.json not rewritten
)

#: Replication-protocol fault sites (ship / apply / promote).  Kill faults
#: at these sites model a dead leader, follower or coordinator; partition
#: and lag faults model the link conditions in between.
REPLICA_FAULT_SITES = (
    "ship.send",               # leader->follower record transfer
    "apply.record",            # follower applying one shipped record
    "promote.before_seal",     # failover chosen, new epoch not yet durable
    "promote.after_seal",      # epoch durable, retention log not truncated
    "promote.after_truncate",  # log truncated, routing not yet re-pointed
)

FAULT_SITES = CRASH_POINTS + REPLICA_FAULT_SITES

FAULT_KINDS = ("kill", "partition", "lag")


class SimulatedCrash(BaseException):
    """Raised at an armed crash site.  A BaseException on purpose: a
    simulated kill must not be absorbed by ``except Exception`` cleanup
    code, so that it leaves the on-disk state a real kill would."""


@dataclasses.dataclass
class _Fault:
    """One armed non-kill fault at one site."""
    kind: str
    skip: int = 0                  # hits to let pass before activating
    count: Optional[int] = None    # active hits before it heals itself
    params: Dict[str, int] = dataclasses.field(default_factory=dict)
    hits: int = 0
    fired: int = 0


class FaultRegistry:
    """Process-global fault state.

    Kill faults: one armed site at a time; after it fires the registry is
    'crashed' and every site raises until ``disarm``.  Partition and lag
    faults are independent per-site toggles that the replication link
    queries (``injected``); they never raise."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: Optional[str] = None
        self._skip = 0
        self._action = "raise"
        self._crashed = False
        self._faults: Dict[str, _Fault] = {}
        self.hits: Dict[str, int] = {}    # armed-site hit counts
        self.fired: Optional[str] = None  # last site that actually fired

    # ------------------------------------------------------------------ #
    # kill faults (crash points)
    # ------------------------------------------------------------------ #
    def arm(self, name: str, skip: int = 0, action: str = "raise") -> None:
        if name not in FAULT_SITES:
            raise ValueError(f"unknown crash point {name!r}")
        if action not in ("raise", "exit"):
            raise ValueError(f"unknown crash action {action!r}")
        with self._lock:
            self._armed = name
            self._skip = int(skip)
            self._action = action
            self._crashed = False
            self.hits = {}
            self.fired = None

    def disarm(self) -> None:
        with self._lock:
            self._armed = None
            self._crashed = False

    @contextlib.contextmanager
    def armed(self, name: str, skip: int = 0,
              action: str = "raise") -> Iterator["FaultRegistry"]:
        self.arm(name, skip=skip, action=action)
        try:
            yield self
        finally:
            self.disarm()

    # ------------------------------------------------------------------ #
    # partition / lag faults (replication links)
    # ------------------------------------------------------------------ #
    def inject(self, site: str, kind: str = "kill", skip: int = 0,
               count: Optional[int] = None, action: str = "raise",
               **params: int) -> None:
        """Arm one fault.  ``kind='kill'`` is ``arm`` (one sticky crash at
        a time); a partition or lag fault replaces the one at its site and
        is read back through ``injected``."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "kill":
            self.arm(site, skip=skip, action=action)
            return
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}")
        with self._lock:
            self._faults[site] = _Fault(kind, int(skip), count, dict(params))

    def heal(self, site: Optional[str] = None) -> None:
        """Clear non-kill faults (one site, or all of them)."""
        with self._lock:
            if site is None:
                self._faults = {}
            else:
                self._faults.pop(site, None)

    @contextlib.contextmanager
    def injected_at(self, site: str, kind: str,
                    **kw) -> Iterator["FaultRegistry"]:
        self.inject(site, kind=kind, **kw)
        try:
            yield self
        finally:
            self.heal(site)

    def injected(self, site: str) -> Optional[_Fault]:
        """The replication link's query: the active non-kill fault at
        ``site``, or None.  It passes through the kill path first, so a
        kill armed at a replication site fires here like any crash
        point."""
        self.reached(site)
        with self._lock:
            f = self._faults.get(site)
            if f is None:
                return None
            f.hits += 1
            if f.hits <= f.skip:
                return None
            if f.count is not None and f.hits - f.skip > f.count:
                return None
            f.fired += 1
            return f

    # ------------------------------------------------------------------ #
    def reached(self, name: str) -> None:
        """Called by the instrumented sites.  The disarmed fast path is two
        attribute checks and no lock."""
        if self._armed is None and not self._crashed:
            return
        self._fire(name)

    def _fire(self, name: str) -> None:
        with self._lock:
            if self._crashed:
                crash = True  # sticky: the "process" is already dead
            else:
                if name != self._armed:
                    return
                self.hits[name] = self.hits.get(name, 0) + 1
                crash = self.hits[name] > self._skip
                if crash:
                    self._crashed = True
                    self.fired = name
            action = self._action
        if crash:
            if action == "exit":
                os._exit(137)
            raise SimulatedCrash(name)


#: The crash-point registry is the fault registry, used for its kills.
CrashPointRegistry = FaultRegistry

#: The process-wide registry every instrumented site reports to.
CRASH = FaultRegistry()

#: The same registry under its replication name: fault schedules arm kills
#: and partitions on one instance, so a kill in the middle of a schedule is
#: sticky across every site, as a process death is.
FAULTS = CRASH


def crashpoint(name: str) -> None:
    """Site marker: free when disarmed, fatal when armed (see CRASH)."""
    CRASH.reached(name)


def fault_at(site: str) -> Optional[_Fault]:
    """Replication-link site marker: the active partition or lag fault (or
    None); raises ``SimulatedCrash`` where a kill is armed."""
    return CRASH.injected(site)
