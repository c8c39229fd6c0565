"""Deterministic fault injection: crash points.

Port of the kill faults of ``repro/testing/crashpoints.py``.  The write,
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

The reference's replication faults (its ``REPLICA_FAULT_SITES``, and the
partition and lag kinds that ``inject`` / ``injected`` arm and query) come
with the replicas (ROADMAP §1 item 4(b)).
"""

from __future__ import annotations

import contextlib
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


class SimulatedCrash(BaseException):
    """Raised at an armed crash site.  A BaseException on purpose: a
    simulated kill must not be absorbed by ``except Exception`` cleanup
    code, so that it leaves the on-disk state a real kill would."""


class CrashPointRegistry:
    """Process-global crash state: one armed site at a time; after it
    fires the registry is 'crashed' and every site raises until
    ``disarm``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._armed: Optional[str] = None
        self._skip = 0
        self._action = "raise"
        self._crashed = False
        self.hits: Dict[str, int] = {}    # armed-site hit counts
        self.fired: Optional[str] = None  # last site that actually fired

    def arm(self, name: str, skip: int = 0, action: str = "raise") -> None:
        if name not in CRASH_POINTS:
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
              action: str = "raise") -> Iterator["CrashPointRegistry"]:
        self.arm(name, skip=skip, action=action)
        try:
            yield self
        finally:
            self.disarm()

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


#: The process-wide registry every instrumented site reports to.
CRASH = CrashPointRegistry()


def crashpoint(name: str) -> None:
    """Site marker: free when disarmed, fatal when armed (see CRASH)."""
    CRASH.reached(name)
