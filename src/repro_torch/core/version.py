"""Immutable version set: the engine's tree shape as a persistent value.

Port of ``repro/core/version.py`` for the in-memory engine.  ``Version`` is
a frozen per-level tuple of SCT tuples; ``VersionEdit`` a delta (SCTs added
per level, file ids dropped per level, SCTs swapped in place of others by
blob GC, the highest seqno made durable); ``VersionSet.apply`` installs an
edit atomically.  L0 runs are newest first (adds prepend, the first-listed
add ends up newest); L1+ runs are kept sorted by ``min_key``; a replaced
run keeps its position.  The manifest log, recovery and the stacked
(tiered) edit are not ported yet (ROADMAP §1).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

from repro_torch.core.sct import SCT


@dataclasses.dataclass(frozen=True)
class Version:
    levels: Tuple[Tuple[SCT, ...], ...]
    vid: int = 0

    @staticmethod
    def empty(max_levels: int) -> "Version":
        return Version(tuple(() for _ in range(max_levels)), vid=0)

    def all_runs(self) -> List[SCT]:
        """L0 newest first, then L1..Ln."""
        runs = list(self.levels[0])
        for lvl in self.levels[1:]:
            runs.extend(lvl)
        return runs

    def level_bytes(self, i: int) -> int:
        return sum(s.disk_bytes for s in self.levels[i])

    @property
    def n_files(self) -> int:
        return sum(len(lvl) for lvl in self.levels)

    def with_edit(self, edit: "VersionEdit", vid: int) -> "Version":
        """Apply one edit functionally; the receiver is untouched."""
        levels: List[List[SCT]] = [list(lvl) for lvl in self.levels]
        for lvl, old_fid, new in edit.replaces:
            levels[lvl] = [new if s.file_id == old_fid else s
                           for s in levels[lvl]]
        for lvl, fid in edit.drops:
            levels[lvl] = [s for s in levels[lvl] if s.file_id != fid]
        adds0 = [s for lvl, s in edit.adds if lvl == 0]
        levels[0] = list(reversed(adds0)) + levels[0]
        for lvl, s in edit.adds:
            if lvl:
                levels[lvl].append(s)
        for i in {lvl for lvl, _ in edit.adds if lvl}:
            levels[i].sort(key=lambda s: s.min_key)
        return Version(tuple(tuple(lvl) for lvl in levels), vid=vid)


@dataclasses.dataclass
class VersionEdit:
    """``adds`` (level, sct); ``drops`` (level, file_id); ``replaces``
    (level, old file_id, new sct), an in-place swap that keeps the run's
    position (copy-on-write blob GC must not perturb L0's recency order);
    ``last_seqno`` the highest seqno this edit makes durable."""

    adds: List[Tuple[int, SCT]] = dataclasses.field(default_factory=list)
    drops: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    replaces: List[Tuple[int, int, SCT]] = dataclasses.field(
        default_factory=list)
    last_seqno: Optional[int] = None


class VersionSet:
    """Atomic install point: ``apply`` is the only way the shape changes;
    publication is one reference assignment, so readers holding
    ``current`` keep a consistent older view."""

    def __init__(self, max_levels: int, current: Optional[Version] = None,
                 last_seqno: int = 0):
        self._lock = threading.Lock()
        self.current = current or Version.empty(max_levels)
        self.last_seqno = last_seqno

    def apply(self, edit: VersionEdit) -> Version:
        with self._lock:
            if edit.last_seqno is not None:
                self.last_seqno = max(self.last_seqno, int(edit.last_seqno))
            self.current = self.current.with_edit(edit,
                                                  vid=self.current.vid + 1)
            return self.current
