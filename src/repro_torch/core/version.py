"""Immutable version set: the engine's tree shape as a persistent value.

Port of ``repro/core/version.py``.  ``Version`` is a frozen per-level
tuple of SCT tuples; ``VersionEdit`` a delta (SCTs added per level, file
ids dropped per level, SCTs swapped in place of others by blob GC, the
highest seqno made durable); ``VersionSet.apply`` installs an edit
atomically and, when the store spills, appends it as one JSON line to the
manifest log in the spill directory, so ``VersionSet.recover`` can replay
the log over ``FileStore.restore`` and rebuild the exact tree shape a
crashed process left behind.  L0 runs are newest first (adds prepend, the
first-listed add ends up newest); L1+ runs are kept sorted by
``min_key``, except at a level an edit marks ``stacked`` (a tiered run):
there the adds prepend as at L0 and the level is not re-sorted, so it may
hold overlapping runs, newest first.  A replaced run keeps its position.
The manifest records the stacked levels under ``"stacked"`` (only when
there are some, so a leveled tree's records carry no such key), and the
replay keeps the replayed order of every level that ever received a
stacked add, as the reference's does: such a level is re-sorted by the
live tree on its next leveled add, but not after a replay.

A restored store holds each SCT as its spill record (host arrays):
``recover`` resolves the runs the manifest keeps through its ``load``
callable, with which ``LSMTree.restore`` builds them on its device, and
``gc_orphan_scts`` takes an SCT's record for an SCT.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.sct import SCT, is_sct_record
from repro_torch.storage.io import FileStore


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

    def file_ids(self) -> List[int]:
        return [s.file_id for lvl in self.levels for s in lvl]

    def with_edit(self, edit: "VersionEdit", vid: int) -> "Version":
        """Apply one edit functionally; the receiver is untouched."""
        levels: List[List[SCT]] = [list(lvl) for lvl in self.levels]
        for lvl, old_fid, new in edit.replaces:
            levels[lvl] = [new if s.file_id == old_fid else s
                           for s in levels[lvl]]
        for lvl, fid in edit.drops:
            levels[lvl] = [s for s in levels[lvl] if s.file_id != fid]
        stacked = set(edit.stacked) | {0}
        for i in sorted(stacked):
            adds_i = [s for lvl, s in edit.adds if lvl == i]
            # stacked levels (L0, tiered L1+) prepend reversed(adds): the
            # first-listed add ends up newest
            levels[i] = list(reversed(adds_i)) + levels[i]
        for lvl, s in edit.adds:
            if lvl not in stacked:
                levels[lvl].append(s)
        for i in {lvl for lvl, _ in edit.adds} - stacked:
            levels[i].sort(key=lambda s: s.min_key)
        return Version(tuple(tuple(lvl) for lvl in levels), vid=vid)


@dataclasses.dataclass
class VersionEdit:
    """``adds`` (level, sct); ``drops`` (level, file_id); ``replaces``
    (level, old file_id, new sct), an in-place swap that keeps the run's
    position (copy-on-write blob GC must not perturb L0's recency order);
    ``last_seqno`` the highest seqno this edit makes durable (manifest
    replay restores the engine's seqno watermark from the running max);
    ``stacked`` the levels whose adds in this edit are a stacked (tiered)
    run: prepended newest first like L0's, the level not re-sorted."""

    adds: List[Tuple[int, SCT]] = dataclasses.field(default_factory=list)
    drops: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    replaces: List[Tuple[int, int, SCT]] = dataclasses.field(
        default_factory=list)
    last_seqno: Optional[int] = None
    stacked: List[int] = dataclasses.field(default_factory=list)

    def record(self) -> Dict[str, object]:
        """The manifest line's object, keys in the reference's order."""
        rec: Dict[str, object] = {}
        if self.adds:
            rec["adds"] = [[lvl, s.file_id] for lvl, s in self.adds]
        if self.stacked:
            rec["stacked"] = [int(i) for i in self.stacked]
        if self.drops:
            rec["drops"] = [[lvl, fid] for lvl, fid in self.drops]
        if self.replaces:
            rec["replaces"] = [[lvl, old, s.file_id]
                               for lvl, old, s in self.replaces]
        if self.last_seqno is not None:
            rec["seqno"] = int(self.last_seqno)
        return rec


class VersionSet:
    """Atomic install point and manifest log: ``apply`` is the only way the
    shape changes; publication is one reference assignment, so readers
    holding ``current`` keep a consistent older view."""

    MANIFEST = "MANIFEST.log"

    def __init__(self, store: FileStore, max_levels: int,
                 manifest: Optional[str] = None):
        """``manifest`` names the log inside the store's spill directory
        (``MANIFEST`` by default); trees sharing one directory, the sharded
        engine's shards, each take their own."""
        self.store = store
        self._lock = threading.Lock()
        self.current = Version.empty(max_levels)
        self.last_seqno = 0
        self.manifest_name = manifest or self.MANIFEST
        self._manifest_path = (
            os.path.join(store.spill_dir, self.manifest_name)
            if store.spill_dir else None)

    def apply(self, edit: VersionEdit) -> Version:
        """Install one edit atomically; returns the new current version.
        Callers write every added SCT to the store before ``apply`` and
        delete dropped files only after it returns, so a replay never
        names a missing file, and files a crash orphans between spill and
        log are collected on restore."""
        with self._lock:
            if edit.last_seqno is not None:
                self.last_seqno = max(self.last_seqno, int(edit.last_seqno))
            new = self.current.with_edit(edit, vid=self.current.vid + 1)
            if self._manifest_path is not None:
                with open(self._manifest_path, "a") as f:
                    f.write(json.dumps(edit.record()) + "\n")
            self.current = new
            return new

    @classmethod
    def recover(cls, store: FileStore, max_levels: int,
                load: Optional[Callable[[int], SCT]] = None,
                manifest: Optional[str] = None) -> "VersionSet":
        """Replay the manifest (``manifest``, as in ``__init__``) over a
        restored store: rebuild the exact tree shape (and seqno watermark)
        the logged edits describe, each run the log keeps given by
        ``load(fid)`` (``store.payload`` by default).  A torn final line (a crash mid-append) is dropped and
        physically truncated; corruption with more edits after it
        raises."""
        vs = cls(store, max_levels, manifest=manifest)
        path = vs._manifest_path
        if path is None or not os.path.exists(path):
            return vs
        fid_levels, stacked_ever, last_seqno, vid = _replay(path,
                                                            max_levels)
        load = load or store.payload
        levels = [[load(fid) for fid in lvl] for lvl in fid_levels]
        for i in range(1, max_levels):
            # append order during replay is arbitrary; the runs of a level
            # that never held a stacked run do not overlap, so a min_key
            # sort restores the layout.  A level that did keeps its replay
            # order (its recency layout), as the reference's replay does
            if i not in stacked_ever:
                levels[i].sort(key=lambda s: s.min_key)
        vs.current = Version(tuple(tuple(lvl) for lvl in levels), vid=vid)
        vs.last_seqno = last_seqno
        return vs

    def gc_orphans(self) -> List[int]:
        """Delete spilled SCT files the current version does not reference
        (outputs a crash stranded between spill and manifest append)."""
        return gc_orphan_scts(self.store, [self.current])


def _replay(path: str, max_levels: int
            ) -> Tuple[List[List[int]], set, int, int]:
    """The manifest's edits over file ids only (an early add may name a
    file a later drop deleted from disk; payloads resolve afterwards, for
    the runs that survive the whole log) -> (file ids per level, the levels
    that ever received a stacked add, L0 among them, the seqno watermark,
    the number of edits).  Walks byte offsets, not lines: a
    crash mid-append leaves a torn final line (no newline, or garbage with
    nothing after it), which is dropped and truncated away so that later
    appends do not land on it; garbage with complete edits after it is
    not a torn tail and raises, because dropping those edits would bring
    back deleted files or lose installed ones."""
    fid_levels: List[List[int]] = [[] for _ in range(max_levels)]
    stacked_ever = {0}
    last_seqno = vid = 0
    with open(path, "rb") as f:
        data = f.read()
    good = 0
    torn = False
    while good < len(data):
        nl = data.find(b"\n", good)
        raw = data[good:nl] if nl >= 0 else data[good:]
        end = nl + 1 if nl >= 0 else len(data)
        line = raw.strip()
        if not line:
            good = end
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            rec = None
        if not isinstance(rec, dict):
            # unparseable, or a torn line whose prefix still parses ("4"
            # from a truncated number)
            if data[end:].strip():
                raise ValueError(
                    f"manifest {path} corrupted at byte {good} with "
                    "further edits after the bad record")
            torn = True
            break
        good = end
        vid += 1
        last_seqno = max(last_seqno, int(rec.get("seqno", 0)))
        for lvl, old_fid, new_fid in rec.get("replaces", ()):
            fid_levels[lvl] = [new_fid if f == old_fid else f
                               for f in fid_levels[lvl]]
        for lvl, fid in rec.get("drops", ()):
            fid_levels[lvl] = [f for f in fid_levels[lvl] if f != fid]
        adds = rec.get("adds", ())
        stacked = set(rec.get("stacked", ())) | {0}
        stacked_ever |= stacked
        for i in sorted(stacked):
            adds_i = [fid for lvl, fid in adds if lvl == i]
            fid_levels[i] = list(reversed(adds_i)) + fid_levels[i]
        for lvl, fid in adds:
            if lvl not in stacked:
                fid_levels[lvl].append(fid)
    if torn:
        with open(path, "r+b") as f:
            f.truncate(good)
    return fid_levels, stacked_ever, last_seqno, vid


def gc_orphan_scts(store: FileStore, versions: List[Version]) -> List[int]:
    """Delete SCT files referenced by none of ``versions`` (crash
    leftovers): SCTs, and the spill records a restored store holds for
    the SCTs no run was built from.  Blob value logs are never SCTs and
    are left alone."""
    live: set = set()
    for v in versions:
        live.update(v.file_ids())
    orphans = []
    for fid in list(store.fids()):
        if fid in live:
            continue
        obj = store.payload(fid)
        if isinstance(obj, SCT) or is_sct_record(obj):
            orphans.append(fid)
    for fid in orphans:
        store.delete(fid)
    return orphans
