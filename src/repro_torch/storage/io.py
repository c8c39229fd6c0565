"""File store with exact I/O accounting.

Port of ``repro/storage/io.py``.  SCT objects stay in memory (their packed
words on the card), and every logical read or write records the serialized
on-disk size and an I/O request count, so ``devices.DeviceModel`` can turn
the counts into modeled seconds.  With a ``spill_dir`` every object is
also written to ``f<fid>.bin`` there (through a ``.tmp`` file and
``os.replace``) and ``delete`` removes the file; ``FileStore.restore``
reads the files back after a restart.

The spill format is the port's own: an object that has a
``spill_record()`` method (an SCT, whose words, zones and weight sums lie
on the card and which holds its tree's blob manager) is written as the
record it returns, made of numpy arrays, bytes and builtins only; any
other object (a value log) is pickled as it is.  A restored store holds
those records; ``LSMTree.restore`` builds the SCTs of the runs its
manifest keeps on its device and puts them back with ``put_payload``.  The
bytes charged for a write stay the SCT's modeled ``disk_bytes``, never the
file's size, so the I/O counts equal the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import time
from typing import Any, Dict, Optional

_SPILL_FMT = "f{fid:08d}.bin"


@dataclasses.dataclass
class IOStats:
    bytes_read: int = 0
    bytes_written: int = 0
    read_ios: int = 0
    write_ios: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def add_read(self, nbytes: int, n_ios: int = 1) -> None:
        with self._lock:
            self.bytes_read += int(nbytes)
            self.read_ios += int(n_ios)

    def add_write(self, nbytes: int, n_ios: int = 1) -> None:
        with self._lock:
            self.bytes_written += int(nbytes)
            self.write_ios += int(n_ios)


class FileStore:
    """In-memory object store with byte-accurate accounting; spills every
    object to ``spill_dir`` when one is given.  ``spill_seconds`` and
    ``spill_bytes`` add up the spill files' writes (host clock, file
    sizes); they are not I/O counts."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._objects: Dict[int, Any] = {}
        self._sizes: Dict[int, int] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.stats = IOStats()
        self.spill_dir = spill_dir
        self.spill_seconds = 0.0
        self.spill_bytes = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    @classmethod
    def restore(cls, spill_dir: str) -> "FileStore":
        """Rehydrate a store from its spilled files (restart path).

        Rebuilds the objects, sizes and the next id from every
        ``f<fid>.bin`` under ``spill_dir``; the next ``alloc_id`` never
        collides with a restored file.  An SCT comes back as its spill
        record.  Restored contents are charged to neither read nor write
        counters (accounting restarts at zero, like a process restart)."""
        store = cls(spill_dir)
        for name in sorted(os.listdir(spill_dir)):
            if not (name.startswith("f") and name.endswith(".bin")):
                continue
            fid = int(name[1:-4])
            with open(os.path.join(spill_dir, name), "rb") as f:
                obj, nbytes = pickle.load(f)
            store._objects[fid] = obj
            store._sizes[fid] = int(nbytes)
            store._next_id = max(store._next_id, fid + 1)
        return store

    def alloc_id(self) -> int:
        with self._lock:
            fid = self._next_id
            self._next_id += 1
            return fid

    def write(self, obj: Any, nbytes: int, fid: Optional[int] = None) -> int:
        if fid is None:
            fid = self.alloc_id()
        with self._lock:
            self._objects[fid] = obj
            self._sizes[fid] = int(nbytes)
            self._next_id = max(self._next_id, fid + 1)
        self.stats.add_write(nbytes)
        if self.spill_dir:
            t0 = time.perf_counter()
            record = getattr(obj, "spill_record", None)
            path = os.path.join(self.spill_dir, _SPILL_FMT.format(fid=fid))
            with open(path + ".tmp", "wb") as f:
                pickle.dump((record() if record else obj, int(nbytes)), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
                size = f.tell()
            os.replace(path + ".tmp", path)
            self.spill_seconds += time.perf_counter() - t0
            self.spill_bytes += size
        return fid

    def put_payload(self, fid: int, obj: Any) -> None:
        """Swap the in-memory object of live file ``fid`` (a restored
        record for the SCT built from it), with no I/O charged and the
        file left as it is."""
        with self._lock:
            if fid not in self._objects:
                raise KeyError(fid)
            self._objects[fid] = obj

    def read(self, fid: int, nbytes: Optional[int] = None) -> Any:
        """Full-file read (the paper's bulk-read path for long scans)."""
        with self._lock:
            n = self._sizes[fid] if nbytes is None else int(nbytes)
            obj = self._objects[fid]
        self.stats.add_read(n)
        return obj

    def delete(self, fid: int) -> None:
        with self._lock:
            self._objects.pop(fid, None)
            self._sizes.pop(fid, None)
        if self.spill_dir:
            path = os.path.join(self.spill_dir, _SPILL_FMT.format(fid=fid))
            if os.path.exists(path):
                os.remove(path)

    def contains(self, fid: int) -> bool:
        """Whether ``fid`` is live in the store."""
        with self._lock:
            return fid in self._sizes

    def payload(self, fid: int) -> Any:
        """The stored object with no I/O charged, for callers that do their
        own accounting (blob value reads, blob GC rewrites)."""
        with self._lock:
            return self._objects[fid]

    def size_of(self, fid: int) -> int:
        with self._lock:
            return self._sizes[fid]

    def fids(self) -> list:
        """Live file ids (manifest recovery scans them for orphaned SCT
        files)."""
        with self._lock:
            return list(self._objects.keys())

    @property
    def n_files(self) -> int:
        with self._lock:
            return len(self._objects)
