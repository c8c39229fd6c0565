"""In-memory file store with exact I/O accounting.

Port of ``repro/storage/io.py`` for the in-memory path: SCT objects stay in
memory (their packed words on the card), and every logical read or write
records the serialized on-disk size and an I/O request count.  Spilling to a
directory (``spill_dir``) and ``FileStore.restore`` are not ported yet
(ROADMAP §1, durability).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional


@dataclasses.dataclass
class IOStats:
    bytes_read: int = 0
    bytes_written: int = 0
    read_ios: int = 0
    write_ios: int = 0

    def __post_init__(self) -> None:
        # not a dataclass field: replace() constructs a fresh lock
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
    """In-memory object store with byte-accurate accounting."""

    def __init__(self, spill_dir: Optional[str] = None):
        if spill_dir:
            raise ValueError("FileStore(spill_dir=...) is not ported yet: "
                             "see ROADMAP §1, durability")
        self._objects: Dict[int, Any] = {}
        self._sizes: Dict[int, int] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.stats = IOStats()
        self.spill_dir = None

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
        return fid

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

    def payload(self, fid: int) -> Any:
        """The stored object with no I/O charged, for callers that do their
        own accounting (blob value reads, blob GC rewrites)."""
        with self._lock:
            return self._objects[fid]

    def size_of(self, fid: int) -> int:
        with self._lock:
            return self._sizes[fid]

    @property
    def n_files(self) -> int:
        with self._lock:
            return len(self._objects)
