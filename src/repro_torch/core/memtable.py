"""Memory-resident buffering component (paper §3).

Port of ``repro/core/memtable.py`` with the same contract: per-key version
chains (a read at snapshot seqno s sees the newest version with seqno <= s)
and a sorted columnar snapshot at freeze time, whose sort fixes the value
domain for OPD construction.

The reference keeps a dict of per-key chains and fills it one Python call
per write.  This port keeps the writes columnar: batches append numpy
chunks, single writes append to small lists, and a (key asc, seqno desc)
sorted view is built on demand and cached until the next write.  Bulk
ingest is then a few array copies per batch instead of a Python call per
row.  Values are stored as ``S<value_width>`` (the supported domain of
``as_fixed_bytes``: no NUL bytes, at most ``value_width`` bytes).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_SEQ_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_U64_MAX = 2**64 - 1

MemTables = Union[None, "MemTable", Sequence["MemTable"]]


def as_mems(memtable: MemTables) -> List["MemTable"]:
    """Normalize a ``MemTables`` argument to a (possibly empty) list."""
    if memtable is None:
        return []
    if isinstance(memtable, MemTable):
        return [memtable]
    return list(memtable)


@dataclasses.dataclass
class FrozenMemtable:
    """Sorted columnar snapshot: (key asc, seqno desc), all live versions."""

    keys: np.ndarray     # uint64 [n]
    seqnos: np.ndarray   # uint64 [n]
    tombs: np.ndarray    # bool   [n]
    values: np.ndarray   # S<w>   [n]  (b"" rows for tombstones)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])


class MemTable:
    def __init__(self, value_width: int, key_bytes: int = 16):
        self.value_width = value_width
        self.key_bytes = key_bytes
        self._chunks: List[Tuple[np.ndarray, ...]] = []  # (keys, seqs, tombs, vals)
        self._rows: List[Tuple[int, int, bool, bytes]] = []  # single writes
        self._view: Optional[FrozenMemtable] = None
        self._lock = threading.Lock()
        self.approx_bytes = 0
        self.n_versions = 0
        self.frozen = False

    # ------------------------------------------------------------------ #
    def _check_writable(self) -> None:
        if self.frozen:
            raise RuntimeError("memtable is frozen")

    def put(self, key: int, value: bytes, seqno: int) -> None:
        with self._lock:
            self._check_writable()
            self._rows.append((int(key), int(seqno), False, value))
            self.approx_bytes += self.key_bytes + 8 + self.value_width
            self.n_versions += 1
            self._view = None

    def delete(self, key: int, seqno: int) -> None:
        with self._lock:
            self._check_writable()
            self._rows.append((int(key), int(seqno), True, b""))
            self.approx_bytes += self.key_bytes + 8
            self.n_versions += 1
            self._view = None

    def put_many(self, keys: np.ndarray, seqnos: np.ndarray,
                 values: np.ndarray) -> None:
        """Columnar bulk put: uint64 keys/seqnos [n], ``S<w>`` values [n]."""
        n = int(keys.shape[0])
        with self._lock:
            self._check_writable()
            self._spill_rows()
            self._chunks.append((
                np.asarray(keys, np.uint64), np.asarray(seqnos, np.uint64),
                np.zeros(n, np.bool_),
                np.asarray(values, f"S{self.value_width}")))
            self.approx_bytes += n * (self.key_bytes + 8 + self.value_width)
            self.n_versions += n
            self._view = None

    def _spill_rows(self) -> None:
        if not self._rows:
            return
        k, s, t, v = zip(*self._rows)
        self._chunks.append((np.asarray(k, np.uint64), np.asarray(s, np.uint64),
                             np.asarray(t, np.bool_),
                             np.asarray(v, f"S{self.value_width}")))
        self._rows = []

    def _sorted(self) -> FrozenMemtable:
        """All versions sorted (key asc, seqno desc); cached until a write."""
        with self._lock:
            if self._view is None:
                self._spill_rows()
                if self._chunks:
                    cols = [np.concatenate(c) for c in zip(*self._chunks)]
                    self._chunks = [tuple(cols)]
                else:
                    w = self.value_width
                    cols = [np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                            np.zeros(0, np.bool_), np.zeros(0, f"S{w}")]
                keys, seqs, tombs, vals = cols
                order = np.lexsort((_SEQ_MAX - seqs, keys))
                self._view = FrozenMemtable(keys[order], seqs[order],
                                            tombs[order], vals[order])
            return self._view

    # ------------------------------------------------------------------ #
    def get(self, key: int, max_seqno: Optional[int] = None
            ) -> Optional[Tuple[int, Optional[bytes]]]:
        """Newest visible (seqno, value|None) or None if key unseen here."""
        v = self._sorted()
        k = np.uint64(key)
        lo = int(np.searchsorted(v.keys, k, side="left"))
        hi = int(np.searchsorted(v.keys, k, side="right"))
        for i in range(lo, hi):
            seq = int(v.seqnos[i])
            if max_seqno is None or seq <= max_seqno:
                return seq, (None if v.tombs[i] else bytes(v.values[i]))
        return None

    def newest_rows(self, max_seqno: Optional[int] = None,
                    lo: Optional[int] = None, hi: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Newest visible version per key as columnar arrays
        ``(keys, seqnos, tombs, values)``, tombstones included; with ``lo``
        / ``hi``, only keys in ``[lo, hi]``."""
        v = self._sorted()
        keys, seqs, tombs, vals = v.keys, v.seqnos, v.tombs, v.values
        a, b = 0, keys.shape[0]
        if lo is not None and lo > 0:
            a = b if lo > _U64_MAX else int(np.searchsorted(keys, np.uint64(lo)))
        if hi is not None and hi < _U64_MAX:
            b = 0 if hi < 0 else int(np.searchsorted(keys, np.uint64(hi),
                                                      side="right"))
        sl = slice(a, max(a, b))
        keys, seqs, tombs, vals = keys[sl], seqs[sl], tombs[sl], vals[sl]
        if max_seqno is not None:
            vis = seqs <= np.uint64(max_seqno)
            keys, seqs, tombs, vals = keys[vis], seqs[vis], tombs[vis], vals[vis]
        first = np.ones(keys.shape[0], np.bool_)
        first[1:] = keys[1:] != keys[:-1]
        return keys[first], seqs[first], tombs[first], vals[first]

    def freeze(self) -> FrozenMemtable:
        """Freeze + columnarize.  The source domain is now fixed."""
        view = self._sorted()
        with self._lock:
            self.frozen = True
        return view

    @property
    def n_keys(self) -> int:
        return int(np.unique(self._sorted().keys).shape[0])
