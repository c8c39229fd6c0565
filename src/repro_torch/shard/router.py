"""Range-partitioned key router for the sharded LSM-OPD engine.

Port of ``repro/shard/router.py``, host numpy as in the reference: the
boundary table is a few integers and routing a batch is one
``searchsorted`` before the keys reach any shard tree.

The router owns a boundary table: shard ``i`` covers the half-open key
range ``[lower_i, upper_i)`` where ``upper_i == uppers[i]`` and
``lower_i == uppers[i-1]`` (``lower_0 == 0``).  The last shard's upper
bound is ``key_max``.  Routing a key is one binary search over the
(tiny, memory-resident) upper-bound array; routing a batch is one
vectorized ``searchsorted`` — the same branch-free idiom the engine
uses everywhere else in place of pointer structures.

Splits insert a boundary: shard ``i`` becomes ``[lower_i, pivot)`` and
``[pivot, upper_i)``.  The table only ever grows, and shard order always
equals key order, so scatter-gather reads that concatenate per-shard
results in shard order produce globally key-sorted output for free.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

KEY_MAX = 2 ** 64  # exclusive upper bound of the uint64 key space


class ShardRouter:
    def __init__(self, n_shards: int, key_max: int = KEY_MAX):
        if not (1 <= n_shards):
            raise ValueError(f"need n_shards >= 1, got {n_shards}")
        if not (n_shards <= key_max):
            raise ValueError(f"{n_shards} shards cannot partition "
                             f"[0, {key_max})")
        self.key_max = int(key_max)
        span = key_max / n_shards
        uppers = [int(round(span * (i + 1))) for i in range(n_shards - 1)]
        uppers.append(int(key_max))
        # uint64 copy used for vectorized routing; KEY_MAX == 2**64 does
        # not fit in uint64, but the last bound is never searched (a key
        # is always < it), so it is held only in the Python-int table.
        self._uppers: List[int] = uppers
        self._search = np.asarray(uppers[:-1], np.uint64)

    @classmethod
    def from_uppers(cls, uppers: List[int], key_max: int = KEY_MAX
                    ) -> "ShardRouter":
        """Rebuild a router from a persisted boundary table (the sharded
        engine's restart path; ``uppers[-1]`` must equal ``key_max``)."""
        if not uppers or uppers[-1] != key_max:
            raise ValueError(f"boundary table {uppers} does not cover "
                             f"[0, {key_max})")
        r = cls(1, key_max)
        r._uppers = [int(u) for u in uppers]
        r._search = np.asarray(r._uppers[:-1], np.uint64)
        return r

    # ------------------------------------------------------------------ #
    @property
    def n_shards(self) -> int:
        return len(self._uppers)

    @property
    def uppers(self) -> List[int]:
        """Exclusive upper bounds, one per shard (a copy)."""
        return list(self._uppers)

    def bounds(self, i: int) -> Tuple[int, int]:
        """Half-open key range [lo, hi) owned by shard i."""
        lo = 0 if i == 0 else self._uppers[i - 1]
        return lo, self._uppers[i]

    # ------------------------------------------------------------------ #
    # routing
    # ------------------------------------------------------------------ #
    def shard_of(self, key: int) -> int:
        """Binary-search the boundary table: O(log N), N = shard count."""
        if not (0 <= key < self.key_max):
            raise KeyError(f"key {key} outside [0, {self.key_max})")
        return int(np.searchsorted(self._search, np.uint64(key),
                                   side="right"))

    def shard_of_batch(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized routing: shard id per key (one searchsorted)."""
        return np.searchsorted(self._search, keys.astype(np.uint64),
                               side="right").astype(np.int64)

    def shards_for_range(self, lo: int, hi: int) -> range:
        """Shard indices whose ranges intersect the inclusive [lo, hi]."""
        if hi < lo:
            return range(0)
        a = self.shard_of(max(0, min(lo, self.key_max - 1)))
        b = self.shard_of(max(0, min(hi, self.key_max - 1)))
        return range(a, b + 1)

    # ------------------------------------------------------------------ #
    # split protocol
    # ------------------------------------------------------------------ #
    def split(self, i: int, pivot: int) -> None:
        """Split shard i at ``pivot``: [lo, hi) -> [lo, pivot) + [pivot, hi).

        ``pivot`` must fall strictly inside shard i's range so both
        halves are non-empty key ranges.
        """
        lo, hi = self.bounds(i)
        if not (lo < pivot < hi):
            raise ValueError(f"pivot {pivot} not inside shard {i} "
                             f"range [{lo}, {hi})")
        self._uppers.insert(i, int(pivot))
        self._search = np.asarray(self._uppers[:-1], np.uint64)

    def __repr__(self) -> str:
        return f"ShardRouter(n_shards={self.n_shards}, uppers={self._uppers})"
