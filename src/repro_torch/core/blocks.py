"""Block-granular SCT metadata: per-block key ranges, blooms and zone maps.

Port of ``repro/core/blocks.py``.  Keys, key ranges and bloom bits stay on
the host as numpy (``get`` probes them there); the per-block code zone map
(``code_lo``/``code_hi``) and SUM weight totals are computed on the device
from the codes the packed words hold and stay there, as int64 tensors
holding the reference's uint32 / int64 values.

Blooms use the reference's splitmix64 hash family and seeds, so the bits
are identical; the scatter is a bool bitset packed little-endian into
uint32 words instead of ``np.bitwise_or.at``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)
BLOOM_SEEDS = np.asarray(
    [0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB,
     0xD6E8FEB86659FD93, 0xA5A3564E6F5C1D9B, 0xC2B2AE3D27D4EB4F],
    dtype=np.uint64,
)
EMPTY_LO = 0xFFFFFFFF  # zone of a block without entries: (0xFFFFFFFF, 0)


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
        x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
        x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
        return x ^ (x >> np.uint64(31))


def _block_reduce(vals: torch.Tensor, n_blocks: int, epb: int, fill: int,
                  op: str) -> torch.Tensor:
    """Per-block min / max / sum of int64 ``vals`` [n] over blocks of
    ``epb`` entries; blocks past the data keep ``fill``."""
    n = vals.shape[0]
    out = torch.full((n_blocks,), fill, dtype=torch.int64, device=vals.device)
    if n:
        full = -(-n // epb)
        pad = torch.full((full * epb - n,), fill, dtype=torch.int64,
                         device=vals.device)
        grid = torch.cat([vals.to(torch.int64), pad]).reshape(full, epb)
        red = {"min": grid.amin, "max": grid.amax, "sum": grid.sum}[op]
        out[:full] = red(dim=1)
    return out


@dataclasses.dataclass
class BlockIndex:
    """Per-block first/last key + bloom bits, and for 'opd' SCTs the code
    zone map and per-block SUM weight totals (device tensors)."""

    entries_per_block: int
    first_keys: np.ndarray      # uint64 [n_blocks]
    last_keys: np.ndarray       # uint64 [n_blocks]
    bloom_words: np.ndarray     # uint32 [n_blocks, words_per_block]
    n_hashes: int
    nbits: int                  # bits per block bloom
    code_lo: Optional[torch.Tensor] = None      # int64 [n_blocks] (uint32 values)
    code_hi: Optional[torch.Tensor] = None      # int64 [n_blocks] (uint32 values)
    weight_sums: Optional[torch.Tensor] = None  # int64 [n_blocks]

    @property
    def n_blocks(self) -> int:
        return int(self.first_keys.shape[0])

    @property
    def has_zones(self) -> bool:
        return self.code_lo is not None and self.code_hi is not None

    @property
    def nbytes(self) -> int:
        """Serialized metadata size: uint64 key ranges, uint32 bloom words,
        uint32 zone columns and int64 weight sums, as the reference
        stores them."""
        nb = self.n_blocks
        total = 16 * nb + int(self.bloom_words.nbytes)
        if self.has_zones:
            total += 8 * nb
        if self.weight_sums is not None:
            total += 8 * nb
        return total

    @staticmethod
    def build(keys: np.ndarray, entries_per_block: int,
              bits_per_key: int = 10, n_hashes: int = 6) -> "BlockIndex":
        n = keys.shape[0]
        epb = max(1, int(entries_per_block))
        n_blocks = max(1, (n + epb - 1) // epb)
        nbits = max(64, int(epb * bits_per_key))
        nbits = ((nbits + 31) // 32) * 32
        words_pb = nbits // 32
        first = np.zeros(n_blocks, np.uint64)
        last = np.zeros(n_blocks, np.uint64)
        bits = np.zeros(n_blocks * nbits, np.bool_)
        if n:
            edges = np.minimum(np.arange(n_blocks) * epb, n - 1)
            ends = np.minimum(edges + epb - 1, n - 1)
            first[:] = keys[edges]
            last[:] = keys[ends]
            base = (np.arange(n, dtype=np.int64) // epb) * nbits
            for s in range(n_hashes):
                h = splitmix64(keys ^ BLOOM_SEEDS[s]) % np.uint64(nbits)
                bits[base + h.astype(np.int64)] = True
        bloom = np.packbits(bits, bitorder="little").view("<u4")
        return BlockIndex(epb, first, last,
                          bloom.astype(np.uint32).reshape(n_blocks, words_pb),
                          n_hashes, nbits)

    # ------------------------------------------------------------------ #
    # code zone map and weight sums ('opd' codec), on the device
    # ------------------------------------------------------------------ #
    def attach_code_zones(self, field_vals: torch.Tensor) -> None:
        """Per-block min/max of the packed field values (uint32 values in
        an int64 or int32 tensor; tombstones appear as 0, as the packed
        words store them)."""
        nb, epb = self.n_blocks, self.entries_per_block
        vals = field_vals.to(torch.int64)
        self.code_lo = _block_reduce(vals, nb, epb, EMPTY_LO, "min")
        self.code_hi = _block_reduce(vals, nb, epb, 0, "max")

    def attach_weight_sums(self, entry_weights: torch.Tensor) -> None:
        """Per-block totals of int64 entry weights (0 at tombstones)."""
        self.weight_sums = _block_reduce(entry_weights, self.n_blocks,
                                         self.entries_per_block, 0, "sum")

    # ------------------------------------------------------------------ #
    # point-lookup probes (host)
    # ------------------------------------------------------------------ #
    def locate_block_range(self, key: np.uint64) -> Tuple[int, int]:
        """Inclusive [b_lo, b_hi] range of blocks that may contain key, or
        (-1, -1); duplicate versions of a key may span block boundaries."""
        b_lo = int(np.searchsorted(self.last_keys, key, side="left"))
        if b_lo >= self.n_blocks or self.first_keys[b_lo] > key:
            return -1, -1
        b_hi = int(np.searchsorted(self.first_keys, key, side="right")) - 1
        return b_lo, max(b_lo, b_hi)

    def may_contain(self, block: int, key: np.uint64) -> bool:
        nbits = np.uint64(self.nbits)
        for s in range(self.n_hashes):
            h = splitmix64(np.uint64(key) ^ BLOOM_SEEDS[s]) % nbits
            w = int(h >> np.uint64(5))
            bit = np.uint32(1) << np.uint32(h & np.uint64(31))
            if not (self.bloom_words[block, w] & bit):
                return False
        return True

    def probe_range(self, key: np.uint64) -> Tuple[int, int, bool]:
        """(b_lo, b_hi, may_contain): the bloom verdict is the OR across
        every block the key's versions could occupy."""
        b_lo, b_hi = self.locate_block_range(key)
        if b_lo < 0:
            return -1, -1, False
        maybe = any(self.may_contain(b, key) for b in range(b_lo, b_hi + 1))
        return b_lo, b_hi, maybe
