"""Order-Preserving Dictionary (OPD), the paper's core primitive.

Port of ``repro/core/opd.py``.  Dictionaries stay on the host as numpy
``S<w>`` arrays (torch has no fixed-width byte-string dtype): their
comparison is lexicographic byte order, so construction is a sort + unique
and predicate planning two binary searches.  Only the codes go to the card.

* ``OPD.build``: flush-time construction, codes = ranks.
* ``OPD.code_range``: predicate -> code range [lo, hi) in O(log D); an
  empty plan is always the canonical ``(0, 0)`` (the reference can return
  ``lo > hi`` for an inverted 'range'; both mean "no code").
* ``OPD.merge_subset_flat``: Algorithm 1's dictionary rebuild for one
  output SCT, in the operand layout of the remap kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def as_fixed_bytes(values: Sequence[bytes] | np.ndarray, width: int) -> np.ndarray:
    """Coerce values to a fixed-width numpy bytes array (dtype ``S<width>``).

    Supported domain: values and predicate operands contain no NUL bytes
    (shorter values are NUL-padded, so an embedded NUL is indistinguishable
    from padding); longer values are truncated to ``width``."""
    return np.asarray(values, dtype=f"S{width}")


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A filter predicate over the (string) value domain.

    kind:
      'eq'      value == a
      'prefix'  value startswith a
      'range'   a <= value <= b             (inclusive)
      'ge'      value >= a
      'le'      value <= b
    """

    kind: str
    a: bytes = b""
    b: bytes = b""

    def matches(self, value: bytes) -> bool:
        v = value.rstrip(b"\x00")
        if self.kind == "eq":
            return v == self.a
        if self.kind == "prefix":
            return v.startswith(self.a)
        if self.kind == "range":
            return self.a <= v <= self.b
        if self.kind == "ge":
            return v >= self.a
        if self.kind == "le":
            return v <= self.b
        raise ValueError(f"bad predicate kind {self.kind!r}")


@dataclasses.dataclass
class OPD:
    """values: sorted unique fixed-width byte strings; code i <-> values[i]."""

    values: np.ndarray  # dtype S<w>, sorted ascending, unique

    @staticmethod
    def build(raw_values: np.ndarray) -> Tuple["OPD", np.ndarray]:
        """Flush-time construction: sort + unique, codes = ranks.

        Returns (opd, codes[int32]) with ``opd.values[codes] == raw_values``.
        """
        uniq, inverse = np.unique(raw_values, return_inverse=True)
        return OPD(uniq), inverse.reshape(-1).astype(np.int32)

    @property
    def size(self) -> int:  # D_i, the number of distinct values
        return int(self.values.shape[0])

    @property
    def width(self) -> int:  # S_V, the value width in bytes
        return self.values.dtype.itemsize

    @property
    def code_bits(self) -> int:
        """Minimal bits per code (log2 m)."""
        return max(1, int(np.ceil(np.log2(max(self.size, 2)))))

    @property
    def nbytes(self) -> int:
        """Memory-resident dictionary footprint."""
        return int(self.values.nbytes)

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """O(1) per code: a code is the offset into the dictionary."""
        return self.values[codes]

    def code_range(self, pred: Predicate) -> Tuple[int, int]:
        """Return [lo, hi) such that pred holds iff lo <= code < hi, with
        ``0 <= lo <= hi <= size``; an empty plan is ``(0, 0)``.

        Operands longer than the value width: an over-long 'eq'/'prefix'
        operand matches nothing; an over-long lower bound excludes its own
        truncation; an over-long upper bound is truncation-safe."""
        lo, hi = self._plan(pred)
        return (lo, hi) if lo < hi else (0, 0)

    def _plan(self, pred: Predicate) -> Tuple[int, int]:
        w = self.width
        vals = self.values
        if pred.kind == "eq":
            if len(pred.a) > w:
                return 0, 0
            a = np.asarray([pred.a], dtype=f"S{w}")[0]
            return (int(np.searchsorted(vals, a, side="left")),
                    int(np.searchsorted(vals, a, side="right")))
        if pred.kind == "prefix":
            if len(pred.a) == 0:
                return 0, self.size
            if len(pred.a) > w:
                return 0, 0
            lo_key = np.asarray([pred.a], dtype=f"S{w}")[0]
            hi_key = np.asarray([pred.a + b"\xff" * (w - len(pred.a))],
                                dtype=f"S{w}")[0]
            return (int(np.searchsorted(vals, lo_key, side="left")),
                    int(np.searchsorted(vals, hi_key, side="right")))
        if pred.kind == "range":
            return self._lower_code(pred.a), self._upper_code(pred.b)
        if pred.kind == "ge":
            return self._lower_code(pred.a), self.size
        if pred.kind == "le":
            return 0, self._upper_code(pred.b)
        raise ValueError(f"bad predicate kind {pred.kind!r}")

    def _lower_code(self, a: bytes) -> int:
        """First code with ``value >= a`` (an over-long bound must exclude
        values equal to its truncation)."""
        w = self.width
        side = "right" if len(a) > w else "left"
        return int(np.searchsorted(self.values, np.asarray([a], f"S{w}")[0],
                                   side))

    def _upper_code(self, b: bytes) -> int:
        """One past the last code with ``value <= b``."""
        w = self.width
        return int(np.searchsorted(self.values, np.asarray([b], f"S{w}")[0],
                                   "right"))

    @staticmethod
    def merge_subset_flat(
        opds: Sequence["OPD"], used: Sequence[np.ndarray]
    ) -> Tuple["OPD", np.ndarray, np.ndarray]:
        """Algorithm 1's dictionary rebuild for one output SCT.

        ``used[i]`` is a bool mask over source dictionary i's codes.  One
        ``np.unique`` over the used entries of all sources is the sorted
        merge; one ``searchsorted`` gives every remap at once.

        Returns ``(new_opd, flat, offsets)``: ``flat`` is the concatenated
        ``old_code -> new_code`` table (-1 at unused codes) and
        ``offsets[i]`` the base of source i's slice, so that
        ``new_code == flat[old_code + offsets[src]]``."""
        sizes = np.fromiter((o.size for o in opds), np.int64, len(opds))
        offsets = np.zeros(len(opds) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        total = int(offsets[-1])
        dtype = opds[0].values.dtype
        if total == 0:
            return OPD(np.asarray([], dtype=dtype)), np.zeros(0, np.int32), offsets
        all_used = np.concatenate(used)
        sel = np.concatenate([o.values[m] for o, m in zip(opds, used)])
        new_vals = np.unique(sel)
        flat = np.full(total, -1, np.int32)
        flat[all_used] = np.searchsorted(new_vals, sel).astype(np.int32)
        return OPD(new_vals), flat, offsets
