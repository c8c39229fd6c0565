"""Aggregate specs, partials and the merge contract.

Port of ``repro/query/spec.py``.  An ``AggSpec`` is one aggregate over the
value column:

  op          'count' | 'sum' | 'min' | 'max' | 'group_count'
  pred        optional filter Predicate (None = whole column)
  group       GroupBy for op='group_count'
  top_k       keep only the k most populous groups (applied after the
              merge: partials always carry every group)

SUM reads a value as its first contiguous ASCII-digit run, parsed as an
integer and clipped to int32 max (``numeric_values``), computed once per
dictionary code and gathered.

``AggPartial`` is the mergeable partial every source (run, memtable rows)
reduces to: count, total, min/max as value bytes (partials from different
dictionaries compare in value space) and group counts.  ``merge`` is
associative and commutative with the empty partial as identity;
``finalize_partial`` applies top-k with the (-count, label) tie-break.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.opd import Predicate

INT32_MAX = 2**31 - 1

AGG_OPS = ("count", "sum", "min", "max", "group_count")


@dataclasses.dataclass(frozen=True)
class GroupBy:
    """Grouping key derived from the value itself.

    kind='prefix':  label = the first ``prefix_len`` bytes of the value (an
                    interval of codes in any sorted dictionary).
    kind='bucket':  ``n_buckets`` range buckets over the value domain;
                    ``edges`` holds the interior boundaries (bytes,
                    ascending) once ``planner.resolve_specs`` fixes them.
    """
    kind: str = "prefix"
    prefix_len: int = 8
    n_buckets: int = 8
    edges: Optional[Tuple[bytes, ...]] = None

    def __post_init__(self):
        if self.kind not in ("prefix", "bucket"):
            raise ValueError(f"GroupBy.kind must be 'prefix' or 'bucket', "
                             f"got {self.kind!r}")

    def resolved(self) -> bool:
        return self.kind == "prefix" or self.edges is not None

    def bucket_label(self, b: int) -> bytes:
        """Lower-bound label of bucket b (bucket 0 is open below)."""
        if self.edges is None:
            raise ValueError("bucket GroupBy has no edges yet")
        return b"" if b == 0 else self.edges[b - 1]


@dataclasses.dataclass(frozen=True)
class AggSpec:
    op: str
    pred: Optional[Predicate] = None
    group: Optional[GroupBy] = None
    top_k: Optional[int] = None

    def __post_init__(self):
        if self.op not in AGG_OPS:
            raise ValueError(f"AggSpec.op must be one of {AGG_OPS}, "
                             f"got {self.op!r}")
        if self.op == "group_count" and self.group is None:
            raise ValueError("group_count needs a GroupBy")

    def plan_pred(self) -> Predicate:
        """The predicate actually planned: None means match-all, the empty
        prefix (code range [0, D))."""
        return self.pred if self.pred is not None else Predicate("prefix", b"")


@dataclasses.dataclass
class AggPartial:
    count: int = 0
    total: int = 0
    min_value: Optional[bytes] = None
    max_value: Optional[bytes] = None
    groups: Optional[Dict[bytes, int]] = None

    def merge(self, other: "AggPartial") -> "AggPartial":
        out = AggPartial(self.count + other.count, self.total + other.total)
        vals = [v for v in (self.min_value, other.min_value) if v is not None]
        out.min_value = min(vals) if vals else None
        vals = [v for v in (self.max_value, other.max_value) if v is not None]
        out.max_value = max(vals) if vals else None
        if self.groups is not None or other.groups is not None:
            out.groups = dict(self.groups or {})
            for label, c in (other.groups or {}).items():
                out.groups[label] = out.groups.get(label, 0) + c
        return out

    def add_group_counts(self, labels, counts) -> None:
        if self.groups is None:
            self.groups = {}
        for label, c in zip(labels, counts):
            label = bytes(label)
            self.groups[label] = self.groups.get(label, 0) + int(c)
        self.count += int(np.sum(counts))


@dataclasses.dataclass
class AggResult:
    op: str
    count: int = 0
    total: int = 0
    min_value: Optional[bytes] = None
    max_value: Optional[bytes] = None
    groups: Optional[List[Tuple[bytes, int]]] = None  # sorted, top-k applied

    @property
    def value(self):
        """The answer of the spec's op."""
        return {"count": self.count, "sum": self.total,
                "min": self.min_value, "max": self.max_value,
                "group_count": self.groups}[self.op]


def merge_partials(parts: List[AggPartial]) -> AggPartial:
    out = AggPartial()
    for p in parts:
        out = out.merge(p)
    return out


def finalize_partial(spec: AggSpec, part: AggPartial) -> AggResult:
    res = AggResult(spec.op, count=part.count, total=part.total,
                    min_value=part.min_value, max_value=part.max_value)
    if spec.op == "group_count":
        items = sorted((part.groups or {}).items(),
                       key=lambda kv: (-kv[1], kv[0]))
        if spec.top_k is not None:
            items = items[:spec.top_k]
        res.groups = items
    return res


def numeric_values(vals: np.ndarray, device="cpu") -> torch.Tensor:
    """int64 numeric weight per value [n], on ``device``: the first
    contiguous ASCII-digit run parsed as an integer, clipped to int32 max
    at every digit; no digits -> 0."""
    vals = np.ascontiguousarray(vals)
    n = vals.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    w = vals.dtype.itemsize
    b = torch.from_numpy(np.frombuffer(vals.tobytes(), np.uint8)
                         .reshape(n, w).copy()).to(device)
    digit = (b >= 48) & (b <= 57)
    started = torch.cumsum(digit, dim=1) > 0
    ended = torch.cumsum(started & ~digit, dim=1) > 0
    in_run = digit & ~ended  # first digit run only
    d = b.to(torch.int64) - 48
    out = torch.zeros(n, dtype=torch.int64, device=device)
    for j in range(w):
        out = torch.where(in_run[:, j],
                          torch.clamp(out * 10 + d[:, j], max=INT32_MAX), out)
    return out


def prefix_labels(vals: np.ndarray, prefix_len: int) -> np.ndarray:
    """Group label per value for 'prefix' grouping (S-dtype truncation)."""
    return np.ascontiguousarray(vals).astype(f"S{prefix_len}")


def bucket_ids(vals: np.ndarray, edges: Tuple[bytes, ...]) -> np.ndarray:
    """Bucket id per value for 'bucket' grouping: #(interior edges <= v).
    An edge longer than the value width compares exclusively after
    truncation, as ``filter_exec._lower_mask`` plans it."""
    vals = np.ascontiguousarray(vals)
    w = vals.dtype.itemsize
    ids = np.zeros(vals.shape[0], np.int64)
    for e in edges:
        bound = np.asarray([e], f"S{w}")[0]
        ids += (vals > bound) if len(e) > w else (vals >= bound)
    return ids
