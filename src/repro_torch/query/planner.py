"""Aggregate planning: predicate -> code ranges, grouping keys -> code
edges, bucket-edge resolution and the fast-path eligibility check.

Port of ``repro/query/planner.py``.  Planning works on the host
dictionaries (``S<w>`` numpy arrays, two binary searches per predicate);
only the per-code SUM weight table goes to the card, where the
``fused_zone_agg`` kernel gathers from it.

* ``resolve_specs`` pins 'bucket' group edges to equi-depth cuts of the
  observed sorted-unique value domain (``collect_domain``: each 'opd' run's
  dictionary, a competitor run's decoded live values).
* ``group_code_edges`` maps a resolved grouping onto one dictionary's code
  space as B+1 ascending edges, clipped to the spec's planned code window
  so one histogram counts filter and group together.
* ``fastpath_eligible`` decides whether per-run partials add up without
  the visibility merge: every run 'opd', disjoint key spans, unique keys
  per run, no visible memtable rows, no stored seqno above the snapshot.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.opd import OPD
from repro_torch.core.sct import SCT
from repro_torch.query.spec import (AggSpec, GroupBy, numeric_values,
                                    prefix_labels)


# --------------------------------------------------------------------------- #
# per-SCT facts, derived once (SCTs are immutable after build)
# --------------------------------------------------------------------------- #
def _fact(s: SCT, name: str, make):
    if name not in s.facts:
        s.facts[name] = make()
    return s.facts[name]


def run_has_tombs(s: SCT) -> bool:
    return _fact(s, "has_tombs", lambda: bool(s.tombs.any()))


def run_keys_unique(s: SCT) -> bool:
    return _fact(s, "keys_unique",
                 lambda: bool(np.all(s.keys[1:] != s.keys[:-1])))


def run_weight_table(s: SCT) -> torch.Tensor:
    """int32 numeric weight per dictionary code on the SCT's device (SUM's
    gather table), computed once per dictionary, never per row;
    ``build_sct`` leaves the table it folded into the block weight sums."""
    return _fact(s, "weight_table", lambda: numeric_values(
        s.opd.values, s.packed.device).to(torch.int32))


def run_weights(s: SCT) -> np.ndarray:
    """``run_weight_table`` as int64 on the host."""
    return _fact(s, "weights", lambda: run_weight_table(s).cpu().numpy()
                 .astype(np.int64))


def run_weight_max(s: SCT) -> int:
    """max |weight| over the dictionary (the int32 routing guard's input)."""
    return _fact(s, "weight_max",
                 lambda: int(np.abs(run_weights(s)).max(initial=0)))


def run_prefix_table(s: SCT, prefix_len: int) -> np.ndarray:
    """S<prefix_len> label per dictionary code."""
    return _fact(s, f"prefix_{prefix_len}",
                 lambda: prefix_labels(s.opd.values, prefix_len))


# --------------------------------------------------------------------------- #
# bucket-edge resolution
# --------------------------------------------------------------------------- #
def source_domain(s: SCT) -> np.ndarray:
    """Sorted unique live values of one run: an 'opd' run's dictionary is
    that set; a competitor run decodes its values (``SCT.raw_values``)."""
    if s.codec == "opd":
        return s.opd.values
    return np.unique(s.raw_values()[~s.tombs])


def collect_domain(runs: Sequence[SCT], mems,
                   value_width: int) -> np.ndarray:
    """Observed value domain of a snapshot: every run's ``source_domain``
    and the memtables' newest live rows."""
    parts = [source_domain(s) for s in runs if s.n > 0]
    for m in mems or []:
        if m.n_versions:
            _k, _sq, t, v = m.newest_rows(None)
            if v.shape[0]:
                parts.append(np.unique(v[~t]))
    if not parts:
        return np.zeros(0, f"S{value_width}")
    return np.unique(np.concatenate(parts))


def bucket_edges_from_domain(domain: np.ndarray,
                             n_buckets: int) -> Tuple[bytes, ...]:
    """Equi-depth interior edges: n_buckets-1 cuts of the sorted unique
    domain; duplicate cuts are dropped (fewer, still exact buckets)."""
    d = domain.shape[0]
    if d == 0 or n_buckets <= 1:
        return ()
    idx = np.unique((np.arange(1, n_buckets) * d) // n_buckets)
    idx = idx[(idx > 0) & (idx < d)]
    return tuple(bytes(v) for v in np.unique(domain[idx]))


def resolve_specs(specs: Sequence[AggSpec],
                  domain: np.ndarray) -> List[AggSpec]:
    """Pin every unresolved 'bucket' GroupBy to concrete edges."""
    out = []
    for spec in specs:
        g = spec.group
        if g is not None and not g.resolved():
            g = GroupBy(g.kind, g.prefix_len, g.n_buckets,
                        bucket_edges_from_domain(domain, g.n_buckets))
            spec = AggSpec(spec.op, spec.pred, g, spec.top_k)
        out.append(spec)
    return out


# --------------------------------------------------------------------------- #
# code-space planning against one dictionary
# --------------------------------------------------------------------------- #
def plan_ranges(s: SCT, specs: Sequence[AggSpec]) -> np.ndarray:
    """int64 [K, 2] inclusive planned code ranges (lo > hi = empty), the
    encoding the kernels take."""
    rr = [s.opd.code_range(spec.plan_pred()) for spec in specs]
    return np.asarray([(lo, hi - 1) if lo < hi else (1, 0) for lo, hi in rr],
                      np.int64).reshape(-1, 2)


def group_code_edges(
    s: SCT, group: GroupBy, lo: int, hi: int,
) -> Tuple[np.ndarray, List[bytes]]:
    """B+1 ascending int64 code edges and B labels for one dictionary,
    clipped to the planned half-open code window [lo, hi): bins outside the
    window collapse to empty, codes outside it fall below edge 0 or at or
    above the last edge, so the histogram is the filtered group count."""
    opd: OPD = s.opd
    D = opd.size
    if group.kind == "prefix":
        labels_all = run_prefix_table(s, group.prefix_len)
        starts = np.concatenate(
            [[0], np.nonzero(labels_all[1:] != labels_all[:-1])[0] + 1]) \
            if D else np.zeros(0, np.int64)
        edges = np.concatenate([starts, [D]]).astype(np.int64)
        labels = [bytes(v) for v in labels_all[starts.astype(np.int64)]]
    else:
        w = opd.values.dtype.itemsize
        interior = np.asarray(list(group.edges or ()), f"S{w}")
        cuts = np.searchsorted(opd.values, interior, side="left")
        edges = np.concatenate([[0], cuts, [D]]).astype(np.int64)
        labels = [group.bucket_label(b) for b in range(len(edges) - 1)]
    return np.clip(edges, lo, hi), labels


# --------------------------------------------------------------------------- #
# fast-path eligibility
# --------------------------------------------------------------------------- #
def fastpath_eligible(live_runs: Sequence[SCT], mem_newest,
                      snap) -> Tuple[bool, str]:
    """Can per-run partials be summed without the visibility merge?"""
    if mem_newest is not None:
        return False, "memtable"
    for s in live_runs:
        if s.codec != "opd":
            return False, f"codec:{s.codec}"
        if snap is not None and np.uint64(s.max_seqno) > snap:
            return False, "seqno"
        if not run_keys_unique(s):
            return False, "dup_keys"
    spans = sorted((s.min_key, s.max_key) for s in live_runs)
    for (_, pmax), (nmin, _) in zip(spans, spans[1:]):
        if pmax >= nmin:
            return False, "overlap"
    return True, "ok"
