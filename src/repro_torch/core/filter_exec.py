"""Scan-based value filtering (paper §4.2.2) on the card.

Port of ``repro/core/filter_exec.py`` for every codec and the reference's
four backends.  On 'opd' runs K predicates are planned per SCT dictionary
on the host (two binary searches each) and evaluated:

* ``'fused'``: every SCT of a level in ONE zone-gated
  ``fused_level_filter`` launch on the packed words;
* ``'jax_packed'`` (the serving path): one ``multi_range_filter_packed``
  launch per SCT over its packed words, all K ranges in one pass;
* ``'jax'``: one ``range_filter_codes`` launch per (SCT, non-empty
  predicate) over a transient unpacked code column;
* ``'numpy'`` (the reference's default): on the host, no kernel.  Each
  SCT's packed words come to the host once per call, are unpacked by the
  plain unpack (-1 at tombstones), and the K ranges are compared as one
  (K, n) numpy broadcast.

On the card backends the K masks of an SCT stay on the card, tombstones
are masked there, and only the matching positions and their codes (read
straight from the packed words) come back to the host.  There the
dictionary decodes them and the cross-level seqno merge discards stale
versions.  The backends give the same results bit for bit.

Competitor runs pay what the paper says they pay, on the host under every
backend: stage ``decode`` decompresses every block of each 'heavy' run
and reads every value of each 'blob' run from its logs once per call
(``SCT.raw_values``), and each predicate compares the raw
S<w> strings of every entry (``string_mask``).  They launch nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.memtable import MemTable, MemTables, as_mems
from repro_torch.core.opd import Predicate
from repro_torch.core.sct import SCT
from repro_torch.core.stats import StageStats
from repro_torch.kernels import ops
from repro_torch.storage.io import FileStore


def string_mask(values: np.ndarray, pred: Predicate) -> np.ndarray:
    """Vectorized predicate over raw fixed-width strings (the memtable's
    rows); plans exactly like ``OPD.code_range``, including operands longer
    than the value width."""
    w = values.dtype.itemsize
    if pred.kind == "eq":
        if len(pred.a) > w:
            return np.zeros(values.shape[0], np.bool_)
        return values == np.asarray([pred.a], f"S{w}")[0]
    if pred.kind == "prefix":
        if len(pred.a) > w:
            return np.zeros(values.shape[0], np.bool_)
        lo = np.asarray([pred.a], f"S{w}")[0]
        hi = np.asarray([pred.a + b"\xff" * (w - len(pred.a))], f"S{w}")[0]
        return (values >= lo) & (values <= hi)
    if pred.kind == "range":
        return _lower_mask(values, pred.a) & \
            (values <= np.asarray([pred.b], f"S{w}")[0])
    if pred.kind == "ge":
        return _lower_mask(values, pred.a)
    if pred.kind == "le":
        return values <= np.asarray([pred.b], f"S{w}")[0]
    raise ValueError(pred.kind)


def _lower_mask(values: np.ndarray, a: bytes) -> np.ndarray:
    """``value >= a`` (an over-long bound excludes its truncation)."""
    w = values.dtype.itemsize
    bound = np.asarray([a], f"S{w}")[0]
    return values > bound if len(a) > w else values >= bound


@dataclasses.dataclass
class FilterResult:
    keys: np.ndarray     # uint64 [k]
    values: np.ndarray   # S<w>  [k]
    n_scanned: int
    n_matched_raw: int   # before stale-version discard


def evaluate_filter(runs: List[SCT], memtable: MemTables, pred: Predicate,
                    *, stats: StageStats, store: FileStore,
                    snapshot_seqno: Optional[int] = None,
                    backend: str = "fused",
                    value_width: Optional[int] = None) -> FilterResult:
    """Single-predicate filter: the K=1 case of ``evaluate_filter_many``."""
    return evaluate_filter_many(
        runs, memtable, [pred], stats=stats, store=store,
        snapshot_seqno=snapshot_seqno, backend=backend,
        value_width=value_width)[0]


def evaluate_filter_many(
    runs: List[SCT], memtable: MemTables, preds: Sequence[Predicate],
    *, stats: StageStats, store: FileStore,
    snapshot_seqno: Optional[int] = None,
    backend: str = "fused",  # 'fused' | 'jax_packed' | 'jax' | 'numpy'
    value_width: Optional[int] = None,
) -> List[FilterResult]:
    """Evaluate K predicates with one pass over every run's codes: one
    launch per level ('fused'), per run ('jax_packed') or per (run,
    predicate) ('jax'), or none ('numpy', on the host).

    Returns one ``FilterResult`` per predicate, bit-identical to K
    independent ``evaluate_filter`` calls.  ``value_width`` pins the dtype
    of empty results."""
    preds = list(preds)
    n_preds = len(preds)
    if n_preds == 0:
        return []
    mems = as_mems(memtable)
    snap = np.uint64(snapshot_seqno) if snapshot_seqno is not None else None

    with stats.time("retrieval"):
        live_runs = [s for s in runs if s.n > 0]

    with stats.time("read"):
        for s in live_runs:
            store.stats.add_read(s.disk_bytes, 1)

    # the competitors' raw value columns, once per call
    with stats.time("decode"):
        decoded = {i: s.raw_values() for i, s in enumerate(live_runs)
                   if s.codec != "opd"}

    cand_keys = [[] for _ in range(n_preds)]
    cand_seqs = [[] for _ in range(n_preds)]
    cand_vals = [[] for _ in range(n_preds)]
    n_scanned = 0
    with stats.time("filter"):
        hits = _run_hits(live_runs, preds, backend, stats, snap, decoded)
        for i, s in enumerate(live_runs):
            n_scanned += s.n
            if i not in hits:
                continue
            q, idx, col = hits[i]
            # O(1) decode: the code is the offset into the dictionary
            vals = s.opd.decode(col) if i not in decoded else col
            bounds = np.searchsorted(q, np.arange(n_preds + 1))
            for k in range(n_preds):
                sel = slice(bounds[k], bounds[k + 1])
                if bounds[k] == bounds[k + 1]:
                    continue
                cand_keys[k].append(s.keys[idx[sel]])
                cand_seqs[k].append(s.seqnos[idx[sel]])
                cand_vals[k].append(vals[sel])
        # memtable stack (newest data): small row-oriented scans
        mk, ms, mv = _memtable_visible(mems, snap, value_width)
        if mk.shape[0]:
            for k, p in enumerate(preds):
                m = string_mask(mv, p)
                if m.any():
                    cand_keys[k].append(mk[m])
                    cand_seqs[k].append(ms[m])
                    cand_vals[k].append(mv[m])

    results = []
    with stats.time("merge"):
        mem_newest = _memtable_newest(mems, snap)
        for k in range(n_preds):
            results.append(_merge_candidates(
                cand_keys[k], cand_seqs[k], cand_vals[k],
                live_runs, mem_newest, snap, n_scanned, value_width))
    return results


def _run_hits(live_runs: List[SCT], preds: Sequence[Predicate],
              backend: str, stats: StageStats, snap,
              decoded: Optional[Dict[int, np.ndarray]] = None
              ) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """{run index -> (q, idx, codes)}: the (predicate, entry) pairs of the
    run's live entries that match and are visible at ``snap``, with the
    entries' codes ('opd') or raw values (the competitor runs, whose value
    columns ``decoded`` holds by run index), as host arrays ordered by
    predicate, then entry.  An 'opd' run where no predicate can match is
    left out."""
    out = {}
    run_masks = _run_masks(live_runs, preds, backend, stats, decoded or {})
    for i in sorted(run_masks):
        s, masks = live_runs[i], run_masks[i]
        if isinstance(masks, tuple):    # host masks and column
            masks, col = masks
            q, idx = np.nonzero(masks)
            codes = col[idx]
        else:
            q_idx = torch.nonzero(masks & s.live)   # [nnz, 2] (q, entry)
            codes = s.codes_at(q_idx[:, 1])
            q_idx, codes = q_idx.cpu().numpy(), codes.cpu().numpy()
            q, idx = q_idx[:, 0], q_idx[:, 1]
        if snap is not None and np.uint64(s.max_seqno) > snap:
            vis = s.seqnos[idx] <= snap
            q, idx, codes = q[vis], idx[vis], codes[vis]
        out[i] = (q, idx, codes)
    return out


def _run_masks(live_runs: List[SCT], preds: Sequence[Predicate],
               backend: str, stats: StageStats,
               decoded: Dict[int, np.ndarray]) -> dict:
    """{run index -> masks}: 'opd' runs under ``backend``, where a run no
    predicate can match is left out (no launch).  On the card backends the
    masks are bool [K, n] on the card, where tombstones may still be set
    (callers AND with ``SCT.live``); under 'numpy' they are a host pair
    (bool [K, n] without tombstones, the int32 code column).  A competitor
    run's masks are the same host pair over its raw values ``decoded[i]``
    under every backend: the strings compared, tombstones masked."""
    opd_runs = [i for i in range(len(live_runs)) if i not in decoded]
    if backend == "fused":
        out = _fused_level_masks(live_runs, opd_runs, preds, stats)
    else:
        out = {}
        for i in opd_runs:
            s = live_runs[i]
            masks = _code_masks_many(
                s, [s.opd.code_range(p) for p in preds], backend)
            if masks is not None:
                out[i] = masks
    for i, vals in decoded.items():
        live = ~live_runs[i].tombs
        out[i] = (np.stack([string_mask(vals, p) & live for p in preds]),
                  vals)
    return out


def _code_masks_many(s: SCT, ranges: Sequence[Tuple[int, int]],
                     backend: str):
    """K bool masks [K, n] over one SCT's codes from planned [lo, hi)
    ranges, or None when every range is empty (no launch).

    'numpy' brings the packed words to the host, unpacks them there (-1 at
    tombstones, which no planned range holds) and compares the K ranges as
    one (K, n) broadcast; it returns (masks, column) on the host.  'jax'
    unpacks the code column on the card and launches
    ``range_filter_codes`` once per non-empty range; 'jax_packed' hands
    the (K, 2) table to ``multi_range_filter_packed`` so each packed word is
    read and field-extracted once for all K ranges (tombstones pack as
    code 0 and stay in its masks)."""
    if all(lo >= hi for lo, hi in ranges):
        return None
    if backend == "numpy":
        col = s.host_codes()
        lo, hi = np.asarray(ranges, np.int64).reshape(-1, 2).T
        return (col >= lo[:, None]) & (col < hi[:, None]), col
    dev = s.packed.device
    if backend == "jax":
        # unpacked once per run; each launch reads its partial last tile in
        # place
        col = s.code_column()
        masks = torch.zeros((len(ranges), s.n), dtype=torch.bool, device=dev)
        for q, (lo, hi) in enumerate(ranges):
            if lo < hi:
                masks[q] = ops.range_filter_codes(col, lo, hi - 1)
        return masks
    if backend == "jax_packed":
        # inclusive [lo, hi-1]; lo > hi encodes the empty range in-kernel
        tbl = torch.tensor([(lo, hi - 1) if lo < hi else (1, 0)
                            for lo, hi in ranges], dtype=torch.int64,
                           device=dev)
        bitmaps = ops.multi_range_filter_packed(s.packed, s.code_bits, tbl)
        return ops.bitmap_to_mask(bitmaps, s.code_bits, s.n)
    raise ValueError(f"filter backend {backend!r}")


def _fused_level_masks(live_runs: List[SCT], opd_runs: Sequence[int],
                       preds: Sequence[Predicate], stats: StageStats) -> dict:
    """Plan + evaluate the 'opd' runs ``live_runs[i]``, i in ``opd_runs``,
    through ``fused_level_filter``, ONE launch per (level, pack width)
    group; each run contributes its own K planned ranges.  Tile/block skip
    telemetry lands in ``stats.counts`` (``fused_launches``,
    ``zone_tiles_*``, ``zone_blocks_*``).

    Returns {run index -> bool masks [K, n] on the card}; runs of a level
    where no predicate can match are left out (no launch)."""
    groups: dict = {}
    for i in opd_runs:
        s = live_runs[i]
        groups.setdefault((s.level, s.code_bits), []).append(i)
    out: dict = {}
    for (_level, width), idxs in sorted(groups.items()):
        ranges_list = []
        for i in idxs:
            rr = [live_runs[i].opd.code_range(p) for p in preds]
            # inclusive [lo, hi-1]; lo > hi encodes empty in-kernel
            ranges_list.append(np.asarray(
                [(lo, hi - 1) if lo < hi else (1, 0) for lo, hi in rr],
                np.int64))
        if all((r[:, 0] > r[:, 1]).all() for r in ranges_list):
            continue  # no predicate can match anywhere in this level
        dev = live_runs[idxs[0]].packed.device
        zones = [(s.blocks.code_lo, s.blocks.code_hi,
                  s.blocks.entries_per_block) if s.blocks.has_zones else None
                 for s in (live_runs[i] for i in idxs)]
        bitmaps, info = ops.fused_level_filter(
            [live_runs[i].packed for i in idxs],
            [live_runs[i].n for i in idxs],
            [torch.from_numpy(r).to(dev) for r in ranges_list], zones, width)
        stats.counts["fused_launches"] += 1
        for k in ("tiles_total", "tiles_skipped", "blocks_total",
                  "blocks_skipped", "blocks_prunable"):
            stats.counts[f"zone_{k}"] += info[k]
        for j, i in enumerate(idxs):
            out[i] = ops.bitmap_to_mask(bitmaps[j], width, live_runs[i].n)
    return out


def _merge_candidates(
    cand_keys: List[np.ndarray], cand_seqs: List[np.ndarray],
    cand_vals: List[np.ndarray], live_runs: List[SCT],
    mem_newest: Optional[Tuple[np.ndarray, np.ndarray]], snap,
    n_scanned: int, value_width: Optional[int] = None,
) -> FilterResult:
    """Cross-level merge for one predicate's candidates (paper step 4)."""
    if not cand_keys:
        w = value_width if value_width is not None else (
            live_runs[0].value_width if live_runs else 8)
        return FilterResult(np.zeros(0, np.uint64), np.zeros(0, f"S{w}"),
                            n_scanned, 0)
    keys = np.concatenate(cand_keys)
    seqs = np.concatenate(cand_seqs)
    vals = np.concatenate(cand_vals)
    n_raw = int(keys.shape[0])
    order = np.lexsort((np.uint64(0xFFFFFFFFFFFFFFFF) - seqs, keys))
    keys, seqs, vals = keys[order], seqs[order], vals[order]
    first = np.ones(keys.shape[0], np.bool_)
    first[1:] = keys[1:] != keys[:-1]
    keys, seqs, vals = keys[first], seqs[first], vals[first]
    # a candidate survives only as the globally newest visible version of
    # its key (a newer non-matching version or tombstone shadows it)
    newest = _global_newest(keys, live_runs, mem_newest, snap)
    ok = seqs == newest
    return FilterResult(keys[ok], vals[ok], n_scanned, n_raw)


def _memtable_visible(mems: List[MemTable], snap,
                      value_width: Optional[int] = None) -> Tuple:
    """Newest visible live (key, seqno, value) triples across the memtable
    stack; rows a newer memtable shadows are dropped by the seqno merge."""
    parts = [m.newest_rows(None if snap is None else int(snap))
             for m in mems if m.n_versions]
    parts = [(k[~t], s[~t], v[~t]) for k, s, t, v in parts]
    parts = [p for p in parts if p[0].shape[0]]
    w = value_width if value_width is not None else (
        mems[0].value_width if mems else 8)
    if not parts:
        return (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
                np.zeros(0, f"S{w}"))
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))


def _memtable_newest(mems: List[MemTable], snap
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Newest visible seqno per key across the memtable stack, tombstones
    included, as key-sorted arrays."""
    max_seq = None if snap is None else int(snap)
    parts = [m.newest_rows(max_seq)[:2] for m in mems if m.n_versions]
    parts = [p for p in parts if p[0].shape[0]]
    if not parts:
        return None
    mk = np.concatenate([p[0] for p in parts])
    ms = np.concatenate([p[1] for p in parts])
    order = np.lexsort((ms, mk))
    mk, ms = mk[order], ms[order]
    last = np.ones(mk.shape[0], np.bool_)
    last[:-1] = mk[1:] != mk[:-1]
    return mk[last], ms[last]


def _global_newest(cand_keys: np.ndarray, runs: List[SCT],
                   mem_newest: Optional[Tuple[np.ndarray, np.ndarray]], snap
                   ) -> np.ndarray:
    """Newest visible seqno per candidate key across all runs + memtable
    (one vectorized searchsorted per run; the per-candidate walk is only
    needed for runs holding seqnos above the snapshot)."""
    newest = np.zeros(cand_keys.shape[0], np.uint64)
    for s in runs:
        pos = np.searchsorted(s.keys, cand_keys, side="left")
        hit = (pos < s.n) & (s.keys[np.minimum(pos, s.n - 1)] == cand_keys)
        if snap is None or np.uint64(s.max_seqno) <= snap:
            seq = np.where(hit, s.seqnos[np.minimum(pos, s.n - 1)], 0)
        else:
            seq = np.zeros(cand_keys.shape[0], np.uint64)
            for j in np.nonzero(hit)[0]:
                p = pos[j]
                while p < s.n and s.keys[p] == cand_keys[j] and s.seqnos[p] > snap:
                    p += 1
                if p < s.n and s.keys[p] == cand_keys[j]:
                    seq[j] = s.seqnos[p]
        newest = np.maximum(newest, seq)
    if mem_newest is not None:
        mk, ms = mem_newest
        pos = np.minimum(np.searchsorted(mk, cand_keys), mk.shape[0] - 1)
        hit = mk[pos] == cand_keys
        newest = np.maximum(newest, np.where(hit, ms[pos], 0))
    return newest
