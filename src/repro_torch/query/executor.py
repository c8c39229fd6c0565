"""Aggregate execution on packed codes, with an MVCC fallback.

Port of ``repro/query/executor.py`` for every codec and the 'fused',
'jax_packed', 'jax' and 'numpy' backends.  Two paths, chosen per snapshot by
``planner.fastpath_eligible``:

**Fast path** (disjoint key spans, unique keys per run, nothing visible in
the memtable, the snapshot covers every stored seqno: a compacted,
quiescent tree).  Every stored row is the newest visible version of its
key, so per-run partials add up.  On the kernel backends ('fused',
'jax_packed') scalar specs take ONE ``ops.fused_level_agg`` launch per
(level, pack width) group and each GROUP BY one ``ops.level_histogram``
launch; tiles whose zone a range contains contribute closed forms without
their words being read.  A run whose tombstones (packed as code 0) a
planned range could see, or whose SUM could overflow the reference
kernel's int32 tile accumulator (the routing guard, kept so the counters
match the reference), goes to the host evaluation at 4 KB-block
granularity instead, as every run does under 'jax' and 'numpy'.

**General path** (overlapping runs, visible memtable rows, snapshots older
than stored seqnos, competitor runs): ``filter_exec``'s masks under the
tree's filter backend, dedup and global shadow check, with candidates of
'opd' runs carrying ``(run, code)`` instead of decoded values; memtable
rows and competitor runs, each decoded once a call in stage ``decode``
(``SCT.raw_values``), carry raw values in a per-spec pool.

MIN and MAX stay codes until one dictionary decode per run; runs merge in
value space.  SUM gathers ``numeric_values`` weights per code.  GROUP BY
folds a per-code histogram through the dictionary's prefix-label table or
the resolved bucket edges.

``stats.counts`` keys, as the reference's: ``agg_specs``,
``agg_rows_scanned``, ``agg_fastpath_runs`` / ``agg_fallback_runs``,
``agg_launches``, ``agg_tiles_{total,skipped,evaluated,shortcircuit}``
(kernel tiles; (block x spec) on the host fast path),
``agg_histograms_gathered``, ``agg_codes_decoded``; the general path adds
the fused filter's ``fused_launches`` and ``zone_*``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.filter_exec import (_global_newest, _memtable_newest,
                                          _memtable_visible, _run_hits,
                                          string_mask)
from repro_torch.core.memtable import MemTables, as_mems
from repro_torch.core.sct import SCT
from repro_torch.core.stats import StageStats
from repro_torch.kernels import ops
from repro_torch.kernels.agg_scan import MAX_BINS
from repro_torch.kernels.fused_scan import DEFAULT_TILE_WORDS
from repro_torch.query import planner
from repro_torch.query.spec import (INT32_MAX, AggPartial, AggSpec,
                                    bucket_ids, numeric_values,
                                    prefix_labels)
from repro_torch.storage.io import FileStore

_AGG_INFO = ("tiles_total", "tiles_skipped", "tiles_evaluated",
             "tiles_shortcircuit")


def evaluate_aggregates(
    runs: List[SCT],
    memtable: MemTables,
    specs: Sequence[AggSpec],
    *,
    stats: StageStats,
    store: FileStore,
    snapshot_seqno: Optional[int] = None,
    backend: str = "fused",  # 'fused' | 'jax_packed' | 'jax' | 'numpy'
    value_width: Optional[int] = None,
) -> List[AggPartial]:
    """Evaluate K aggregate specs against one snapshot's runs + memtables.

    Returns one mergeable ``AggPartial`` per spec (the caller finalizes).
    'bucket' groups must arrive resolved (``planner.resolve_specs``)."""
    specs = list(specs)
    if not specs:
        return []
    for spec in specs:
        if spec.group is not None and not spec.group.resolved():
            raise ValueError("bucket GroupBy must be resolved before "
                             "execution (planner.resolve_specs)")
    mems = as_mems(memtable)
    snap = np.uint64(snapshot_seqno) if snapshot_seqno is not None else None
    stats.counts["agg_specs"] += len(specs)

    with stats.time("plan"):
        live_runs = [s for s in runs if s.n > 0]
        mem_newest = _memtable_newest(mems, snap)
        fast, _why = planner.fastpath_eligible(live_runs, mem_newest, snap)

    with stats.time("read"):
        for s in live_runs:
            store.stats.add_read(s.disk_bytes, 1)
            stats.counts["agg_rows_scanned"] += s.n

    if fast:
        stats.counts["agg_fastpath_runs"] += len(live_runs)
        with stats.time("aggregate"):
            return _fastpath_aggregate(live_runs, specs, stats, backend)
    stats.counts["agg_fallback_runs"] += len(live_runs)
    return _general_aggregate(live_runs, mems, mem_newest, specs, stats,
                              snap, backend, value_width)


def _zones_of(s: SCT):
    """(code_lo, code_hi, entries_per_block, weight_sums) on the device."""
    b = s.blocks
    return (b.code_lo, b.code_hi, b.entries_per_block, b.weight_sums)


def _decode_one(s: SCT, code: int, stats) -> bytes:
    stats.counts["agg_codes_decoded"] += 1
    return bytes(s.opd.values[int(code)])


# =========================================================================== #
# fast path: per-run partials in the code domain, no visibility merge
# =========================================================================== #
def _fastpath_aggregate(live_runs, specs, stats, backend):
    K = len(specs)
    partials = [AggPartial() for _ in range(K)]
    scalar_q = [q for q in range(K) if specs[q].op != "group_count"]
    group_q = [q for q in range(K) if specs[q].op == "group_count"]
    use_kernel = backend in ("fused", "jax_packed")

    # half-open planned window per (run, spec)
    windows = [[s.opd.code_range(spec.plan_pred()) for spec in specs]
               for s in live_runs]

    if scalar_q:
        with_sum = any(specs[q].op == "sum" for q in scalar_q)
        kernel_runs, host_runs = [], []
        for i, s in enumerate(live_runs):
            ok = use_kernel
            if ok and planner.run_has_tombs(s):
                # tombstones pack as 0: the kernel may only see this run
                # if every non-empty planned range excludes code 0
                ok = all(lo >= 1 or lo >= hi
                         for q in scalar_q for lo, hi in [windows[i][q]])
            if ok and with_sum:
                # the reference kernel's int32 per-tile accumulator guard
                tile_entries = DEFAULT_TILE_WORDS * (32 // s.code_bits)
                ok = planner.run_weight_max(s) * tile_entries < INT32_MAX
            (kernel_runs if ok else host_runs).append(i)
        if kernel_runs:
            _kernel_scalars(live_runs, kernel_runs, specs, scalar_q,
                            with_sum, partials, stats)
        for i in host_runs:
            _host_scalars(live_runs[i], windows[i], specs, scalar_q,
                          partials, stats)

    for q in group_q:
        _fastpath_group(live_runs, windows, specs[q], q, partials, stats,
                        use_kernel)
    return partials


def _fold_scalar(partials, specs, scalar_q, s, counts, min_codes, max_codes,
                 sums, stats):
    """Fold one run's per-spec code-domain partials into the value-domain
    AggPartials (the <= 2 decodes per run happen here)."""
    for k, q in enumerate(scalar_q):
        c = int(counts[k])
        if c == 0:
            continue
        p = partials[q]
        p.count += c
        op = specs[q].op
        if op == "sum":
            p.total += int(sums[k])
        if op in ("min", "max") and min_codes[k] >= 0:
            mn = _decode_one(s, min_codes[k], stats)
            mx = _decode_one(s, max_codes[k], stats)
            if p.min_value is None or mn < p.min_value:
                p.min_value = mn
            if p.max_value is None or mx > p.max_value:
                p.max_value = mx


def _level_groups(live_runs, idxs) -> List[Tuple[int, List[int]]]:
    """Run indices grouped by (level, pack width), in the reference's
    launch order; returns [(width, members)]."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i in idxs:
        s = live_runs[i]
        groups.setdefault((s.level, s.code_bits), []).append(i)
    return [(width, members)
            for (_level, width), members in sorted(groups.items())]


def _count_launch(stats, info) -> None:
    stats.counts["agg_launches"] += 1
    for key in _AGG_INFO:
        stats.counts[f"agg_{key}"] += info[key]


def _kernel_scalars(live_runs, idxs, specs, scalar_q, with_sum, partials,
                    stats):
    """Scalar specs through ``fused_level_agg``, one launch per (level,
    pack width) group, as ``_fused_level_masks`` groups the filter."""
    scalar_specs = [specs[q] for q in scalar_q]
    for width, members in _level_groups(live_runs, idxs):
        ranges_list = [planner.plan_ranges(live_runs[i], scalar_specs)
                       for i in members]
        weights_list = ([planner.run_weight_table(live_runs[i])
                         for i in members] if with_sum else None)
        per_sct, info = ops.fused_level_agg(
            [live_runs[i].packed for i in members],
            [live_runs[i].n for i in members],
            ranges_list, [_zones_of(live_runs[i]) for i in members],
            width, weights_list=weights_list)
        _count_launch(stats, info)
        for j, i in enumerate(members):
            r = per_sct[j]
            _fold_scalar(partials, specs, scalar_q, live_runs[i],
                         r["counts"], r["min_code"], r["max_code"],
                         r["sums"], stats)


def _host_scalars(s, windows, specs, scalar_q, partials, stats):
    """Host fast path: the kernel's zone short-circuit at 4 KB-block
    granularity (block zones are exact per block, so closed-form min/max
    are attained), evaluating only the zone-crossing blocks' codes.  Every
    SCT of the port carries block zones and weight sums."""
    K = len(scalar_q)
    counts = np.zeros(K, np.int64)
    sums = np.zeros(K, np.int64)
    min_codes = np.full(K, -1, np.int64)
    max_codes = np.full(K, -1, np.int64)
    code_lo, code_hi, epb, wsums = _zones_of(s)
    dev = code_lo.device
    nb = code_lo.shape[0]
    starts = torch.arange(nb, dtype=torch.int64, device=dev) * epb
    sizes = torch.clamp(starts + epb, max=s.n) - starts
    blk = torch.arange(s.n, device=dev) // epb
    evs = None
    for k, q in enumerate(scalar_q):
        lo, hi = windows[q]
        if lo >= hi:
            continue
        lo_i, hi_i = lo, hi - 1  # inclusive
        need_sum = specs[q].op == "sum"
        inter = (code_lo <= hi_i) & (code_hi >= lo_i)
        closed = inter & (lo_i <= code_lo) & (code_hi <= hi_i) & (code_lo >= 1)
        evaluate = inter & ~closed
        if bool(evaluate.any()):
            evs = (s.code_column().to(torch.int64) if evs is None
                   else evs)
            m = evaluate[blk] & (evs >= lo_i) & (evs <= hi_i)
            col = evs
        else:
            m = torch.zeros(s.n, dtype=torch.bool, device=dev)
            col = m.to(torch.int64)
        e_w = (planner.run_weight_table(s).to(torch.int64)[col.clamp(min=0)]
               if need_sum else col)
        big = 2**40
        (n_skip, n_closed, n_eval, c_count, c_min, c_max, c_sum,
         e_count, e_min, e_max, e_sum) = torch.stack([
             (~inter).sum(), closed.sum(), evaluate.sum(),
             sizes[closed].sum(), torch.where(closed, code_lo, big).min(),
             torch.where(closed, code_hi, -1).max(),
             torch.where(closed, wsums, 0).sum(),
             m.sum(), torch.where(m, col, big).min(),
             torch.where(m, col, -1).max(),
             torch.where(m, e_w, 0).sum()]).tolist()   # one transfer
        stats.counts["agg_tiles_total"] += nb
        stats.counts["agg_tiles_skipped"] += n_skip
        stats.counts["agg_tiles_shortcircuit"] += n_closed
        stats.counts["agg_tiles_evaluated"] += n_eval
        if n_closed:
            counts[k] += c_count
            min_codes[k] = c_min
            max_codes[k] = c_max
            if need_sum:
                # containment makes every live entry a match and
                # code_lo >= 1 rules out tombstones: the block weight
                # totals are the blocks' exact SUM contribution
                sums[k] += c_sum
        if e_count:
            counts[k] += e_count
            min_codes[k] = e_min if min_codes[k] < 0 else min(min_codes[k],
                                                               e_min)
            max_codes[k] = max(max_codes[k], e_max)
            if need_sum:
                sums[k] += e_sum
    _fold_scalar(partials, specs, scalar_q, s, counts, min_codes, max_codes,
                 sums, stats)


def _fastpath_group(live_runs, windows, spec, q, partials, stats,
                    use_kernel):
    """GROUP BY on the fast path: per-run code histogram folded through
    the dictionary's label table or the resolved bucket edges."""
    partials[q].groups = {}
    plans = []  # (i, edges int64 [B+1], labels)
    for i, s in enumerate(live_runs):
        lo, hi = windows[i][q]
        if lo >= hi:
            continue
        edges, labels = planner.group_code_edges(s, spec.group, lo, hi)
        plans.append((i, edges, labels))
    kernel_ok = use_kernel and plans and \
        max(len(e) - 1 for _, e, _ in plans) <= MAX_BINS and \
        all(not planner.run_has_tombs(live_runs[i]) or e[0] >= 1
            for i, e, _ in plans)
    if kernel_ok:
        by_run = {i: (e, lab) for i, e, lab in plans}
        for width, members in _level_groups(live_runs, by_run):
            hists, info = ops.level_histogram(
                [live_runs[i].packed for i in members],
                [live_runs[i].n for i in members],
                [by_run[i][0] for i in members],
                [_zones_of(live_runs[i]) for i in members],
                width)
            _count_launch(stats, info)
            for j, i in enumerate(members):
                stats.counts["agg_histograms_gathered"] += 1
                _fold_hist(partials[q], hists[j], by_run[i][1])
        return
    for i, edges, labels in plans:
        s = live_runs[i]
        evs = s.code_column().to(torch.int64)
        cnt = torch.bincount(evs[evs >= 0], minlength=s.opd.size)
        cum = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)]).cpu().numpy()
        hist = cum[edges[1:]] - cum[edges[:-1]]
        stats.counts["agg_histograms_gathered"] += 1
        stats.counts["agg_tiles_total"] += 1
        stats.counts["agg_tiles_evaluated"] += 1
        _fold_hist(partials[q], hist, labels)


def _fold_hist(partial, hist, labels):
    got = np.nonzero(np.asarray(hist) > 0)[0]
    partial.add_group_counts([labels[b] for b in got],
                             [int(hist[b]) for b in got])


# =========================================================================== #
# general path: filter_exec's candidate/visibility machinery, codes carried
# =========================================================================== #
def _general_aggregate(live_runs, mems, mem_newest, specs, stats, snap,
                       backend, value_width):
    K = len(specs)
    preds = [spec.plan_pred() for spec in specs]

    # the competitors' raw value columns, once per call
    with stats.time("decode"):
        decoded = {i: s.raw_values() for i, s in enumerate(live_runs)
                   if s.codec != "opd"}

    # per-spec candidate columns; srcs >= 0 index live_runs and pair with
    # CODES, srcs == -1 pairs with an index into the spec's `others` pool
    cand = [{"keys": [], "seqs": [], "srcs": [], "codes": []}
            for _ in range(K)]
    others: List[List[np.ndarray]] = [[] for _ in range(K)]
    other_n = [0] * K

    def _push(q, keys, seqs, src, codes=None, vals=None):
        cand[q]["keys"].append(keys)
        cand[q]["seqs"].append(seqs)
        if src >= 0:
            cand[q]["srcs"].append(np.full(keys.shape[0], src, np.int64))
            cand[q]["codes"].append(codes.astype(np.int64))
        else:
            cand[q]["srcs"].append(np.full(keys.shape[0], -1, np.int64))
            cand[q]["codes"].append(np.arange(
                other_n[q], other_n[q] + keys.shape[0], dtype=np.int64))
            others[q].append(vals)
            other_n[q] += keys.shape[0]

    with stats.time("filter"):
        # 'opd' runs where no predicate can match are left out; a
        # competitor run's hits carry their values, which join the pool
        for i, (q, idx, col) in _run_hits(live_runs, preds, backend, stats,
                                          snap, decoded).items():
            s = live_runs[i]
            bounds = np.searchsorted(q, np.arange(K + 1))
            for k in range(K):
                if bounds[k] == bounds[k + 1]:
                    continue
                sel = slice(bounds[k], bounds[k + 1])
                if i in decoded:
                    _push(k, s.keys[idx[sel]], s.seqnos[idx[sel]], -1,
                          vals=col[sel])
                else:
                    _push(k, s.keys[idx[sel]], s.seqnos[idx[sel]], i,
                          codes=col[sel])
        mk, ms, mv = _memtable_visible(mems, snap, value_width)
        if mk.shape[0]:
            for q, p in enumerate(preds):
                m = string_mask(mv, p)
                if m.any():
                    _push(q, mk[m], ms[m], -1, vals=mv[m])

    partials = []
    for q in range(K):
        with stats.time("merge"):
            srcs, codes, vals = _merge_agg_candidates(
                cand[q], others[q], live_runs, mem_newest, snap, value_width)
        with stats.time("aggregate"):
            partials.append(_aggregate_candidates(
                specs[q], live_runs, srcs, codes, vals, stats))
    return partials


def _merge_agg_candidates(c, others, live_runs, mem_newest, snap,
                          value_width):
    """Newest-visible dedup + global shadow check (the discipline of
    ``filter_exec._merge_candidates``) carrying (src, code) payloads."""
    w = value_width if value_width is not None else (
        live_runs[0].value_width if live_runs else 8)
    if not c["keys"]:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, f"S{w}"))
    keys = np.concatenate(c["keys"])
    seqs = np.concatenate(c["seqs"])
    srcs = np.concatenate(c["srcs"])
    codes = np.concatenate(c["codes"])
    order = np.lexsort((np.uint64(0xFFFFFFFFFFFFFFFF) - seqs, keys))
    keys, seqs = keys[order], seqs[order]
    srcs, codes = srcs[order], codes[order]
    first = np.ones(keys.shape[0], np.bool_)
    first[1:] = keys[1:] != keys[:-1]
    keys, seqs = keys[first], seqs[first]
    srcs, codes = srcs[first], codes[first]
    ok = seqs == _global_newest(keys, live_runs, mem_newest, snap)
    srcs, codes = srcs[ok], codes[ok]
    pool = np.concatenate(others) if others else np.zeros(0, f"S{w}")
    is_val = srcs < 0
    vals = pool[codes[is_val]] if is_val.any() else np.zeros(0, pool.dtype)
    return srcs, codes, vals


def _aggregate_candidates(spec, live_runs, srcs, codes, vals, stats):
    """Per-source aggregation of the surviving candidates: codes stay
    codes (order-preserving ops) until the per-run decode of the fold."""
    p = AggPartial()
    if spec.op == "group_count":
        p.groups = {}
    n = srcs.shape[0]
    if n == 0:
        return p
    if spec.op == "count":
        p.count = n
        return p
    is_val = srcs < 0
    run_ids = np.unique(srcs[~is_val])
    if spec.op in ("min", "max"):
        p.count = n
        for r in run_ids:
            s = live_runs[int(r)]
            sel = codes[srcs == r]
            mn = _decode_one(s, int(sel.min()), stats)
            mx = _decode_one(s, int(sel.max()), stats)
            if p.min_value is None or mn < p.min_value:
                p.min_value = mn
            if p.max_value is None or mx > p.max_value:
                p.max_value = mx
        if vals.shape[0]:
            sv = np.sort(vals)  # S-dtype has no min/max ufunc
            mn, mx = bytes(sv[0]), bytes(sv[-1])
            if p.min_value is None or mn < p.min_value:
                p.min_value = mn
            if p.max_value is None or mx > p.max_value:
                p.max_value = mx
        return p
    if spec.op == "sum":
        p.count = n
        for r in run_ids:
            s = live_runs[int(r)]
            hist = np.bincount(codes[srcs == r], minlength=s.opd.size)
            stats.counts["agg_histograms_gathered"] += 1
            p.total += int((hist * planner.run_weights(s)).sum(dtype=np.int64))
        if vals.shape[0]:
            p.total += int(numeric_values(vals).sum())
        return p
    # group_count
    g = spec.group
    for r in run_ids:
        s = live_runs[int(r)]
        hist = np.bincount(codes[srcs == r], minlength=s.opd.size)
        stats.counts["agg_histograms_gathered"] += 1
        if g.kind == "prefix":
            labels_all = planner.run_prefix_table(s, g.prefix_len)
            got = np.nonzero(hist)[0]
            labs, inv = np.unique(labels_all[got], return_inverse=True)
            counts = np.zeros(labs.shape[0], np.int64)
            np.add.at(counts, inv, hist[got])
            p.add_group_counts([bytes(x) for x in labs], counts)
        else:
            edges, labels = planner.group_code_edges(s, g, 0, s.opd.size)
            cum = np.concatenate([[0], np.cumsum(hist)])
            _fold_hist(p, cum[edges[1:]] - cum[edges[:-1]], labels)
    if vals.shape[0]:
        if g.kind == "prefix":
            labs, counts = np.unique(prefix_labels(vals, g.prefix_len),
                                     return_counts=True)
            p.add_group_counts([bytes(x) for x in labs], counts)
        else:
            ids = bucket_ids(vals, g.edges or ())
            got, counts = np.unique(ids, return_counts=True)
            p.add_group_counts([g.bucket_label(int(b)) for b in got], counts)
    return p
