"""Merged range scans (``range_lookup``) across the memtable and all runs.

Port of ``repro/core/iterator.py`` for every codec.  Iterator semantics
follow RocksDB (paper §4.1): examine all levels at once, keep the newest
visible version per key, skip tombstones.  Per run, the ``[a, b)`` slice
of the range is found on the host keys and decoded by
``SCT.decode_slice``: for 'opd' only the slice's codes are read from the
packed words on the card and mapped through the memory-resident
dictionary, 'plain' slices its raw column, 'heavy' decompresses every
block the slice touches and 'blob' reads every value log the slice points
into.  The merge is a host lexsort.

I/O accounting is block-granular, as in the reference: each run charges
the disk blocks its slice touches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.memtable import MemTables, as_mems
from repro_torch.core.sct import SCT
from repro_torch.core.stats import StageStats
from repro_torch.storage.io import FileStore

_SEQ_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def range_scan(
    runs: List[SCT],
    memtable: MemTables,
    lo: int,
    hi: int,
    *,
    stats: StageStats,
    store: FileStore,
    snapshot_seqno: Optional[int] = None,
    block_bytes: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """Newest visible (keys, values) with lo <= key <= hi, tombstones
    elided; ``lo > hi`` is the empty range."""
    snap = np.uint64(snapshot_seqno) if snapshot_seqno is not None else None
    mems = as_mems(memtable)
    ks, sqs, tbs, vls = [], [], [], []
    width = runs[0].value_width if runs else (mems[0].value_width if mems else 8)

    with stats.time("read"):
        slices = []
        for s in runs:
            if s.n == 0 or not s.overlaps(lo, hi):
                slices.append(None)
                continue
            a = int(np.searchsorted(s.keys, np.uint64(lo), side="left"))
            b = int(np.searchsorted(s.keys, np.uint64(hi), side="right"))
            slices.append((a, b))
            if b > a:
                per_rec = s.disk_bytes / max(s.n, 1)
                nbytes = max(block_bytes, int(np.ceil(
                    (b - a) * per_rec / block_bytes)) * block_bytes)
                store.stats.add_read(min(nbytes, s.disk_bytes), 1)

    with stats.time("decode"):
        for s, sl in zip(runs, slices):
            if sl is None or sl[1] <= sl[0]:
                continue
            a, b = sl
            ks.append(s.keys[a:b])
            sqs.append(s.seqnos[a:b])
            tbs.append(s.tombs[a:b])
            vls.append(s.decode_slice(a, b))
        for mem in mems:
            mk, ms, mt, mv = mem.newest_rows(
                None if snap is None else int(snap), lo=lo, hi=hi)
            if mk.shape[0]:
                ks.append(mk), sqs.append(ms), tbs.append(mt), vls.append(mv)

    with stats.time("merge"):
        if not ks:
            return np.zeros(0, np.uint64), np.zeros(0, f"S{width}")
        keys = np.concatenate(ks)
        seqs = np.concatenate(sqs)
        tombs = np.concatenate(tbs)
        vals = np.concatenate(vls)
        if snap is not None:
            vis = seqs <= snap
            keys, seqs, tombs, vals = keys[vis], seqs[vis], tombs[vis], vals[vis]
        order = np.lexsort((_SEQ_MAX - seqs, keys))
        keys, tombs, vals = keys[order], tombs[order], vals[order]
        first = np.ones(keys.shape[0], np.bool_)
        first[1:] = keys[1:] != keys[:-1]
        keep = first & ~tombs
        return keys[keep], vals[keep]

