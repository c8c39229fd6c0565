"""Hot-shard detection and median splits for the sharded engine.

Port of ``repro/shard/rebalance.py``.  A skewed ingest stream funnels most
writes into one shard, whose flush and compaction work then serializes
the whole engine.  The splitter watches per-shard ingest bytes
(``LSMTree.ingest_bytes``) and, when one shard is both past an absolute
threshold and hotter than its peers by ``skew_factor``, splits it at its
key median.

The split reuses the engine's own compaction machinery: the hot tree is
flushed, then each half is rebuilt with ONE ``merge_scts`` call over ALL
of the tree's runs restricted to the half's key range (``key_range=``),
on the tree's device and compaction backend: on an 'opd' tree under
'jax_packed' each half unpacks the inputs with ``unpack_codes`` and
remaps and packs its own entries through its own merged dictionary with
``remap_pack_codes``.  Because the merge spans every run of the tree it
is a bottom merge (``is_bottom=True``): stale versions and tombstones
have nothing left to shadow, so both halves come out fully compacted.

'blob': the halves keep pointing into the old shard's value logs (the
shared ``FileStore`` keeps them addressable) but track only their own
future logs for GC (``mark_dead`` on a log a half does not track does
nothing); pre-split logs are never rewritten or deleted, trading bounded
garbage for the guarantee that no split dangles a sibling's (or a pinned
snapshot's) values.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.compaction import merge_scts
from repro_torch.core.lsm import LSMTree
from repro_torch.core.version import VersionEdit


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    split_threshold_bytes: int = 1 << 20  # min ingest before a split
    skew_factor: float = 2.0              # hot = this x mean shard ingest
    max_shards: int = 64


class HotShardSplitter:
    """Picks the shard to split, if any, from per-shard ingest counters.

    Ingest is measured since the shard's last split decision: fresh halves
    restart at zero, and a shard that turned out unsplittable (one
    distinct key) is deferred until another threshold's worth of ingest
    arrives instead of being probed again every batch.
    """

    def __init__(self, cfg: RebalanceConfig):
        self.cfg = cfg

    @staticmethod
    def _since(tree: LSMTree) -> int:
        return tree.ingest_bytes - getattr(tree, "_rebalance_base", 0)

    def pick(self, trees: List[LSMTree]) -> Optional[int]:
        if len(trees) >= self.cfg.max_shards:
            return None
        since = [self._since(t) for t in trees]
        i = int(np.argmax(since))
        if since[i] < self.cfg.split_threshold_bytes:
            return None
        mean = sum(since) / len(trees)
        if len(trees) > 1 and since[i] < self.cfg.skew_factor * mean:
            return None  # hot-ish, but not skewed: splitting won't help
        return i

    def defer(self, tree: LSMTree) -> None:
        """Reset the shard's ingest baseline (after a split attempt)."""
        tree._rebalance_base = tree.ingest_bytes


def split_shard(
    tree: LSMTree, key_range: Tuple[int, int],
    manifests: Tuple[Optional[str], Optional[str]] = (None, None),
    scheduler=None,
) -> Optional[Tuple[int, LSMTree, LSMTree]]:
    """Split ``tree`` (owner of half-open ``key_range``) at its key median.

    Returns ``(pivot, left, right)`` where left owns ``[lo, pivot)`` and
    right owns ``[pivot, hi)``, or None when the tree holds fewer than two
    distinct keys.  The halves share the old tree's store and device.  The
    old tree's SCT files are NOT deleted here: the caller deletes them only
    after the new shard table is durable, or a crash in between would find
    a table whose manifest names missing files.

    ``manifests`` names the halves' version logs (the sharded engine
    allocates them so a shared spill dir stays free of collisions);
    ``scheduler`` attaches the halves to the caller's maintenance
    scheduler in background mode.
    """
    lo, hi = key_range
    tree.flush()
    tree.drain()  # background: the rotation above must land before the
    #               runs are listed (sync: returns at once)
    runs = tree.all_runs()
    if not runs:
        return None
    ks = np.unique(np.concatenate([s.keys for s in runs]))
    if ks.shape[0] < 2:
        return None
    pivot = int(ks[ks.shape[0] // 2])  # > ks[0] >= lo, <= ks[-1] < hi
    est_half = sum(s.disk_bytes for s in runs) // 2
    halves: List[LSMTree] = []
    # each half runs the full merge under its key_range, so the sort over
    # every input entry is paid twice a split: the split stays a plain use
    # of the merge path, and amortizes as a major compaction of the shard
    for (a, b), manifest in zip(((lo, pivot), (pivot, hi)), manifests):
        half = LSMTree(tree.cfg, store=tree.store, manifest=manifest,
                       scheduler=scheduler, device=tree.device)
        # new writes stay newer than the kept rows, and snapshots of the
        # half (which read the applied seqno) see them
        half._seqno = half._applied = tree._seqno
        out_level = _fitting_level(tree, est_half)
        res = merge_scts(
            runs,
            out_level=out_level,
            is_bottom=True,  # the merge spans every run: nothing below
            file_entries=tree.file_entries,
            store=tree.store,
            stats=half.compaction_stats,
            device=tree.device,
            blob_mgr=half.blob_mgr,
            block_bytes=tree.cfg.block_bytes,
            bloom_bits_per_key=tree.cfg.bloom_bits_per_key,
            backend=tree.cfg.compaction_backend,
            key_range=(a, b),
        )
        # installed through the version set, so the half's manifest
        # records its first shape and a restart recovers split shards too
        half.versions.apply(VersionEdit(
            adds=[(out_level, s) for s in res.outputs],
            last_seqno=tree._seqno))
        half.n_compactions += 1
        half.dict_compares += res.dict_compares
        half.compaction_in_bytes += sum(s.disk_bytes for s in runs)
        half.compaction_out_bytes += sum(s.disk_bytes for s in res.outputs)
        halves.append(half)
    return pivot, halves[0], halves[1]


def _fitting_level(tree: LSMTree, nbytes: int) -> int:
    """The first level deep enough for one sorted run of ``nbytes`` (level
    i holds up to file_bytes * T**i)."""
    level = 1
    while (nbytes > tree.level_capacity(level)
           and level < tree.cfg.max_levels - 1):
        level += 1
    return level
