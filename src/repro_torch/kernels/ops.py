"""Public entry points of the port's kernels.

Port of ``repro/kernels/ops.py`` for the engine's main path.  The
reference's host-side reshapes, pads and permutations into the TPU's
(8 | 128, 128) tile layout are gone: every kernel here works on the
engine's linear word layout.  What remains is the level-wide tile/meta
construction of ``fused_level_filter``, vectorised on the device, and
``bitmap_to_mask``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.bitpack import (check_width, pack_codes, to_u32_bits,
                                         unpack_codes)
from repro_torch.kernels.fused_scan import (DEFAULT_TILE_WORDS, EMPTY_ZONE,
                                            fused_zone_filter)
from repro_torch.kernels.merge_remap import remap_pack_codes

__all__ = ["LAUNCHES", "reset_launches", "pack_codes", "unpack_codes",
           "remap_pack_codes", "fused_level_filter", "bitmap_to_mask",
           "tile_zones"]

# (code_lo int64 [n_blocks], code_hi int64 [n_blocks], entries_per_block)
Zones = Optional[Tuple[torch.Tensor, torch.Tensor, int]]


def tile_zones(n: int, n_words: int, zones: Zones, n_tiles: int,
               tile_entries: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (zone_lo, zone_hi) as int64 [n_tiles] each.

    A tile covering entries [e0, e1) takes the min/max over the 4 KB blocks
    ``e0 // epb .. (e1 - 1) // epb`` (blocks straddle tiles).  Padding-only
    tiles get ``EMPTY_ZONE``; an SCT without zones (or without words) gets
    the always-hit zone ``(0, 0xFFFFFFFF)`` on every tile."""
    if zones is None or n_words == 0:
        return (torch.zeros(n_tiles, dtype=torch.int64, device=device),
                torch.full((n_tiles,), 0xFFFFFFFF, dtype=torch.int64,
                           device=device))
    code_lo, code_hi, epb = zones
    t = torch.arange(n_tiles, dtype=torch.int64, device=device)
    e0 = t * tile_entries
    e1 = torch.clamp(e0 + tile_entries, max=n)
    real = e0 < e1
    b0 = e0 // epb
    counts = torch.where(real, (e1 - 1) // epb - b0 + 1, 0)
    tile_of = torch.repeat_interleave(t, counts)
    starts = torch.cumsum(counts, 0) - counts
    blk = b0[tile_of] + torch.arange(tile_of.shape[0], device=device) \
        - starts[tile_of]
    z_lo = torch.full((n_tiles,), EMPTY_ZONE[0], dtype=torch.int64,
                      device=device)
    z_hi = torch.full((n_tiles,), EMPTY_ZONE[1], dtype=torch.int64,
                      device=device)
    z_lo.scatter_reduce_(0, tile_of, code_lo[blk], "amin")
    z_hi.scatter_reduce_(0, tile_of, code_hi[blk], "amax")
    return z_lo, z_hi


def fused_level_filter(
    packed_list: Sequence[torch.Tensor], n_list: Sequence[int],
    ranges_list: Sequence[torch.Tensor], zones_list: Sequence[Zones],
    width: int, tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[List[torch.Tensor], Dict[str, int]]:
    """ONE kernel launch evaluating K code ranges over S packed columns.

      packed_list: per-SCT int32 packed words (device)
      n_list:      per-SCT entry counts
      ranges_list: per-SCT int64 [K, 2] inclusive [lo, hi]; lo > hi empty
      zones_list:  per-SCT (code_lo, code_hi, entries_per_block) or None

    Each SCT's words are padded to whole tiles with 0xFFFFFFFF; its tiles
    read ranges at ``s_idx * K``.  Returns (bitmaps, info): bitmaps[s] is
    int32 [K, n_words_s] aligned with packed_list[s]; info holds the
    tiles/blocks skip telemetry as Python ints."""
    per = check_width(width)
    tile_entries = tile_words * per
    dev = packed_list[0].device
    n_preds = int(ranges_list[0].shape[0])
    seg_words = [int(p.shape[0]) for p in packed_list]
    seg_tiles = [max(1, -(-m // tile_words)) for m in seg_words]
    total_tiles = sum(seg_tiles)
    words = torch.full((total_tiles * tile_words,), -1, dtype=torch.int32,
                       device=dev)
    meta = torch.zeros((total_tiles, 4), dtype=torch.int64, device=dev)
    w_off = t_off = 0
    for s_idx, (packed, n, zones) in enumerate(
            zip(packed_list, n_list, zones_list)):
        m, nt = seg_words[s_idx], seg_tiles[s_idx]
        words[w_off:w_off + m] = packed
        z_lo, z_hi = tile_zones(int(n), m, zones, nt, tile_entries, dev)
        meta[t_off:t_off + nt, 0] = z_lo
        meta[t_off:t_off + nt, 1] = z_hi
        meta[t_off:t_off + nt, 2] = s_idx * n_preds
        w_off += nt * tile_words
        t_off += nt
    ranges = torch.cat([r.to(device=dev, dtype=torch.int64).reshape(-1, 2)
                        for r in ranges_list])
    flat, hits = fused_zone_filter(words, to_u32_bits(meta),
                                   to_u32_bits(ranges), width, n_preds,
                                   tile_words)
    skipped = hits == 0

    bitmaps = []
    blocks_total = 0
    # tiles skipped, blocks skipped, blocks prunable: one transfer at the end
    acc = torch.zeros(3, dtype=torch.int64, device=dev)
    acc[0] = skipped.sum()
    w_off = t_off = 0
    for s_idx, (m, nt) in enumerate(zip(seg_words, seg_tiles)):
        bitmaps.append(flat[:, w_off:w_off + m])
        zones = zones_list[s_idx]
        if zones is not None:
            code_lo, code_hi, epb = zones
            nb = int(code_lo.shape[0])
            blocks_total += nb
            # a block is skipped iff EVERY tile overlapping it was
            b = torch.arange(nb, dtype=torch.int64, device=dev)
            t0 = (b * epb) // tile_entries
            t1 = torch.clamp(((b + 1) * epb - 1) // tile_entries, max=nt - 1)
            cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(skipped[t_off:t_off + nt], 0)])
            acc[1] += ((cs[t1 + 1] - cs[t0]) == (t1 - t0 + 1)).sum()
            # block-granular verdict (upper bound on achievable skips)
            rng = ranges[s_idx * n_preds:(s_idx + 1) * n_preds]
            lo, hi = rng[:, 0:1], rng[:, 1:2]
            hit_b = (lo <= hi) & (lo <= code_hi[None]) & (hi >= code_lo[None])
            acc[2] += (~hit_b.any(dim=0)).sum()
        w_off += nt * tile_words
        t_off += nt
    tiles_skipped, blocks_skipped, blocks_prunable = acc.tolist()
    info = {
        "tiles_total": total_tiles,
        "tiles_skipped": tiles_skipped,
        "blocks_total": blocks_total,
        "blocks_skipped": blocks_skipped,
        "blocks_prunable": blocks_prunable,
    }
    return bitmaps, info


def bitmap_to_mask(bitmap: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Expand int32 bitmaps [..., n_words] to bool masks [..., n]."""
    per = check_width(width)
    bits = torch.arange(per, dtype=torch.int32, device=bitmap.device)
    m = ((bitmap.unsqueeze(-1) >> bits) & 1).to(torch.bool)
    return m.reshape(*bitmap.shape[:-1], -1)[..., :n]
