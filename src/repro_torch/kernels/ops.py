"""Public entry points of the port's kernels.

Port of ``repro/kernels/ops.py``: the engine's main path, its analytics
tier, the staged filter backends, the compaction backends, and the
kernels no engine configuration reaches (``range_filter_packed``, the
Figure-5 pipeline's; ``bloom_probe``; ``ssm_scan``).  The reference's host-side reshapes,
pads and permutations into the TPU's (8 | 128, 128) tile layout are gone:
every kernel here works on the engine's linear word layout.  What remains
is the level-wide tile/meta construction of ``fused_level_filter``,
``fused_level_agg`` and ``level_histogram`` (the reference's per-tile
Python loops, vectorised on the device, with per-SCT folds there and one
transfer per launch), the reference's tile padding of
``multi_range_filter_packed`` ('jax_packed'), and ``bitmap_to_mask``.
``range_filter_codes`` / ``range_filter_count`` ('jax') and
``range_filter_packed`` pass the column as it is: their kernels read a
partial last tile in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import bloom_probe as _bloom
from repro_torch.kernels._build import LAUNCHES, reset_launches
from repro_torch.kernels.agg_scan import (AGG_META_COLS, FLAG_EVALUATED,
                                          FLAG_SHORTCIRCUIT, FLAG_SKIPPED,
                                          MAX_BINS, WSUM_COL, WSUM_SENTINEL,
                                          fused_zone_agg, zone_histogram)
from repro_torch.kernels.bitpack import (check_width, from_u32_bits,
                                         pack_codes, to_u32_bits, unpack_codes)
from repro_torch.kernels.fused_scan import (DEFAULT_TILE_WORDS, EMPTY_ZONE,
                                            fused_zone_filter)
from repro_torch.kernels.merge_remap import remap_codes, remap_pack_codes
from repro_torch.kernels.multi_filter import (DEFAULT_TILE_WORDS as
                                              MULTI_TILE_WORDS,
                                              multi_range_filter)
from repro_torch.kernels.opd_filter import (DEFAULT_TILE_CODES,
                                            code_range_filter)
from repro_torch.kernels.packed_filter import (DEFAULT_TILE_WORDS as
                                               PACKED_TILE_WORDS,
                                               packed_range_filter)
from repro_torch.kernels.ssm_scan import ssm_scan

__all__ = ["LAUNCHES", "reset_launches", "pack_codes", "unpack_codes",
           "remap_codes", "remap_pack_codes", "fused_level_filter", "bitmap_to_mask",
           "tile_zones", "fused_zone_agg", "zone_histogram",
           "fused_level_agg", "level_histogram", "multi_range_filter_packed",
           "range_filter_codes", "range_filter_count", "range_filter_packed",
           "bloom_probe", "ssm_scan"]

# (code_lo int64 [n_blocks], code_hi int64 [n_blocks], entries_per_block)
# and, for the aggregate launches, optionally the per-block SUM weight
# totals int64 [n_blocks] as a fourth entry
Zones = Optional[tuple]


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
    code_lo, code_hi, epb = zones[:3]
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


def level_words(packed_list: Sequence[torch.Tensor], tile_words: int
                ) -> Tuple[torch.Tensor, List[int], List[int]]:
    """The level-wide launch layout: each SCT's words padded to whole tiles
    (at least one) with 0xFFFFFFFF and concatenated.  Returns (words,
    words per SCT, tiles per SCT)."""
    seg_words = [int(p.shape[0]) for p in packed_list]
    seg_tiles = [max(1, -(-m // tile_words)) for m in seg_words]
    words = torch.full((sum(seg_tiles) * tile_words,), -1, dtype=torch.int32,
                       device=packed_list[0].device)
    w_off = 0
    for packed, m, nt in zip(packed_list, seg_words, seg_tiles):
        words[w_off:w_off + m] = packed
        w_off += nt * tile_words
    return words, seg_words, seg_tiles


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
    words, seg_words, seg_tiles = level_words(packed_list, tile_words)
    total_tiles = sum(seg_tiles)
    meta = torch.zeros((total_tiles, 4), dtype=torch.int64, device=dev)
    t_off = 0
    for s_idx, (n, zones) in enumerate(zip(n_list, zones_list)):
        m, nt = seg_words[s_idx], seg_tiles[s_idx]
        z_lo, z_hi = tile_zones(int(n), m, zones, nt, tile_entries, dev)
        meta[t_off:t_off + nt, 0] = z_lo
        meta[t_off:t_off + nt, 1] = z_hi
        meta[t_off:t_off + nt, 2] = s_idx * n_preds
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


def _pad_to_tiles(x: torch.Tensor, tile: int, fill: int) -> torch.Tensor:
    """``x`` [n] padded with ``fill`` to whole tiles (none when n is 0); a
    tile-aligned, 16-byte-aligned ``x`` is returned as it is."""
    n = x.shape[0]
    want = -(-n // tile) * tile
    if want == n and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = torch.full((want,), fill, dtype=x.dtype, device=x.device)
    out[:n] = x
    return out


def multi_range_filter_packed(words: torch.Tensor, width: int, ranges,
                              tile_words: int = MULTI_TILE_WORDS
                              ) -> torch.Tensor:
    """K predicates, one pass: int32 bitmaps [K, len(words)].

    ``ranges`` is (K, 2) inclusive [lo, hi] code ranges (a tensor or numpy
    array of uint32 values); lo > hi is the empty range.  The words are
    padded with 0xFFFFFFFF, whose fields match only where hi = 2**width -
    1, and the bitmaps are cut back to the real words."""
    m = words.shape[0]
    rng = to_u32_bits(_as_tensor(ranges, torch.int64, words.device)
                      .reshape(-1, 2))
    flat = _pad_to_tiles(words, tile_words, -1)
    bitmaps, _counts = multi_range_filter(flat, rng, width, tile_words)
    return bitmaps[:, :m]


def _int32_column(codes: torch.Tensor) -> torch.Tensor:
    """``codes`` as a contiguous int32 column (itself when it is one)."""
    return codes.to(torch.int32).contiguous()


def range_filter_codes(codes: torch.Tensor, lo: int, hi: int,
                       tile_codes: int = DEFAULT_TILE_CODES) -> torch.Tensor:
    """bool mask over an int32 code column: lo <= code <= hi (inclusive)."""
    mask, _counts = code_range_filter(_int32_column(codes), int(lo), int(hi),
                                      tile_codes)
    return mask.view(torch.bool)


def range_filter_count(codes: torch.Tensor, lo: int, hi: int,
                       tile_codes: int = DEFAULT_TILE_CODES) -> int:
    """How many codes of the column lie in [lo, hi], counted as the
    reference counts its column padded with -1 to whole tiles (the padding
    matches where lo <= -1 <= hi)."""
    _mask, counts = code_range_filter(_int32_column(codes), int(lo), int(hi),
                                      tile_codes)
    return int(counts.sum())


def range_filter_packed(words: torch.Tensor, width: int, lo: int, hi: int,
                        tile_words: int = PACKED_TILE_WORDS) -> torch.Tensor:
    """int32 bitmap aligned with ``words``: bit f of ``bitmap[j]`` is
    ``lo <= code <= hi`` for the code in field f of word j (inclusive
    uint32 bounds; lo > hi is the empty range)."""
    bitmap, _counts = packed_range_filter(words.contiguous(), int(lo),
                                          int(hi), width, tile_words)
    return bitmap


def bloom_probe(bloom_words: torch.Tensor, nbits: int, keys32: torch.Tensor,
                n_hashes: int = 6) -> torch.Tensor:
    """bool hits [Q] for uint32 keys against one bloom of uint32 words (both
    int32 tensors of the same bits); a bit past the words is a miss, as in
    the reference's kernel."""
    return _bloom.bloom_probe(bloom_words, nbits, keys32,
                              n_hashes).view(torch.bool)


def bitmap_to_mask(bitmap: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Expand int32 bitmaps [..., n_words] to bool masks [..., n]."""
    per = check_width(width)
    bits = torch.arange(per, dtype=torch.int32, device=bitmap.device)
    m = ((bitmap.unsqueeze(-1) >> bits) & 1).to(torch.bool)
    return m.reshape(*bitmap.shape[:-1], -1)[..., :n]


# --------------------------------------------------------------------------- #
# analytics: zone-gated aggregation and GROUP BY histogram per level
# --------------------------------------------------------------------------- #
def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor, numpy array or sequence as a tensor of ``dtype`` on
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x).astype(
            np.int64 if dtype == torch.int64 else np.int32))
    return x.to(device=device, dtype=dtype)


def _level_tiles(packed_list: Sequence[torch.Tensor], n_list: Sequence[int],
                 zones_list: Sequence[Zones], width: int, tile_words: int):
    """Tile-aligned words of every SCT (padding words 0xFFFFFFFF) and meta
    int64 [tiles, 6] with columns 0-1 (tile zone from the 4 KB block zones
    it overlaps; ``EMPTY_ZONE`` on padding-only tiles, ``(0, 0xFFFFFFFF)``
    without zones), 3 (``n_valid``, the tile's real entries) and 5
    (``WSUM_SENTINEL``).  Returns (words, meta, seg_tiles, seg_of_tile)."""
    per = check_width(width)
    tile_entries = tile_words * per
    dev = packed_list[0].device
    words, seg_words, seg_tiles = level_words(packed_list, tile_words)
    meta = torch.zeros((sum(seg_tiles), AGG_META_COLS), dtype=torch.int64,
                       device=dev)
    meta[:, WSUM_COL] = WSUM_SENTINEL
    t_off = 0
    for n, zones, m, nt in zip(n_list, zones_list, seg_words, seg_tiles):
        z_lo, z_hi = tile_zones(int(n), m, zones, nt, tile_entries, dev)
        t = torch.arange(nt, dtype=torch.int64, device=dev)
        n_valid = torch.clamp(int(n) - t * tile_entries, 0, tile_entries)
        empty = n_valid == 0
        meta[t_off:t_off + nt, 0] = torch.where(empty, EMPTY_ZONE[0], z_lo)
        meta[t_off:t_off + nt, 1] = torch.where(empty, EMPTY_ZONE[1], z_hi)
        meta[t_off:t_off + nt, 3] = n_valid
        t_off += nt
    seg_of = torch.repeat_interleave(
        torch.arange(len(seg_tiles), device=dev),
        torch.tensor(seg_tiles, device=dev))
    return words, meta, seg_tiles, seg_of


def _tile_weight_sums(packed: torch.Tensor, n: int, zones: Zones,
                      wtab: torch.Tensor, width: int, tile_words: int,
                      n_tiles: int) -> torch.Tensor:
    """int64 [n_tiles]: the exact weight total of each tile's entries, or
    ``WSUM_SENTINEL`` where unknown (no block weight sums) or >= 2**31.

    The reference's formula: prefix(e) = the block sums before e's block
    plus the weights of the entries from the start of e's block to e,
    gathered from the packed words (a tombstone reads as code 0 there; such
    blocks have zone_lo 0, so no tile covering them takes the closed
    form).  All tile boundaries are done at once on the device."""
    dev = packed.device
    ws = zones[3] if zones is not None and len(zones) > 3 else None
    if ws is None or wtab.numel() == 0:
        return torch.full((n_tiles,), WSUM_SENTINEL, dtype=torch.int64,
                          device=dev)
    per = 32 // width
    epb = int(zones[2])
    e = torch.clamp(torch.arange(n_tiles + 1, dtype=torch.int64, device=dev)
                    * (tile_words * per), max=n)
    b = e // epb
    part_n = e - b * epb                      # entries of e's block before e
    t_of = torch.repeat_interleave(
        torch.arange(n_tiles + 1, device=dev), part_n)
    starts = torch.cumsum(part_n, 0) - part_n
    idx = (b * epb)[t_of] + torch.arange(t_of.shape[0], device=dev) \
        - starts[t_of]
    word = packed[idx // per].to(torch.int64) & 0xFFFFFFFF
    codes = (word >> ((idx % per) * width)) & ((1 << width) - 1)
    part = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    part.index_add_(0, t_of, wtab.to(torch.int64)[codes])
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(ws.to(torch.int64), 0)])
    pref = cum[b] + part
    v = pref[1:] - pref[:-1]
    return torch.where((v >= 0) & (v < 2**31), v, WSUM_SENTINEL)


def _flag_counts(flags: torch.Tensor) -> torch.Tensor:
    return torch.bincount(flags.to(torch.int64), minlength=3)[:3]


def _tile_info(n_tiles: int, flag_counts) -> Dict[str, int]:
    return {"tiles_total": n_tiles,
            "tiles_skipped": int(flag_counts[FLAG_SKIPPED]),
            "tiles_evaluated": int(flag_counts[FLAG_EVALUATED]),
            "tiles_shortcircuit": int(flag_counts[FLAG_SHORTCIRCUIT])}


def fused_level_agg(
    packed_list: Sequence[torch.Tensor], n_list: Sequence[int],
    ranges_list: Sequence, zones_list: Sequence[Zones], width: int,
    weights_list: Optional[Sequence] = None,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[List[Dict[str, np.ndarray]], Dict[str, int]]:
    """ONE ``fused_zone_agg`` launch computing K (count, min, max[, sum])
    partials over every packed column of a level, folded per SCT on the
    device.

      packed_list:  per-SCT int32 packed words (device)
      n_list:       per-SCT entry counts
      ranges_list:  per-SCT [K, 2] inclusive [lo, hi]; lo > hi empty
      zones_list:   per-SCT (code_lo, code_hi, epb[, weight_sums]) or None
      weights_list: per-SCT int32 weight per code (enables SUM; the ranges
                    must then lie inside each dictionary)

    Returns (per_sct, info): per_sct[s] holds int64 numpy arrays [K]
    ``counts``, ``sums``, ``min_code`` and ``max_code`` (-1 where no entry
    of the SCT matched); info the tiles_{total,skipped,evaluated,
    shortcircuit} telemetry."""
    dev = packed_list[0].device
    n_preds = int(ranges_list[0].shape[0])
    n_scts = len(packed_list)
    with_sum = weights_list is not None
    words, meta, seg_tiles, seg_of = _level_tiles(
        packed_list, n_list, zones_list, width, tile_words)
    meta[:, 2] = seg_of * n_preds
    if with_sum:
        tabs = [_as_tensor(w, torch.int32, dev).reshape(-1)
                for w in weights_list]
        w_off = t_off = 0
        for s, (tab, nt) in enumerate(zip(tabs, seg_tiles)):
            meta[t_off:t_off + nt, 4] = w_off
            meta[t_off:t_off + nt, WSUM_COL] = _tile_weight_sums(
                packed_list[s], int(n_list[s]), zones_list[s], tab, width,
                tile_words, nt)
            w_off += tab.shape[0]
            t_off += nt
        weights = torch.cat(tabs) if w_off else \
            torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        weights = torch.zeros(1, dtype=torch.int32, device=dev)
    ranges = torch.cat([_as_tensor(r, torch.int64, dev).reshape(-1, 2)
                        for r in ranges_list])
    counts, mins, maxs, sums, flags = fused_zone_agg(
        words, to_u32_bits(meta), to_u32_bits(ranges), weights, width,
        n_preds, with_sum, tile_words)

    # per-SCT fold over tiles; min/max only over tiles that matched
    got = counts > 0
    lo = torch.where(got, from_u32_bits(mins), 2**32)
    hi = torch.where(got, from_u32_bits(maxs), -1)
    idx = seg_of[:, None].expand(-1, n_preds)
    shape = (n_scts, n_preds)
    cnt = torch.zeros(shape, dtype=torch.int64, device=dev)
    cnt.index_add_(0, seg_of, counts.to(torch.int64))
    tot = torch.zeros(shape, dtype=torch.int64, device=dev)
    tot.index_add_(0, seg_of, sums)
    mn = torch.full(shape, 2**32, dtype=torch.int64, device=dev)
    mn.scatter_reduce_(0, idx, lo, "amin")
    mx = torch.full(shape, -1, dtype=torch.int64, device=dev)
    mx.scatter_reduce_(0, idx, hi, "amax")
    mn = torch.where(mn == 2**32, -1, mn)
    host = torch.cat([torch.stack([cnt, tot, mn, mx]).reshape(-1),
                      _flag_counts(flags)]).cpu().numpy()   # one transfer
    folded = host[:4 * n_scts * n_preds].reshape(4, n_scts, n_preds)
    per_sct = [{"counts": folded[0, s], "sums": folded[1, s],
                "min_code": folded[2, s], "max_code": folded[3, s]}
               for s in range(n_scts)]
    return per_sct, _tile_info(int(flags.shape[0]), host[-3:])


def level_histogram(
    packed_list: Sequence[torch.Tensor], n_list: Sequence[int],
    edges_list: Sequence, zones_list: Sequence[Zones], width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[List[np.ndarray], Dict[str, int]]:
    """ONE ``zone_histogram`` launch over every packed column of a level
    (the GROUP BY gather).

    ``edges_list[s]`` holds B_s + 1 ascending code edges for SCT s (bin b
    = [e_b, e_{b+1})); rows are padded to the level's widest table by
    repeating the last edge (empty bins).  Returns (hists, info): hists[s]
    is an int64 numpy array [B_s]."""
    dev = packed_list[0].device
    n_bins = max(len(e) - 1 for e in edges_list)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"level_histogram takes 1 to {MAX_BINS} bins, "
                         f"got {n_bins}")
    words, meta, _seg_tiles, seg_of = _level_tiles(
        packed_list, n_list, zones_list, width, tile_words)
    meta[:, 2] = seg_of
    edges = np.zeros((len(edges_list), n_bins + 1), np.int64)
    for s, e in enumerate(edges_list):
        e = np.asarray(e, np.int64).reshape(-1)
        edges[s, :e.shape[0]] = e
        edges[s, e.shape[0]:] = e[-1]
    hist, flags = zone_histogram(
        words, to_u32_bits(meta), to_u32_bits(torch.from_numpy(edges).to(dev)),
        width, n_bins, tile_words)
    per_sct = torch.zeros((len(edges_list), n_bins), dtype=torch.int64,
                          device=dev)
    per_sct.index_add_(0, seg_of, hist.to(torch.int64))
    host = torch.cat([per_sct.reshape(-1),
                      _flag_counts(flags)]).cpu().numpy()    # one transfer
    folded = host[:-3].reshape(len(edges_list), n_bins)
    hists = [folded[s, :len(e) - 1] for s, e in enumerate(edges_list)]
    return hists, _tile_info(int(flags.shape[0]), host[-3:])
