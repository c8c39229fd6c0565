"""Zone-gated aggregation and GROUP BY histogram over packed OPD words.

Port of ``repro/kernels/agg_scan.py``.  Both functions take every SCT of a
level in one launch: the SCTs' packed words laid out tile-aligned (padding
words ``0xFFFFFFFF``), one meta row per tile

    (zone_lo, zone_hi, range_base | seg, n_valid, weight_base, weight_total)

``fused_zone_agg``: per tile and per range k of the tile's K inclusive
ranges (``lo > hi`` empty), the count, min code, max code and SUM of the
weights gathered per matching code (``weights[weight_base + code]``).  A
tile whose zone meets no range is skipped; a tile whose zone every
intersecting range contains takes the closed form ``(n_valid, zone_lo,
zone_hi, weight_total)`` when ``zone_lo >= 1`` (tombstones pack as code 0)
and, for SUM, the total is known (not ``WSUM_SENTINEL``).  Min and max stay
codes; folding them over a run's tiles is exact because tile zones are
attained within the run (the reference's docstring proves it).

``zone_histogram``: per tile, bin b counts the valid codes in
``[e_b, e_{b+1})`` of the SCT's edge row ``edges[seg]``; rows are padded by
repeating the last edge.  A tile whose zone lies outside ``[e_0, e_B)`` or
that holds no entry is skipped; a tile whose zone no edge crosses (and
``zone_lo >= 1``) puts ``n_valid`` into one bin.

Entries at or past a tile's ``n_valid`` never count (a padding field can
alias the code ``2**width - 1``).  Words, meta, ranges and edges are
``int32`` tensors holding ``uint32`` bits.  For tensors on the card the
wrappers launch ``csrc/agg_scan.cu`` (``fused_zone_agg``, in the
instantiation ``agg_route`` picks) and ``csrc/zone_histogram.cu`` (in the
one ``hist_route`` picks); for tensors on the CPU they run the plain
versions beside them.  SUM is int64 on both (the TPU kernel summed in
int32; the executor keeps its int32 routing guard, so results agree).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import check_width, from_u32_bits, to_u32_bits
from repro_torch.kernels.fused_scan import DEFAULT_TILE_WORDS, MAX_PREDS

AGG_META_COLS = 6
WSUM_COL = 5                 # meta column: exact tile weight total
WSUM_SENTINEL = 0xFFFFFFFF   # unknown or >= 2**31 total: no SUM closed form
MIN_SENTINEL = 0xFFFFFFFF    # per-tile min when no entry matched
MAX_BINS = 64

AGG_SLOTS = (1, 2, 4, 8)   # the kernel's register slots for ranges
HIST_BINS = (16, 64)       # zone_histogram's bin buckets

FLAG_SKIPPED = 0       # zone meets nothing: words never read
FLAG_EVALUATED = 1     # fields extracted and compared
FLAG_SHORTCIRCUIT = 2  # closed form from the zone alone

__all__ = ["AGG_META_COLS", "WSUM_COL", "WSUM_SENTINEL", "MIN_SENTINEL",
           "MAX_BINS", "AGG_SLOTS", "agg_route", "HIST_BINS", "hist_route",
           "FLAG_SKIPPED",
           "FLAG_EVALUATED", "FLAG_SHORTCIRCUIT", "fused_zone_agg",
           "fused_zone_agg_plain", "zone_histogram", "zone_histogram_plain"]


def _check_tiles(words, meta, tile_words: int) -> int:
    n_tiles = meta.shape[0]
    if meta.dim() != 2 or meta.shape[1] != AGG_META_COLS:
        raise ValueError(f"meta must be [n_tiles, {AGG_META_COLS}], got "
                         f"{tuple(meta.shape)}")
    if tile_words < 1:
        raise ValueError(f"tile_words must be positive, got {tile_words}")
    if words.shape != (n_tiles * tile_words,):
        raise ValueError(f"words must be [{n_tiles} * {tile_words}], got "
                         f"{tuple(words.shape)}")
    return n_tiles


def _check_agg(words, meta, ranges, weights, n_preds: int, with_sum: bool,
               tile_words: int) -> int:
    n_tiles = _check_tiles(words, meta, tile_words)
    if ranges.dim() != 2 or ranges.shape[1] != 2:
        raise ValueError(f"ranges must be [R, 2], got {tuple(ranges.shape)}")
    if not 1 <= n_preds <= MAX_PREDS:
        raise ValueError(f"n_preds must be in [1, {MAX_PREDS}], got {n_preds}")
    if with_sum and (weights.dim() != 1 or weights.shape[0] == 0):
        raise ValueError("SUM needs a non-empty 1-D weight table, got "
                         f"{tuple(weights.shape)}")
    return n_tiles


def _fields(words: torch.Tensor, width: int, tile_words: int) -> torch.Tensor:
    """int64 fields [tiles, tile_words * per] in entry order (word j holds
    entries j*per .. j*per+per-1)."""
    per = 32 // width
    w = from_u32_bits(words).reshape(-1, tile_words)
    shifts = torch.arange(per, dtype=torch.int64, device=words.device) * width
    return ((w[:, :, None] >> shifts) & ((1 << width) - 1)).reshape(
        w.shape[0], -1)


# --------------------------------------------------------------------------- #
# fused_zone_agg
# --------------------------------------------------------------------------- #
def agg_route(words: torch.Tensor, n_preds: int,
              tile_words: int) -> Tuple[int, bool]:
    """The kernel's instantiation for a launch: ``(slots, vec)``.  ``vec``:
    the words are read as 16-byte groups, which needs ``tile_words % 4 ==
    0`` and words on a 16-byte line; ``slots``: the fewest register slots
    of ``AGG_SLOTS`` that hold the K ranges (8 above 8, in chunks), and 8
    always for 4-byte loads."""
    vec = tile_words % 4 == 0 and words.data_ptr() % 16 == 0
    if not vec:
        return AGG_SLOTS[-1], False
    return next((s for s in AGG_SLOTS if n_preds <= s), AGG_SLOTS[-1]), True


def fused_zone_agg_plain(
    words: torch.Tensor, meta: torch.Tensor, ranges: torch.Tensor,
    weights: torch.Tensor, width: int, n_preds: int, with_sum: bool,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, ...]:
    """Plain version; see ``fused_zone_agg``."""
    check_width(width)
    n_tiles = _check_agg(words, meta, ranges, weights, n_preds, with_sum,
                         tile_words)
    dev = words.device
    m = from_u32_bits(meta)
    r = from_u32_bits(ranges)
    z_lo, z_hi = m[:, 0:1], m[:, 1:2]
    idx = m[:, 2:3] + torch.arange(n_preds, device=dev)          # [T, K]
    lo, hi = r[idx, 0], r[idx, 1]
    inter = (lo <= hi) & (lo <= z_hi) & (hi >= z_lo)
    contained = inter & (lo <= z_lo) & (z_hi <= hi)
    any_hit = inter.any(dim=1)
    short = any_hit & (contained | ~inter).all(dim=1) & (m[:, 0] >= 1)
    if with_sum:
        short &= m[:, WSUM_COL] != WSUM_SENTINEL
    closed = short[:, None] & inter
    counts = torch.where(closed, m[:, 3:4], 0)
    mins = torch.where(closed, z_lo, MIN_SENTINEL)
    maxs = torch.where(closed, z_hi, 0)
    sums = torch.where(closed & with_sum, m[:, WSUM_COL:WSUM_COL + 1], 0)
    ev = torch.nonzero(any_hit & ~short).reshape(-1)
    if ev.numel():
        f = _fields(words, width, tile_words)[ev]                 # [E, n]
        valid = torch.arange(f.shape[1], device=dev) < m[ev, 3:4]
        wtab = weights.to(torch.int64)
        for k in range(n_preds):
            p = valid & (f >= lo[ev, k:k + 1]) & (f <= hi[ev, k:k + 1])
            counts[ev, k] = p.sum(dim=1)
            mins[ev, k] = torch.where(p, f, MIN_SENTINEL).amin(dim=1)
            maxs[ev, k] = torch.where(p, f, 0).amax(dim=1)
            if with_sum:
                gi = torch.where(p, m[ev, 4:5] + f, 0)
                sums[ev, k] = torch.where(p, wtab[gi], 0).sum(dim=1)
    flags = torch.where(short, FLAG_SHORTCIRCUIT, any_hit.to(torch.int64))
    return (counts.to(torch.int32), to_u32_bits(mins), to_u32_bits(maxs),
            sums, flags.to(torch.int32).reshape(n_tiles))


def fused_zone_agg(
    words: torch.Tensor, meta: torch.Tensor, ranges: torch.Tensor,
    weights: torch.Tensor, width: int, n_preds: int, with_sum: bool,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, ...]:
    """Per-tile partial aggregates of K ranges in one launch.

      words   int32 [n_tiles * tile_words]   (uint32 bits)
      meta    int32 [n_tiles, 6]             (uint32 bits)
      ranges  int32 [R, 2]                   (uint32 bits), lo > hi empty
      weights int32 [W] flat per-SCT weight tables (read only with SUM)

    Returns ``(counts int32 [T, K], mins int32 [T, K] (uint32 bits,
    MIN_SENTINEL where nothing matched), maxs int32 [T, K], sums int64
    [T, K], flags int32 [T])``."""
    if not _build.on_card(words, meta, ranges, weights):
        return fused_zone_agg_plain(words, meta, ranges, weights, width,
                                    n_preds, with_sum, tile_words)
    return _launch_agg(words, meta, ranges, weights, width, n_preds,
                       with_sum, tile_words,
                       *agg_route(words, n_preds, tile_words))


def _launch_agg(words, meta, ranges, weights, width: int, n_preds: int,
                with_sum: bool, tile_words: int, slots: int,
                vec: bool) -> Tuple[torch.Tensor, ...]:
    """``fused_zone_agg`` on the card at the instantiation ``(slots,
    vec)``.  With 16-byte loads any of ``AGG_SLOTS`` takes any K (slots
    past K hold empty ranges; 8 slots run K above 8 in chunks); 4-byte
    loads take 8 slots only.  ``vec`` needs what ``agg_route`` asks of
    it."""
    check_width(width)
    n_tiles = _check_agg(words, meta, ranges, weights, n_preds, with_sum,
                         tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    _build.check_operand(meta, "meta", torch.int32, 2)
    _build.check_operand(ranges, "ranges", torch.int32, 2)
    _build.check_operand(weights, "weights", torch.int32, 1)
    dev = words.device
    counts = torch.empty((n_tiles, n_preds), dtype=torch.int32, device=dev)
    mins = torch.empty_like(counts)
    maxs = torch.empty_like(counts)
    sums = torch.empty((n_tiles, n_preds), dtype=torch.int64, device=dev)
    flags = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    if n_tiles:
        _build.launch("fused_zone_agg", "repro_fused_zone_agg", dev,
                      words.data_ptr(), meta.data_ptr(), ranges.data_ptr(),
                      weights.data_ptr(), counts.data_ptr(), mins.data_ptr(),
                      maxs.data_ptr(), sums.data_ptr(), flags.data_ptr(),
                      n_tiles, tile_words, n_preds, width, int(with_sum),
                      slots, int(vec))
    return counts, mins, maxs, sums, flags


# --------------------------------------------------------------------------- #
# zone_histogram
# --------------------------------------------------------------------------- #
def _check_hist(words, meta, edges, n_bins: int, tile_words: int) -> int:
    n_tiles = _check_tiles(words, meta, tile_words)
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [1, {MAX_BINS}], got {n_bins}")
    if edges.dim() != 2 or edges.shape[1] != n_bins + 1:
        raise ValueError(f"edges must be [S, {n_bins + 1}], got "
                         f"{tuple(edges.shape)}")
    return n_tiles


def hist_route(words: torch.Tensor, n_bins: int,
               tile_words: int) -> Tuple[int, bool]:
    """The kernel's instantiation for a launch: ``(bins, vec)``.  ``vec``
    as in ``agg_route``; ``bins``: the smallest bucket of ``HIST_BINS``
    that holds ``n_bins``, and 64 always for 4-byte loads."""
    vec = tile_words % 4 == 0 and words.data_ptr() % 16 == 0
    if not vec:
        return HIST_BINS[-1], False
    return next(b for b in HIST_BINS if n_bins <= b), True


def zone_histogram_plain(
    words: torch.Tensor, meta: torch.Tensor, edges: torch.Tensor,
    width: int, n_bins: int, tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version; see ``zone_histogram``."""
    check_width(width)
    n_tiles = _check_hist(words, meta, edges, n_bins, tile_words)
    dev = words.device
    m = from_u32_bits(meta)
    z_lo, z_hi, n_valid = m[:, 0], m[:, 1], m[:, 3]
    er = from_u32_bits(edges)[m[:, 2]]                           # [T, B+1]
    n_le_lo = (er <= z_lo[:, None]).sum(dim=1)
    n_le_hi = (er <= z_hi[:, None]).sum(dim=1)
    empty = (z_hi < er[:, 0]) | (z_lo >= er[:, n_bins]) | (n_valid == 0)
    closed = empty | ((n_le_lo == n_le_hi) & (z_lo >= 1))
    hist = torch.zeros((n_tiles, n_bins), dtype=torch.int64, device=dev)
    one = torch.nonzero(closed & ~empty).reshape(-1)
    hist[one, n_le_lo[one] - 1] = n_valid[one]
    ev = torch.nonzero(~closed).reshape(-1)
    if ev.numel():
        f = _fields(words, width, tile_words)[ev]
        valid = torch.arange(f.shape[1], device=dev) < n_valid[ev, None]
        pos = torch.searchsorted(er[ev].contiguous(), f.contiguous(),
                                 right=True)                     # #(e <= v)
        ok = valid & (pos >= 1) & (pos <= n_bins)
        h = torch.zeros((ev.shape[0], n_bins + 1), dtype=torch.int64,
                        device=dev)
        h.scatter_add_(1, torch.where(ok, pos - 1, n_bins), ok.to(torch.int64))
        hist[ev] = h[:, :n_bins]
    flags = torch.where(empty, FLAG_SKIPPED,
                        torch.where(closed, FLAG_SHORTCIRCUIT, FLAG_EVALUATED))
    return hist.to(torch.int32), flags.to(torch.int32)


def zone_histogram(
    words: torch.Tensor, meta: torch.Tensor, edges: torch.Tensor,
    width: int, n_bins: int, tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile code histogram: bin b counts codes in [e_b, e_{b+1}).

      words int32 [n_tiles * tile_words], meta int32 [n_tiles, 6] with the
      SCT's edge row in column 2, edges int32 [S, n_bins + 1] ascending
      (uint32 bits), n_bins <= MAX_BINS.

    Returns ``(hist int32 [T, n_bins], flags int32 [T])``."""
    if not _build.on_card(words, meta, edges):
        return zone_histogram_plain(words, meta, edges, width, n_bins,
                                    tile_words)
    return _launch_hist(words, meta, edges, width, n_bins, tile_words,
                        *hist_route(words, n_bins, tile_words))


def _launch_hist(words, meta, edges, width: int, n_bins: int,
                 tile_words: int, bins: int,
                 vec: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``zone_histogram`` on the card at the instantiation ``(bins,
    vec)``: with 16-byte loads either bucket of ``HIST_BINS`` that holds
    ``n_bins``; 4-byte loads take 64 bins only.  ``vec`` needs what
    ``hist_route`` asks of it."""
    check_width(width)
    n_tiles = _check_hist(words, meta, edges, n_bins, tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    _build.check_operand(meta, "meta", torch.int32, 2)
    _build.check_operand(edges, "edges", torch.int32, 2)
    dev = words.device
    hist = torch.empty((n_tiles, n_bins), dtype=torch.int32, device=dev)
    flags = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    if n_tiles:
        _build.launch("zone_histogram", "repro_zone_histogram", dev,
                      words.data_ptr(), meta.data_ptr(), edges.data_ptr(),
                      hist.data_ptr(), flags.data_ptr(), n_tiles, tile_words,
                      n_bins, width, bins, int(vec))
    return hist, flags
