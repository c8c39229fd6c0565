"""Zone-gated K-predicate filter over packed OPD words.

Port of ``repro/kernels/fused_scan.py``.  One launch evaluates K inclusive
code ranges over every SCT of a level: the SCTs' packed words are laid out
tile-aligned, each tile carries a meta row ``(zone_lo, zone_hi,
range_base, 0)`` and reads its K ranges from ``ranges[range_base ...]``, so
SCTs with different dictionaries share one launch.  A tile whose zone meets
no non-empty range is skipped without reading its words (bitmaps zero,
hit 0).  Empty ranges are encoded ``lo > hi``; the padding tile's zone is
``EMPTY_ZONE`` and padding words are ``0xFFFFFFFF``.

Words, meta and ranges are ``int32`` tensors holding ``uint32`` bits.
``fused_zone_filter`` launches ``csrc/fused_scan.cu`` for tensors on the
card and runs ``fused_zone_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import check_width, from_u32_bits, to_u32_bits

DEFAULT_TILE_WORDS = 1024      # the reference's 8 x 128-word tile
META_COLS = 4                  # (zone_lo, zone_hi, range_base, reserved)
EMPTY_ZONE = (0xFFFFFFFF, 0)   # zone no non-empty range intersects
MAX_PREDS = 4096               # range table of one tile fits shared memory


def _check(words, meta, ranges, n_preds: int, tile_words: int) -> int:
    n_tiles = meta.shape[0]
    if meta.dim() != 2 or meta.shape[1] != META_COLS:
        raise ValueError(f"meta must be [n_tiles, {META_COLS}], got {tuple(meta.shape)}")
    if ranges.dim() != 2 or ranges.shape[1] != 2:
        raise ValueError(f"ranges must be [R, 2], got {tuple(ranges.shape)}")
    if words.shape != (n_tiles * tile_words,):
        raise ValueError(f"words must be [{n_tiles} * {tile_words}], got "
                         f"{tuple(words.shape)}")
    if not 1 <= n_preds <= MAX_PREDS:
        raise ValueError(f"n_preds must be in [1, {MAX_PREDS}], got {n_preds}")
    if tile_words < 1:
        raise ValueError(f"tile_words must be positive, got {tile_words}")
    return n_tiles


def fused_zone_filter_plain(
    words: torch.Tensor, meta: torch.Tensor, ranges: torch.Tensor,
    width: int, n_preds: int, tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: bitmaps int32 [K, n_tiles * tile_words], hits int32
    [n_tiles]."""
    per = check_width(width)
    n_tiles = _check(words, meta, ranges, n_preds, tile_words)
    dev = words.device
    meta64 = from_u32_bits(meta)
    rng64 = from_u32_bits(ranges)
    idx = meta64[:, 2:3] + torch.arange(n_preds, device=dev)     # [T, K]
    lo, hi = rng64[idx, 0], rng64[idx, 1]                        # [T, K]
    hit = ((lo <= hi) & (lo <= meta64[:, 1:2])
           & (hi >= meta64[:, 0:1])).any(dim=1)                  # [T]
    w = from_u32_bits(words).reshape(n_tiles, tile_words)
    lo_k = lo.t()[:, :, None]                                    # [K, T, 1]
    hi_k = hi.t()[:, :, None]
    acc = torch.zeros((n_preds, n_tiles, tile_words), dtype=torch.int64,
                      device=dev)
    fmask = (1 << width) - 1
    for f in range(per):
        v = ((w >> (f * width)) & fmask)[None]                   # [1, T, tw]
        acc |= ((v >= lo_k) & (v <= hi_k)).to(torch.int64) << f
    acc *= hit[None, :, None]
    return (to_u32_bits(acc).reshape(n_preds, -1),
            hit.to(torch.int32))


def fused_zone_filter(
    words: torch.Tensor, meta: torch.Tensor, ranges: torch.Tensor,
    width: int, n_preds: int, tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitmaps int32 [K, n_tiles * tile_words] and per-tile hits int32
    [n_tiles]; bit f of bitmaps[k, j] is ``lo_k <= field_f(words[j]) <=
    hi_k`` for the tile's k-th range, zero for skipped tiles."""
    if not _build.on_card(words, meta, ranges):
        return fused_zone_filter_plain(words, meta, ranges, width, n_preds,
                                       tile_words)
    check_width(width)
    n_tiles = _check(words, meta, ranges, n_preds, tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    _build.check_operand(meta, "meta", torch.int32, 2)
    _build.check_operand(ranges, "ranges", torch.int32, 2)
    bitmaps = torch.empty((n_preds, words.shape[0]), dtype=torch.int32,
                          device=words.device)
    hits = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    if n_tiles:
        _build.launch("fused_zone_filter", "repro_fused_zone_filter",
                      words.device, words.data_ptr(), meta.data_ptr(),
                      ranges.data_ptr(), bitmaps.data_ptr(), hits.data_ptr(),
                      n_tiles, tile_words, n_preds, width)
    return bitmaps, hits
