"""K range predicates in one pass over packed OPD words.

Port of ``repro/kernels/multi_filter.py``, the 'jax_packed' filter
backend's kernel.  Each packed word is read once and each of its fields
extracted once for all K inclusive ``[lo, hi]`` code ranges (``lo > hi`` is
the empty range).  The words are padded by the caller to whole tiles of
``tile_words`` words; the outputs are K bitmaps aligned with the words (bit
f of ``bitmaps[k, j]`` = range k holds the code in field f of word j) and
the (K, tiles) match counts, padding words included.

Words and ranges are ``int32`` tensors holding ``uint32`` bits.
``multi_range_filter`` launches ``csrc/multi_filter.cu`` for tensors on the
card and runs ``multi_range_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import check_width, from_u32_bits, to_u32_bits

DEFAULT_TILE_WORDS = 256 * 128   # the reference's (block_rows, 128) tile
MAX_PREDS = 4096                 # ranges and counts of a block fit 48 KB
MAX_TILE_WORDS = 1024 * 65535    # grid.y of the launch: 1,024-word chunks


def _check(words: torch.Tensor, ranges: torch.Tensor,
           tile_words: int) -> Tuple[int, int]:
    if ranges.dim() != 2 or ranges.shape[1] != 2:
        raise ValueError(f"ranges must be [K, 2], got {tuple(ranges.shape)}")
    n_preds = int(ranges.shape[0])
    if not 1 <= n_preds <= MAX_PREDS:
        raise ValueError(f"K must be in [1, {MAX_PREDS}], got {n_preds}")
    if not 1 <= tile_words <= MAX_TILE_WORDS:
        raise ValueError(f"tile_words must be in [1, {MAX_TILE_WORDS}], "
                         f"got {tile_words}")
    if words.dim() != 1 or words.shape[0] % tile_words:
        raise ValueError(f"words must be whole tiles of {tile_words}, got "
                         f"{tuple(words.shape)}")
    return words.shape[0] // tile_words, n_preds


def multi_range_filter_plain(
    words: torch.Tensor, ranges: torch.Tensor, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: bitmaps int32 [K, n_words], counts int32 [K, n_tiles]."""
    per = check_width(width)
    n_tiles, n_preds = _check(words, ranges, tile_words)
    w = from_u32_bits(words)[None]                               # [1, m]
    rng = from_u32_bits(ranges)
    lo, hi = rng[:, 0:1], rng[:, 1:2]                            # [K, 1]
    acc = torch.zeros((n_preds, words.shape[0]), dtype=torch.int64,
                      device=words.device)
    hits = torch.zeros_like(acc)
    fmask = (1 << width) - 1
    for f in range(per):
        v = (w >> (f * width)) & fmask
        p = (v >= lo) & (v <= hi)
        acc |= p.to(torch.int64) << f
        hits += p
    counts = hits.reshape(n_preds, n_tiles, tile_words).sum(dim=2)
    return to_u32_bits(acc), counts.to(torch.int32)


def multi_range_filter(
    words: torch.Tensor, ranges: torch.Tensor, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitmaps int32 [K, n_words] and match counts int32 [K, n_tiles] of K
    inclusive ranges over tile-padded packed words."""
    if not _build.on_card(words, ranges):
        return multi_range_filter_plain(words, ranges, width, tile_words)
    check_width(width)
    n_tiles, n_preds = _check(words, ranges, tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    _build.check_operand(ranges, "ranges", torch.int32, 2)
    bitmaps = torch.empty((n_preds, words.shape[0]), dtype=torch.int32,
                          device=words.device)
    counts = torch.zeros((n_preds, n_tiles), dtype=torch.int32,
                         device=words.device)
    if n_tiles:
        _build.launch("multi_range_filter_packed", "repro_multi_range_filter",
                      words.device, words.data_ptr(), ranges.data_ptr(),
                      bitmaps.data_ptr(), counts.data_ptr(), n_tiles,
                      tile_words, n_preds, width)
    return bitmaps, counts
