"""One range filter directly on bit-packed OPD words.

Port of ``repro/kernels/packed_filter.py``, the paper's Figure-5 kernel:
one inclusive ``[lo, hi]`` code range (``lo > hi`` is the empty range) over
packed words of width 1-32, with the codes extracted by shift and mask and
never written out.  The words are padded by the caller to whole tiles of
``tile_words`` words; the outputs are a bitmap aligned with the words (bit
f of ``bitmap[j]`` = the range holds the code in field f of word j) and the
match count of each tile, padding words included.

Words are ``int32`` tensors holding ``uint32`` bits; ``lo`` and ``hi`` are
Python ints in ``[0, 2**32)``.  ``packed_range_filter`` launches
``csrc/packed_filter.cu`` for tensors on the card and runs
``packed_range_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import check_width, from_u32_bits, to_u32_bits

DEFAULT_TILE_WORDS = 256 * 128   # the reference's (block_rows, 128) tile
MAX_TILE_WORDS = 1024 * 65535    # grid.y of the launch: 1,024-word chunks
UINT32 = (0, 2**32 - 1)


def _check(words: torch.Tensor, lo: int, hi: int, tile_words: int) -> int:
    if not 1 <= tile_words <= MAX_TILE_WORDS:
        raise ValueError(f"tile_words must be in [1, {MAX_TILE_WORDS}], "
                         f"got {tile_words}")
    if words.dim() != 1 or words.shape[0] % tile_words:
        raise ValueError(f"words must be whole tiles of {tile_words}, got "
                         f"{tuple(words.shape)}")
    for name, v in (("lo", lo), ("hi", hi)):
        if not UINT32[0] <= v <= UINT32[1]:
            raise ValueError(f"{name} must fit uint32, got {v}")
    return words.shape[0] // tile_words


def packed_range_filter_plain(
    words: torch.Tensor, lo: int, hi: int, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: bitmap int32 [n_words], counts int32 [n_tiles]."""
    per = check_width(width)
    n_tiles = _check(words, lo, hi, tile_words)
    w = from_u32_bits(words)
    acc = torch.zeros_like(w)
    hits = torch.zeros_like(w)
    fmask = (1 << width) - 1
    for f in range(per):
        v = (w >> (f * width)) & fmask
        p = (v >= lo) & (v <= hi)
        acc |= p.to(torch.int64) << f
        hits += p
    counts = hits.reshape(n_tiles, tile_words).sum(dim=1)
    return to_u32_bits(acc), counts.to(torch.int32)


def packed_range_filter(
    words: torch.Tensor, lo: int, hi: int, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitmap int32 [n_words] and match counts int32 [n_tiles] of one
    inclusive range over tile-padded packed words."""
    if not _build.on_card(words):
        return packed_range_filter_plain(words, lo, hi, width, tile_words)
    check_width(width)
    n_tiles = _check(words, lo, hi, tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    bitmap = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=words.device)
    if n_tiles:
        _build.launch("range_filter_packed", "repro_range_filter_packed",
                      words.device, words.data_ptr(), int(lo), int(hi),
                      bitmap.data_ptr(), counts.data_ptr(), n_tiles,
                      tile_words, width)
    return bitmap, counts
