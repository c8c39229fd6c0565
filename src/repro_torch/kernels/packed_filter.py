"""One range filter directly on bit-packed OPD words.

Port of ``repro/kernels/packed_filter.py``, the paper's Figure-5 kernel:
one inclusive ``[lo, hi]`` code range (``lo > hi`` is the empty range) over
packed words of width 1-32, with the codes extracted by shift and mask and
never written out.  The words are cut into tiles of ``tile_words`` words;
the last tile may be partial and is read in place.  The outputs are a
bitmap aligned with the words (bit f of ``bitmap[j]`` = the range holds the
code in field f of word j) and the match count of each tile, counted as the
reference counts its input padded to whole tiles with 0xFFFFFFFF: the last
tile's count adds the padding fields (``2**width - 1``) the range holds.

Words are ``int32`` tensors holding ``uint32`` bits; ``lo`` and ``hi`` are
Python ints in ``[0, 2**32)``.  ``packed_range_filter`` launches
``csrc/packed_filter.cu`` for tensors on the card, each tile split over the
``CLUSTER`` blocks of one thread-block cluster, and runs
``packed_range_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import check_width, from_u32_bits, to_u32_bits

DEFAULT_TILE_WORDS = 256 * 128   # the reference's (block_rows, 128) tile
MAX_TILE_WORDS = 2**25           # a tile's count, 32 fields a word, fits int32
UINT32 = (0, 2**32 - 1)
# blocks a tile is split over on the card (one thread-block cluster); the
# build instantiates each size (``_launch`` takes any), CLUSTER is the one
# the wrapper takes.  Timed
# on an H100 (tools/filter_probe.py): 4 and 8 within 5 % of each other at
# fig5's 37 tiles, 8 faster by a quarter at 8 tiles; 16, a non-portable
# size, was no faster and failed to launch in some builds, so it is not built
CLUSTER_SIZES = (4, 8)
CLUSTER = 8
# both filter kernels' blocks (passed to nvcc by _build): FILTER_THREADS
# threads, each with FILTER_LOADS 16-byte loads in flight (a multiple of 4:
# the code filter's groups of 16 codes); 128 threads or 8 loads were
# within 5 % of these on the same card
FILTER_THREADS = 256
FILTER_LOADS = 4


def _check(words: torch.Tensor, lo: int, hi: int, tile_words: int) -> int:
    """The number of tiles, the last one partial or whole."""
    if not 1 <= tile_words <= MAX_TILE_WORDS:
        raise ValueError(f"tile_words must be in [1, {MAX_TILE_WORDS}], "
                         f"got {tile_words}")
    if words.dim() != 1:
        raise ValueError(f"words must be 1-D, got {tuple(words.shape)}")
    for name, v in (("lo", lo), ("hi", hi)):
        if not UINT32[0] <= v <= UINT32[1]:
            raise ValueError(f"{name} must fit uint32, got {v}")
    return -(-words.shape[0] // tile_words)


def padding_matches(n: int, n_tiles: int, tile: int, fields: int, fill: int,
                    lo: int, hi: int) -> int:
    """Matches of the entries that pad ``n`` entries to ``n_tiles`` whole
    tiles, ``fields`` values of ``fill`` each, in the range ``[lo, hi]``."""
    return (n_tiles * tile - n) * fields if lo <= fill <= hi else 0


def packed_range_filter_plain(
    words: torch.Tensor, lo: int, hi: int, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: bitmap int32 [n_words], counts int32 [n_tiles]."""
    per = check_width(width)
    n_tiles = _check(words, lo, hi, tile_words)
    n = words.shape[0]
    shifts = torch.arange(per, dtype=torch.int64, device=words.device)
    v = (from_u32_bits(words)[:, None] >> (shifts * width)) & ((1 << width) - 1)
    p = (v >= lo) & (v <= hi)
    acc = (p.to(torch.int64) << shifts).sum(dim=1)
    hits = torch.nn.functional.pad(p.sum(dim=1), (0, n_tiles * tile_words - n))
    counts = hits.reshape(n_tiles, tile_words).sum(dim=1)
    if n_tiles:
        counts[-1] += padding_matches(n, n_tiles, tile_words, per,
                                      (1 << width) - 1, lo, hi)
    return to_u32_bits(acc), counts.to(torch.int32)


def packed_range_filter(
    words: torch.Tensor, lo: int, hi: int, width: int,
    tile_words: int = DEFAULT_TILE_WORDS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bitmap int32 [n_words] and match counts int32 [ceil(n_words /
    tile_words)] of one inclusive range over packed words.  On the card
    ``words`` may be any contiguous view (words that do not start on a
    16-byte line are read with 4-byte loads)."""
    return _launch(words, lo, hi, width, tile_words, CLUSTER)


def _launch(words: torch.Tensor, lo: int, hi: int, width: int,
            tile_words: int, cluster: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``packed_range_filter`` at any cluster size the build instantiates
    (the tests and the smoke run each)."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got "
                         f"{cluster}")
    if not _build.on_card(words):
        return packed_range_filter_plain(words, lo, hi, width, tile_words)
    check_width(width)
    n_tiles = _check(words, lo, hi, tile_words)
    _build.check_operand(words, "words", torch.int32, 1)
    if n_tiles * cluster >= 2**31:
        raise ValueError(f"{n_tiles} tiles of {tile_words} words exceed the "
                         f"grid at clusters of {cluster}")
    bitmap = torch.empty(words.shape[0], dtype=torch.int32, device=words.device)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    if n_tiles:
        _build.launch("range_filter_packed", "repro_range_filter_packed",
                      words.device, words.data_ptr(), int(lo), int(hi),
                      bitmap.data_ptr(), counts.data_ptr(), words.shape[0],
                      tile_words, width, cluster)
    return bitmap, counts
