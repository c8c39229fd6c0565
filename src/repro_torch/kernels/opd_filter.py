"""Range filter over an unpacked OPD code column.

Port of ``repro/kernels/opd_filter.py``, the 'jax' filter backend's
kernel: ``lo <= code <= hi`` over int32 codes (signed compare; tombstones
carry -1), as an int8 mask plus the match count of each tile of
``tile_codes`` codes.  The last tile may be partial and is read in place;
its count adds the padding codes (-1) the range holds, as the reference
counts its input padded to whole tiles.

``code_range_filter`` launches ``csrc/opd_filter.cu`` for tensors on the
card, each tile split over the ``CLUSTER`` blocks of one thread-block
cluster, and runs ``code_range_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed_filter import (CLUSTER, CLUSTER_SIZES,
                                               padding_matches)

DEFAULT_TILE_CODES = 256 * 128   # the reference's (block_rows, 128) tile
MAX_TILE_CODES = 2**30
INT32 = (-2**31, 2**31 - 1)


def _check(codes: torch.Tensor, lo: int, hi: int, tile_codes: int) -> int:
    """The number of tiles, the last one partial or whole."""
    if not (1 <= tile_codes <= MAX_TILE_CODES and tile_codes % 4 == 0):
        raise ValueError(f"tile_codes must be a multiple of 4 in [4, "
                         f"{MAX_TILE_CODES}], got {tile_codes}")
    if codes.dim() != 1:
        raise ValueError(f"codes must be 1-D, got {tuple(codes.shape)}")
    for name, v in (("lo", lo), ("hi", hi)):
        if not INT32[0] <= v <= INT32[1]:
            raise ValueError(f"{name} must fit int32, got {v}")
    return -(-codes.shape[0] // tile_codes)


def code_range_filter_plain(
    codes: torch.Tensor, lo: int, hi: int,
    tile_codes: int = DEFAULT_TILE_CODES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: mask int8 [n], counts int32 [n_tiles]."""
    n_tiles = _check(codes, lo, hi, tile_codes)
    n = codes.shape[0]
    m = (codes >= lo) & (codes <= hi)
    hits = torch.nn.functional.pad(m.to(torch.int32),
                                   (0, n_tiles * tile_codes - n))
    counts = hits.reshape(n_tiles, tile_codes).sum(dim=1, dtype=torch.int32)
    if n_tiles:
        counts[-1] += padding_matches(n, n_tiles, tile_codes, 1, -1, lo, hi)
    return m.to(torch.int8), counts


def code_range_filter(
    codes: torch.Tensor, lo: int, hi: int,
    tile_codes: int = DEFAULT_TILE_CODES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask int8 [n] of ``lo <= code <= hi`` and match counts int32
    [ceil(n / tile_codes)] over an int32 code column.  On the card
    ``codes`` may be any contiguous view (codes that do not start on a
    16-byte line are read with 4-byte loads)."""
    return _launch(codes, lo, hi, tile_codes, CLUSTER)


def _launch(codes: torch.Tensor, lo: int, hi: int, tile_codes: int,
            cluster: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``code_range_filter`` at any cluster size the build instantiates
    (the tests and the smoke run each)."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got "
                         f"{cluster}")
    if not _build.on_card(codes):
        return code_range_filter_plain(codes, lo, hi, tile_codes)
    n_tiles = _check(codes, lo, hi, tile_codes)
    _build.check_operand(codes, "codes", torch.int32, 1)
    if n_tiles * cluster >= 2**31:
        raise ValueError(f"{n_tiles} tiles of {tile_codes} codes exceed the "
                         f"grid at clusters of {cluster}")
    mask = torch.empty(codes.shape[0], dtype=torch.int8, device=codes.device)
    counts = torch.empty(n_tiles, dtype=torch.int32, device=codes.device)
    if n_tiles:
        _build.launch("range_filter_codes", "repro_range_filter_codes",
                      codes.device, codes.data_ptr(), int(lo), int(hi),
                      mask.data_ptr(), counts.data_ptr(), codes.shape[0],
                      tile_codes, cluster)
    return mask, counts
