"""Range filter over an unpacked OPD code column.

Port of ``repro/kernels/opd_filter.py``, the 'jax' filter backend's
kernel: ``lo <= code <= hi`` over int32 codes (signed compare; tombstones
and padding carry -1), as an int8 mask plus the match count of each tile.
The column is padded by the caller to whole tiles of ``tile_codes`` codes.

``code_range_filter`` launches ``csrc/opd_filter.cu`` for tensors on the
card and runs ``code_range_filter_plain`` for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

DEFAULT_TILE_CODES = 256 * 128   # the reference's (block_rows, 128) tile
MAX_TILE_CODES = 4 * 256 * 65535  # grid.y of the launch: 1,024-code chunks
INT32 = (-2**31, 2**31 - 1)


def _check(codes: torch.Tensor, lo: int, hi: int, tile_codes: int) -> int:
    if not (1 <= tile_codes <= MAX_TILE_CODES and tile_codes % 4 == 0):
        raise ValueError(f"tile_codes must be a multiple of 4 in [4, "
                         f"{MAX_TILE_CODES}], got {tile_codes}")
    if codes.dim() != 1 or codes.shape[0] % tile_codes:
        raise ValueError(f"codes must be whole tiles of {tile_codes}, got "
                         f"{tuple(codes.shape)}")
    for name, v in (("lo", lo), ("hi", hi)):
        if not INT32[0] <= v <= INT32[1]:
            raise ValueError(f"{name} must fit int32, got {v}")
    return codes.shape[0] // tile_codes


def code_range_filter_plain(
    codes: torch.Tensor, lo: int, hi: int,
    tile_codes: int = DEFAULT_TILE_CODES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: mask int8 [n], counts int32 [n_tiles]."""
    n_tiles = _check(codes, lo, hi, tile_codes)
    m = (codes >= lo) & (codes <= hi)
    counts = m.reshape(n_tiles, tile_codes).sum(dim=1, dtype=torch.int32)
    return m.to(torch.int8), counts


def code_range_filter(
    codes: torch.Tensor, lo: int, hi: int,
    tile_codes: int = DEFAULT_TILE_CODES,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask int8 [n] of ``lo <= code <= hi`` and match counts int32
    [n_tiles] over a tile-padded int32 code column."""
    if not _build.on_card(codes):
        return code_range_filter_plain(codes, lo, hi, tile_codes)
    n_tiles = _check(codes, lo, hi, tile_codes)
    _build.check_operand(codes, "codes", torch.int32, 1)
    if codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned (the kernel loads "
                         "4 codes at a time)")
    mask = torch.empty(codes.shape[0], dtype=torch.int8, device=codes.device)
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=codes.device)
    if n_tiles:
        _build.launch("range_filter_codes", "repro_range_filter_codes",
                      codes.device, codes.data_ptr(), int(lo), int(hi),
                      mask.data_ptr(), counts.data_ptr(), n_tiles, tile_codes)
    return mask, counts
