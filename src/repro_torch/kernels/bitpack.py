"""k-bit pack / unpack of OPD codes (paper §2, cascading compression).

Port of ``repro/kernels/bitpack.py``.  Words are ``int32`` tensors holding
the bits of the reference's ``uint32`` words (torch lacks shifts and
compares on ``uint32``); the layout is the engine's linear one: word j holds
codes j*per .. j*per+per-1, field k at bits k*width, per = 32 / width.

``pack_codes`` / ``unpack_codes`` launch ``csrc/bitpack.cu`` for tensors on
the card and run the plain versions beside them for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

WIDTHS = (1, 2, 4, 8, 16, 32)

# the CUDA unpack's and pack's tiles (passed to nvcc by _build): each of
# UNPACK_THREADS threads of a block writes UNPACK_GROUPS groups of 4 codes
# per round, each of PACK_THREADS reads PACK_GROUPS groups of 4 codes
UNPACK_THREADS = 256
UNPACK_GROUPS = 2
UNPACK_TILE_CODES = 4 * UNPACK_GROUPS * UNPACK_THREADS
PACK_THREADS = 256
PACK_GROUPS = 2
PACK_TILE_CODES = 4 * PACK_GROUPS * PACK_THREADS


def check_width(width: int) -> int:
    if width not in WIDTHS:
        raise ValueError(f"pack width must be one of {WIDTHS}, got {width}")
    return 32 // width


def n_words_for(n: int, width: int) -> int:
    per = check_width(width)
    return (n + per - 1) // per


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def from_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the uint32 value they hold, as int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def pack_codes_plain(codes: torch.Tensor, width: int) -> torch.Tensor:
    """int32 codes [n] (each < 2**width) -> int32 words [ceil(n / per)]."""
    per = check_width(width)
    n = codes.shape[0]
    m = (n + per - 1) // per
    buf = torch.zeros(m * per, dtype=torch.int64, device=codes.device)
    buf[:n] = codes.to(torch.int64) & 0xFFFFFFFF
    buf = buf.reshape(m, per)
    acc = torch.zeros(m, dtype=torch.int64, device=codes.device)
    for k in range(per):
        acc |= buf[:, k] << (k * width)
    return to_u32_bits(acc)


def unpack_codes_plain(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """int32 words -> int32 codes [n]."""
    per = check_width(width)
    shifts = torch.arange(per, dtype=torch.int64, device=words.device) * width
    fields = (from_u32_bits(words)[:, None] >> shifts) & ((1 << width) - 1)
    return fields.reshape(-1)[:n].to(torch.int32)


# --------------------------------------------------------------------------- #
# dispatching wrappers
# --------------------------------------------------------------------------- #
def pack_codes(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack int32 codes [n] into int32 words [ceil(n / (32/width))].  On the
    card ``codes`` may be any contiguous view (codes that do not start on a
    16-byte line are read with 4-byte loads)."""
    if not _build.on_card(codes):
        return pack_codes_plain(codes, width)
    m = n_words_for(codes.shape[0], width)
    _build.check_operand(codes, "codes", torch.int32, 1)
    words = torch.empty(m, dtype=torch.int32, device=codes.device)
    if m:
        _build.launch("pack_codes", "repro_pack_codes", codes.device,
                      codes.data_ptr(), words.data_ptr(), codes.shape[0],
                      width)
    return words


def unpack_codes(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Unpack the first n codes of int32 words into int32 codes [n].  On the
    card ``words`` may be any contiguous view (words that do not start on a
    16-byte line are read with 4-byte loads)."""
    if not _build.on_card(words):
        return unpack_codes_plain(words, width, n)
    per = check_width(width)
    m = words.shape[0]
    if n > m * per:
        raise ValueError(f"{m} words of width {width} hold fewer than {n} codes")
    _build.check_operand(words, "words", torch.int32, 1)
    codes = torch.empty(n, dtype=torch.int32, device=words.device)
    if n:
        _build.launch("unpack_codes", "repro_unpack_codes", words.device,
                      words.data_ptr(), codes.data_ptr(), n, width)
    return codes
