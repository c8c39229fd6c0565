"""Batched probe of one bloom filter with 32-bit keys.

Port of ``repro/kernels/bloom_probe.py``: ``hits[q]`` is 1 when all of
``n_hashes`` bloom bits of key q are set, bit ``h % nbits`` for
``h = mix32(key, BLOOM_SEEDS32[s])`` (the murmur3 finalizer of
``repro/kernels/ref.py``).  As in the Pallas kernel, a bit whose word lies
past the bloom's words reads as 0 (a miss); the reference's ``ref``
oracle clamps the word index instead.

Bloom words and keys are ``int32`` tensors holding ``uint32`` bits; hits
are ``int8``.  ``bloom_probe`` launches ``csrc/bloom_probe.cu`` for tensors
on the card and runs ``bloom_probe_plain`` for tensors on the CPU.  The
kernel takes ``h % nbits`` without a divide: a mask for a power-of-two
``nbits``, else the multiply and shifts of ``fastmod_constants``, which
``fastmod_plain`` repeats in PyTorch for the tests.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import from_u32_bits

BLOOM_SEEDS32 = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
                 0x9E377969)
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur3's 32-bit finalizer of ``x ^ seed`` over int64 values in
    ``[0, 2**32)``."""
    x = x ^ seed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fastmod_constants(nbits: int) -> Tuple[int, int, int]:
    """``(m, s1, s2)`` such that ``h % nbits == h - q * nbits`` with ``q =
    (t + ((h - t) >> s1)) >> s2`` and ``t = (m * h) >> 32`` (``__umulhi``),
    in uint32 arithmetic, for every ``h`` in ``[0, 2**32)`` and ``nbits`` in
    ``[1, 2**32)``: Granlund and Montgomery's division by an invariant
    integer (PLDI 1994, figure 4.1), with ``l = ceil(log2 nbits)`` and
    ``m = floor(2**32 * (2**l - nbits) / nbits) + 1 < 2**32``."""
    if not 1 <= nbits <= _U32:
        raise ValueError(f"nbits must be in [1, 2**32), got {nbits}")
    lg = (nbits - 1).bit_length()
    m = (((1 << lg) - nbits) << 32) // nbits + 1
    return m, min(lg, 1), max(lg - 1, 0)


def _umulhi(h: torch.Tensor, m: int) -> torch.Tensor:
    """(m * h) >> 32 for int64 h in [0, 2**32) and m < 2**32, without int64
    overflow."""
    return (((h & 0xFFFF) * m >> 16) + (h >> 16) * m) >> 16


def fastmod_plain(h: torch.Tensor, nbits: int) -> torch.Tensor:
    """``h % nbits`` for int64 ``h`` in ``[0, 2**32)`` by the kernel's
    formula for a ``nbits`` that is not a power of two
    (``fastmod_constants``)."""
    m, s1, s2 = fastmod_constants(nbits)
    t = _umulhi(h, m)
    q = (t + ((h - t) >> s1)) >> s2
    return h - q * nbits


def _check(bloom_words: torch.Tensor, nbits: int, keys: torch.Tensor,
           n_hashes: int) -> None:
    if not 0 <= n_hashes <= len(BLOOM_SEEDS32):
        raise ValueError(f"n_hashes must be in [0, {len(BLOOM_SEEDS32)}], "
                         f"got {n_hashes}")
    if not 1 <= nbits <= _U32:
        raise ValueError(f"nbits must be in [1, 2**32), got {nbits}")
    if bloom_words.dim() != 1 or keys.dim() != 1:
        raise ValueError(f"bloom words and keys must be 1-D, got "
                         f"{tuple(bloom_words.shape)}, {tuple(keys.shape)}")


def bloom_probe_plain(bloom_words: torch.Tensor, nbits: int,
                      keys: torch.Tensor, n_hashes: int = 6) -> torch.Tensor:
    """Plain version: hits int8 [Q]."""
    _check(bloom_words, nbits, keys, n_hashes)
    n_words = bloom_words.shape[0]
    k = from_u32_bits(keys)
    hits = torch.ones(k.shape[0], dtype=torch.bool, device=keys.device)
    # one zero word past the end: every word index beyond the bloom reads it
    bloom = torch.cat([from_u32_bits(bloom_words), k.new_zeros(1)])
    for s in range(n_hashes):
        h = mix32(k, BLOOM_SEEDS32[s]) % nbits
        word = bloom[torch.clamp(h >> 5, max=n_words)]
        hits &= ((word >> (h & 31)) & 1) == 1
    return hits.to(torch.int8)


def bloom_probe(bloom_words: torch.Tensor, nbits: int, keys: torch.Tensor,
                n_hashes: int = 6) -> torch.Tensor:
    """hits int8 [Q] of uint32 keys against one bloom of uint32 words."""
    if not _build.on_card(bloom_words, keys):
        return bloom_probe_plain(bloom_words, nbits, keys, n_hashes)
    _check(bloom_words, nbits, keys, n_hashes)
    _build.check_operand(bloom_words, "bloom_words", torch.int32, 1)
    _build.check_operand(keys, "keys", torch.int32, 1)
    hits = torch.empty(keys.shape[0], dtype=torch.int8, device=keys.device)
    if keys.shape[0]:
        _build.launch("bloom_probe", "repro_bloom_probe", keys.device,
                      bloom_words.data_ptr(), bloom_words.shape[0], nbits,
                      *fastmod_constants(nbits), keys.data_ptr(),
                      keys.shape[0], n_hashes, hits.data_ptr())
    return hits
