"""Compaction-time code remap (Algorithm 1 line 9).

Port of ``repro/kernels/merge_remap.py``.  With the per-source ``old ->
new`` tables concatenated into one flat table and a per-source base offset,
``remap_codes`` (``remap_codes_2d``, the 'jax' compaction backend) maps
output entry i to

    code = table[ev[i] + offsets[src[i]]]   if ev[i] >= 0 else -1

(an unused-code slot, -1, comes through as -1), and ``remap_pack_codes``
(``remap_pack_codes_3d``, the 'jax_packed' backend) packs

    code = max(table[ev[i] + offsets[src[i]]], 0)   if ev[i] >= 0 else 0

so dead entries (tombstones, padding) and unused-code slots (-1) pack as 0,
bit-identical to ``bitpack(clip(remapped, 0))``.  The output uses the
engine's linear word layout.  Both launch ``csrc/merge_remap.cu`` for
tensors on the card and run their plain versions for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import n_words_for, pack_codes_plain

# the CUDA remap's tile (passed to nvcc by _build): each of REMAP_THREADS
# threads of a block remaps REMAP_GROUPS groups of 4 entries per round
REMAP_THREADS = 256
REMAP_GROUPS = 2


def remap_codes_plain(evs: torch.Tensor, srcs: torch.Tensor,
                      table: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version: int32 evs/srcs [n], int32 table [T], int32 offsets
    [n_src] -> int32 codes [n], -1 at dead entries."""
    live = evs >= 0
    out = torch.full_like(evs, -1)
    idx = (evs.to(torch.int64)[live]
           + offsets.to(torch.int64)[srcs.to(torch.int64)[live]])
    out[live] = table[idx]
    return out


def remap_codes(evs: torch.Tensor, srcs: torch.Tensor, table: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """Remap <src, ev> pairs through the flat table; dead entries stay -1."""
    if not _build.on_card(evs, srcs, table, offsets):
        return remap_codes_plain(evs, srcs, table, offsets)
    n = _check_pairs(evs, srcs, table, offsets)
    for t, name in ((evs, "evs"), (srcs, "srcs")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 4 entries at a time)")
    out = torch.empty(n, dtype=torch.int32, device=evs.device)
    if n:
        _build.launch("remap_codes", "repro_remap_codes", evs.device,
                      evs.data_ptr(), srcs.data_ptr(), table.data_ptr(),
                      offsets.data_ptr(), out.data_ptr(), n,
                      offsets.shape[0])
    return out


def _check_pairs(evs, srcs, table, offsets) -> int:
    for t, name in ((evs, "evs"), (srcs, "srcs"), (table, "table"),
                    (offsets, "offsets")):
        _build.check_operand(t, name, torch.int32, 1)
    n = evs.shape[0]
    if srcs.shape[0] != n:
        raise ValueError(f"evs and srcs differ in length: {n} vs {srcs.shape[0]}")
    return n


def remap_pack_codes_plain(evs: torch.Tensor, srcs: torch.Tensor,
                           table: torch.Tensor, offsets: torch.Tensor,
                           width: int) -> torch.Tensor:
    """Plain version: int32 evs/srcs [n], int32 table [T], int32 offsets
    [n_src] -> int32 words [ceil(n / (32/width))]."""
    live = evs >= 0
    new = torch.zeros(evs.shape[0], dtype=torch.int64, device=evs.device)
    idx = (evs.to(torch.int64)[live]
           + offsets.to(torch.int64)[srcs.to(torch.int64)[live]])
    new[live] = table.to(torch.int64)[idx]
    return pack_codes_plain(new.clamp(min=0).to(torch.int32), width)


def remap_pack_codes(evs: torch.Tensor, srcs: torch.Tensor,
                     table: torch.Tensor, offsets: torch.Tensor,
                     width: int) -> torch.Tensor:
    """Remap <src, ev> pairs through the flat table and pack the new codes."""
    if not _build.on_card(evs, srcs, table, offsets):
        return remap_pack_codes_plain(evs, srcs, table, offsets, width)
    n = _check_pairs(evs, srcs, table, offsets)
    m = n_words_for(n, width)
    # the kernel reads ev and src in 16-byte lines: a view off such a line
    # is copied first (the engine's never are)
    evs, srcs = _on_a_line(evs), _on_a_line(srcs)
    words = torch.empty(m, dtype=torch.int32, device=evs.device)
    if m:
        _build.launch("remap_pack_codes", "repro_remap_pack_codes", evs.device,
                      evs.data_ptr(), srcs.data_ptr(), table.data_ptr(),
                      offsets.data_ptr(), words.data_ptr(), n,
                      offsets.shape[0], width)
    return words


def _on_a_line(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()
