"""Leveling compaction: OPD's Algorithm 1 and the competitors' merges.

Port of ``repro/core/compaction.py`` for every codec, with the
reference's three 'opd' encode backends (``backend=``), which write
bit-identical SCTs.  The key merge is the same for every codec and stays
on the host: concatenate the inputs' key columns, sort by (key asc, seqno
desc), keep the newest version per key and, at the bottom level, drop
tombstones; then cut the survivors into output files.

The competitors pay what the reference makes them pay, on the host: stage
``decode`` takes every input's raw value column (``SCT.raw_values``: a
'heavy' input's blocks all really decompressed), stage ``encode`` gathers
each output's values, and ``build_sct`` ('write') compresses a 'heavy'
output's blocks again.  The backend does not matter to them.

For 'opd' the values never leave the encoded domain.  Per merge, the
inputs' old codes are read once (tombstones set to -1); per output file,
the old code of every surviving entry is gathered, the dictionary codes it
uses are marked, the dictionaries are merged on the host
(``OPD.merge_subset_flat``: sort + unique over the used entries only) and
every entry is rewritten through the flat ``old -> new`` table:

  'jax_packed'  on the card: the ``unpack_codes`` kernel, the gather and
                marks, then the ``remap_pack_codes`` kernel rewrites and
                packs the output column in one pass;
  'jax'         the same, with the ``remap_codes`` kernel; the remapped
                column is packed by ``build_sct`` (``pack_codes``);
  'numpy'       on the host, as the reference's default: the inputs'
                packed words come to the host once per merge and are
                unpacked there, the gather, marks and remap are numpy; the
                remapped column goes to the card and ``build_sct`` packs it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.opd import OPD
from repro_torch.core.sct import SCT, BlobManager, build_sct, pack_width
from repro_torch.core.stats import StageStats
from repro_torch.kernels import ops
from repro_torch.storage.io import FileStore
from repro_torch.testing.crashpoints import crashpoint

_SEQ_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
BACKENDS = ("numpy", "jax", "jax_packed")


@dataclasses.dataclass
class CompactionResult:
    outputs: List[SCT]
    n_in: int
    n_out: int
    n_dropped: int
    dict_compares: int  # total distinct values sorted (paper's D_i terms)


def merge_scts(
    inputs: List[SCT],
    *,
    out_level: int,
    is_bottom: bool,
    file_entries: int,
    store: FileStore,
    stats: StageStats,
    device,
    blob_mgr: Optional[BlobManager] = None,
    block_bytes: int = 4096,
    bloom_bits_per_key: int = 10,
    backend: str = "jax_packed",
) -> CompactionResult:
    """Merge ``inputs`` (one codec) into ``out_level``; 'blob' inputs need
    their tree's ``blob_mgr``, whose garbage counts the merge updates."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown compaction backend {backend!r} (one of "
                         f"{', '.join(map(repr, BACKENDS))})")
    codec = inputs[0].codec
    assert all(s.codec == codec for s in inputs), \
        "a merge takes inputs of one codec"
    n_in = sum(s.n for s in inputs)

    # ---- stage: read (charge full-file I/O for every input) -------------- #
    with stats.time("read"):
        for s in inputs:
            store.read(s.file_id)

    # ---- stage: decode (only 'plain' and 'heavy' pay here) ---------------- #
    with stats.time("decode"):
        raw_cols = ([s.raw_values() for s in inputs]
                    if codec in ("plain", "heavy") else None)

    # ---- stage: merge (keys + GC on the host) ----------------------------- #
    with stats.time("merge"):
        keys = np.concatenate([s.keys for s in inputs])
        seqnos = np.concatenate([s.seqnos for s in inputs])
        tombs = np.concatenate([s.tombs for s in inputs])
        srcs = np.concatenate(
            [np.full(s.n, i, np.int32) for i, s in enumerate(inputs)])
        idxs = np.concatenate([np.arange(s.n, dtype=np.int64) for s in inputs])
        order = np.lexsort((_SEQ_MAX - seqnos, keys))  # key asc, seqno desc
        keys, seqnos, tombs = keys[order], seqnos[order], tombs[order]
        srcs, idxs = srcs[order], idxs[order]
        keep = np.ones(keys.shape[0], np.bool_)
        keep[1:] = keys[1:] != keys[:-1]   # newest version per key survives
        if is_bottom:
            keep &= ~tombs  # physical delete at the deepest level
        keys, seqnos, tombs = keys[keep], seqnos[keep], tombs[keep]
        srcs, idxs = srcs[keep], idxs[keep]
    n_out = int(keys.shape[0])

    blob = codec == "blob"
    if blob:
        assert blob_mgr is not None, "a 'blob' merge needs its blob_mgr"
        _mark_blob_garbage(inputs, srcs, idxs, blob_mgr)
    outputs: List[SCT] = []
    dict_compares = 0
    host = backend == "numpy"
    # 'plain' and 'heavy' hand build_sct raw values, 'blob' its pointers;
    # for 'opd', 'jax_packed' hands it (words, width, opd), the others
    # (evs, opd)
    source_kw = ("raw_values" if raw_cols is not None else
                 "blob_refs" if blob else
                 "packed_encoded" if backend == "jax_packed" else "encoded")
    if codec == "opd" and n_out:
        with stats.time("encode"):
            source = (_host_source_codes(inputs) if host
                      else _source_codes(inputs, device))
    for lo in range(0, n_out, file_entries):
        hi = min(lo + file_entries, n_out)
        ck, cs, ct = keys[lo:hi], seqnos[lo:hi], tombs[lo:hi]
        with stats.time("encode"):
            if raw_cols is not None:
                value, ncmp = _gather(raw_cols, srcs[lo:hi], idxs[lo:hi],
                                      f"S{inputs[0].value_width}", b""), 0
            elif blob:
                value, ncmp = (
                    _gather([s.vfids for s in inputs], srcs[lo:hi],
                            idxs[lo:hi], np.int64, -1),
                    _gather([s.vptrs for s in inputs], srcs[lo:hi],
                            idxs[lo:hi], np.uint64, 0)), 0
            elif host:
                value, ncmp = _host_remap_codes(
                    inputs, *source, srcs[lo:hi], idxs[lo:hi], ct, device)
            else:
                value, ncmp = _remap_codes(
                    inputs, *source, srcs[lo:hi], idxs[lo:hi], ct, device,
                    backend)
        dict_compares += ncmp
        with stats.time("write"):
            out = build_sct(
                keys=ck, seqnos=cs, tombs=ct, level=out_level,
                key_bytes=inputs[0].key_bytes,
                value_width=inputs[0].value_width, block_bytes=block_bytes,
                bloom_bits_per_key=bloom_bits_per_key, store=store,
                device=device, codec=codec, blob_mgr=blob_mgr,
                **{source_kw: value})
        outputs.append(out)
        crashpoint("compact.mid_spill")
    return CompactionResult(outputs, n_in, n_out, n_in - n_out, dict_compares)


def _source_codes(inputs: List[SCT], device
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Old-code columns of all inputs, unpacked on the card into one int32
    tensor (-1 at tombstones); returns (codes, per-input base into codes,
    per-input base into the concatenated dictionaries), bases int64."""
    cols = []
    for s in inputs:
        c = ops.unpack_codes(s.packed, s.code_bits, s.n)
        cols.append(torch.where(s.live, c, -1))
    code_base, dict_off = _bases(inputs)
    return (torch.cat(cols), torch.from_numpy(code_base).to(device),
            torch.from_numpy(dict_off).to(device))


def _bases(inputs: List[SCT]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-input base (int64) into the concatenated code columns and into
    the concatenated dictionaries."""
    code_base = np.zeros(len(inputs), np.int64)
    np.cumsum([s.n for s in inputs[:-1]], out=code_base[1:])
    dict_off = np.zeros(len(inputs), np.int64)
    np.cumsum([s.opd.size for s in inputs[:-1]], out=dict_off[1:])
    return code_base, dict_off


def _remap_codes(inputs: List[SCT], codes: torch.Tensor,
                 code_base: torch.Tensor, dict_off: torch.Tensor,
                 c_src: np.ndarray, c_idx: np.ndarray, c_tombs: np.ndarray,
                 device, backend: str) -> Tuple[tuple, int]:
    """Algorithm 1 lines 4-9 for one output file on the card: returns
    ((packed words, pack width, new opd) for 'jax_packed', (new codes, new
    opd) for 'jax'; dict_compares)."""
    src = torch.from_numpy(c_src).to(device)
    src64 = src.to(torch.int64)
    old = codes[code_base[src64] + torch.from_numpy(c_idx).to(device)]
    live = (old >= 0) & ~torch.from_numpy(c_tombs).to(device)
    # dictionary codes each input contributes to this output
    n_dict = sum(s.opd.size for s in inputs)
    used = torch.zeros(n_dict, dtype=torch.bool, device=device)
    used[(dict_off[src64] + old.to(torch.int64))[live]] = True
    used_np = used.cpu().numpy()
    bounds = np.cumsum([0] + [s.opd.size for s in inputs])
    used_masks = [used_np[bounds[i]:bounds[i + 1]] for i in range(len(inputs))]
    new_opd, flat, offsets = OPD.merge_subset_flat(
        [s.opd for s in inputs], used_masks)
    ev_in = torch.where(live, old, -1)
    table = torch.from_numpy(flat).to(device)
    bases = torch.from_numpy(offsets[:-1].astype(np.int32)).to(device)
    ncmp = int(used_np.sum())
    if backend == "jax":
        return (ops.remap_codes(ev_in, src, table, bases), new_opd), ncmp
    width = pack_width(new_opd.code_bits)
    words = ops.remap_pack_codes(ev_in, src, table, bases, width)
    return (words, width, new_opd), ncmp


def _host_source_codes(inputs: List[SCT]) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """The 'numpy' backend's ``_source_codes``: each input's packed words
    come to the host once and are unpacked there by the plain unpack
    (int32, -1 at tombstones)."""
    return (np.concatenate([s.host_codes() for s in inputs]),
            *_bases(inputs))


def _host_remap_codes(inputs: List[SCT], codes: np.ndarray,
                      code_base: np.ndarray, dict_off: np.ndarray,
                      c_src: np.ndarray, c_idx: np.ndarray,
                      c_tombs: np.ndarray, device
                      ) -> Tuple[Tuple[torch.Tensor, OPD], int]:
    """Algorithm 1 lines 4-9 for one output file on the host (the
    reference's 'numpy' branch): returns ((new codes on the card, new
    opd), dict_compares)."""
    old = codes[code_base[c_src] + c_idx]
    live = (old >= 0) & ~c_tombs
    used = np.zeros(sum(s.opd.size for s in inputs), np.bool_)
    used[dict_off[c_src[live]] + old[live]] = True
    bounds = np.cumsum([0] + [s.opd.size for s in inputs])
    used_masks = [used[bounds[i]:bounds[i + 1]] for i in range(len(inputs))]
    new_opd, flat, offsets = OPD.merge_subset_flat(
        [s.opd for s in inputs], used_masks)
    new = np.full(c_src.shape[0], -1, np.int32)
    new[live] = flat[old[live].astype(np.int64) + offsets[c_src[live]]]
    return (torch.from_numpy(new).to(device), new_opd), int(used.sum())


def _gather(cols: List[np.ndarray], c_src: np.ndarray, c_idx: np.ndarray,
            dtype, fill) -> np.ndarray:
    """One output's column gathered from the inputs' ``cols`` (raw values
    or 'blob' pointers), ``fill`` where no input supplies an entry."""
    out = np.full(c_src.shape[0], fill, dtype)
    for i, col in enumerate(cols):
        sel = c_src == i
        if sel.any():
            out[sel] = col[c_idx[sel]]
    return out


def _mark_blob_garbage(inputs: List[SCT], srcs: np.ndarray, idxs: np.ndarray,
                       blob_mgr: BlobManager) -> None:
    """Entries the merge dropped leave garbage in the logs they point into.
    (The reference's ``key_range`` restriction, for its shard split, is not
    ported.)"""
    starts = np.zeros(len(inputs) + 1, np.int64)
    np.cumsum([s.n for s in inputs], out=starts[1:])
    kept = np.zeros(int(starts[-1]), np.bool_)
    kept[starts[srcs] + idxs] = True
    for i, s in enumerate(inputs):
        dead = ~kept[starts[i]:starts[i + 1]] & (s.vfids >= 0)
        if dead.any():
            fids, counts = np.unique(s.vfids[dead], return_counts=True)
            for fid, count in zip(fids.tolist(), counts.tolist()):
                blob_mgr.mark_dead(fid, count)
