"""Sorted Compressed Tables (SCTs), 'opd' codec.

Port of ``repro/core/sct.py`` for the paper's own design: keys and seqnos
stay columnar on the host, values are OPD-encoded to dense codes that are
bit-packed at a power-of-two width into words on the card, and the
file-grained dictionary stays memory-resident on the host.  Flush packs the
codes with the ``pack_codes`` kernel, and so do the 'jax' and 'numpy'
compaction backends, whose outputs arrive as remapped code columns; SCTs
written by the 'jax_packed' backend arrive already packed and their zone
map is built by unpacking on the card.

Unlike the reference, an SCT keeps no unpacked code column (``SCT.evs``):
readers extract just the codes they need from the packed words on the card
(``codes_at``), the 'jax' filter backend and the host aggregate routes
unpack a transient column per call on the card (``code_column``), and the
'numpy' filter and compaction backends one on the host (``host_codes``).  The 'plain',
'heavy' and 'blob' codecs and ``BlobManager`` are not ported yet (ROADMAP
§1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import BlockIndex
from repro_torch.core.opd import OPD
from repro_torch.kernels import ops
from repro_torch.kernels.bitpack import unpack_codes_plain
from repro_torch.storage.io import FileStore

SEQNO_BYTES = 8


def pack_width(code_bits: int) -> int:
    """Pack width: next power of two (1, 2, 4, 8, 16, 32), so fields never
    straddle a 32-bit word."""
    for w in (1, 2, 4, 8, 16, 32):
        if code_bits <= w:
            return w
    return 32


@dataclasses.dataclass
class SCT:
    file_id: int
    level: int
    keys: np.ndarray          # uint64 [n], (key asc, seqno desc)
    seqnos: np.ndarray        # uint64 [n]
    tombs: np.ndarray         # bool [n]
    blocks: BlockIndex
    key_bytes: int
    value_width: int
    disk_bytes: int
    packed: torch.Tensor      # int32 words on the card (uint32 bits)
    code_bits: int            # pack width
    opd: OPD                  # memory-resident dictionary
    live: torch.Tensor        # bool [n] on the card: ~tombs
    max_seqno: int = 0
    # facts the aggregate planner derives once per SCT (SCTs are immutable
    # after build): weight tables, prefix-label tables, tombstone and key
    # uniqueness flags
    facts: Dict[str, object] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def min_key(self) -> int:
        return int(self.keys[0]) if self.n else 0

    @property
    def max_key(self) -> int:
        return int(self.keys[-1]) if self.n else 0

    @property
    def dict_nbytes(self) -> int:
        return self.opd.nbytes

    def overlaps(self, lo: int, hi: int) -> bool:
        return self.n > 0 and not (hi < self.min_key or lo > self.max_key)

    def codes_at(self, idx: torch.Tensor) -> torch.Tensor:
        """int64 codes of entries ``idx`` (int64, on the card), read straight
        from the packed words (tombstones read as 0)."""
        width = self.code_bits
        per = 32 // width
        words = self.packed[idx // per].to(torch.int64) & 0xFFFFFFFF
        return (words >> ((idx % per) * width)) & ((1 << width) - 1)

    def code_column(self) -> torch.Tensor:
        """int32 codes [n] on the card, -1 at tombstones: the reference's
        ``SCT.evs``, unpacked by the kernel on each call.  The reference
        caches it on the SCT; the port keeps no unpacked column."""
        codes = ops.unpack_codes(self.packed, self.code_bits, self.n)
        codes.masked_fill_(~self.live, -1)
        return codes

    def host_codes(self) -> np.ndarray:
        """int32 codes on the host, -1 at tombstones: the packed words come
        to the host once and are unpacked there by the plain unpack (no
        kernel launch)."""
        codes = unpack_codes_plain(self.packed.cpu(), self.code_bits,
                                   self.n).numpy()
        return np.where(self.tombs, np.int32(-1), codes)

    def value_at(self, pos: int) -> bytes:
        """Decoded value of live entry ``pos``."""
        idx = torch.tensor([pos], dtype=torch.int64, device=self.packed.device)
        return bytes(self.opd.values[int(self.codes_at(idx)[0])])


def record_disk_bytes(codec: str, key_bytes: int, value_width: int,
                      code_bits: int = 32) -> float:
    if codec != "opd":
        raise ValueError(f"codec {codec!r} is not ported yet "
                         "(ROADMAP §1, competitor codecs)")
    return key_bytes + SEQNO_BYTES + pack_width(code_bits) / 8.0


def _opd_encode(raw_values: np.ndarray, tombs: np.ndarray) -> Tuple[np.ndarray, OPD]:
    """Flush-time OPD construction (sort + unique over the frozen domain)."""
    live = ~tombs
    if live.any():
        opd, live_codes = OPD.build(raw_values[live])
    else:
        opd = OPD(np.asarray([], dtype=raw_values.dtype))
        live_codes = np.zeros(0, np.int32)
    evs = np.full(raw_values.shape[0], -1, np.int32)
    evs[live] = live_codes
    return evs, opd


def build_sct(
    *,
    keys: np.ndarray,
    seqnos: np.ndarray,
    tombs: np.ndarray,
    level: int,
    key_bytes: int,
    value_width: int,
    block_bytes: int,
    bloom_bits_per_key: int,
    store: FileStore,
    device,
    raw_values: Optional[np.ndarray] = None,
    encoded: Optional[Tuple[torch.Tensor, OPD]] = None,
    packed_encoded: Optional[Tuple[torch.Tensor, int, OPD]] = None,
) -> SCT:
    """Build + "write" one SCT from exactly one value source: raw values
    (flush: OPD construction, then the pack kernel), ``encoded`` = (int32
    codes on the card, -1 at tombstones; opd) from the 'jax' and 'numpy'
    compaction backends (the pack kernel; no column is kept), or
    ``packed_encoded`` = (packed words on the card, pack width, opd) from
    the 'jax_packed' backend."""
    n = keys.shape[0]
    rec = record_disk_bytes("opd", key_bytes, value_width)
    epb = max(1, int(block_bytes // max(rec, 1)))
    blocks = BlockIndex.build(keys, epb, bloom_bits_per_key)
    live = torch.from_numpy(~tombs).to(device)
    if packed_encoded is not None:
        packed, width, opd = packed_encoded
        field = ops.unpack_codes(packed, width, n)
    elif encoded is not None:
        evs, opd = encoded
        width = pack_width(opd.code_bits)
        field = evs.clamp(min=0)
        packed = ops.pack_codes(field, width)
    else:
        evs, opd = _opd_encode(raw_values, tombs)
        width = pack_width(opd.code_bits)
        field = torch.from_numpy(np.clip(evs, 0, None)).to(device)
        packed = ops.pack_codes(field, width)
    # zone map over what the packed words hold (tombstones as 0)
    blocks.attach_code_zones(field)
    # per-block SUM weight totals: weight per entry = numeric(dict[code]),
    # tombstones zeroed
    if opd.size:
        # deferred: the query package imports this module
        from repro_torch.query.spec import numeric_values

        wtab = numeric_values(opd.values, device)
        entry_w = torch.where(live, wtab[field.to(torch.int64)], 0)
    else:
        wtab = torch.zeros(0, dtype=torch.int64, device=device)
        entry_w = torch.zeros(n, dtype=torch.int64, device=device)
    blocks.attach_weight_sums(entry_w)
    disk = (n * (key_bytes + SEQNO_BYTES) + 4 * int(packed.shape[0])
            + opd.nbytes + blocks.nbytes)
    sct = SCT(file_id=-1, level=level, keys=keys, seqnos=seqnos, tombs=tombs,
              blocks=blocks, key_bytes=key_bytes, value_width=value_width,
              disk_bytes=int(disk), packed=packed, code_bits=width, opd=opd,
              live=live, max_seqno=int(seqnos.max()) if n else 0)
    # the per-code weights are the aggregate planner's SUM table too
    sct.facts["weight_table"] = wtab.to(torch.int32)
    # the id is allocated before the write, in the reference's order:
    # file ids and so the round-robin compaction victims depend on it
    sct.file_id = store.alloc_id()
    store.write(sct, sct.disk_bytes, fid=sct.file_id)
    return sct


def sct_from_arrays(fields: Dict[str, object], device) -> SCT:
    """An SCT from the reference's per-SCT numpy arrays (a plain dict):
    ``keys``, ``seqnos``, ``tombs``, ``packed`` (uint32), ``code_bits``,
    ``opd_values``, the ``BlockIndex`` fields (``entries_per_block``,
    ``first_keys``, ``last_keys``, ``bloom_words``, ``n_hashes``,
    ``nbits``, ``code_lo``, ``code_hi``, ``weight_sums``), ``file_id``,
    ``level``, ``disk_bytes``, ``key_bytes`` and ``value_width``."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    keys = np.asarray(fields["keys"], np.uint64)
    seqnos = np.asarray(fields["seqnos"], np.uint64)
    tombs = np.asarray(fields["tombs"], np.bool_)
    blocks = BlockIndex(
        int(fields["entries_per_block"]),
        np.asarray(fields["first_keys"], np.uint64),
        np.asarray(fields["last_keys"], np.uint64),
        np.asarray(fields["bloom_words"], np.uint32),
        int(fields["n_hashes"]), int(fields["nbits"]),
        code_lo=dev(fields["code_lo"], np.int64),
        code_hi=dev(fields["code_hi"], np.int64),
        weight_sums=dev(fields["weight_sums"], np.int64))
    packed = np.ascontiguousarray(np.asarray(fields["packed"], np.uint32))
    return SCT(
        file_id=int(fields["file_id"]), level=int(fields["level"]),
        keys=keys, seqnos=seqnos, tombs=tombs, blocks=blocks,
        key_bytes=int(fields["key_bytes"]),
        value_width=int(fields["value_width"]),
        disk_bytes=int(fields["disk_bytes"]),
        packed=torch.from_numpy(packed.view(np.int32).copy()).to(device),
        code_bits=int(fields["code_bits"]),
        opd=OPD(np.asarray(fields["opd_values"])),
        live=torch.from_numpy(~tombs).to(device),
        max_seqno=int(seqnos.max()) if keys.shape[0] else 0)
