"""Sorted Compressed Tables (SCTs): the 'opd' codec and the 'plain',
'heavy' and 'blob' competitors.

Port of ``repro/core/sct.py``.  For the paper's own design ('opd') keys
and seqnos stay columnar on the host, values are OPD-encoded to dense codes
that are bit-packed at a power-of-two width into words on the card, and the
file-grained dictionary stays memory-resident on the host.  Flush packs the
codes with the ``pack_codes`` kernel, and so do the 'jax' and 'numpy'
compaction backends, whose outputs arrive as remapped code columns; SCTs
written by the 'jax_packed' backend arrive already packed and their zone
map is built by unpacking on the card.

Unlike the reference, an SCT keeps no unpacked code column (``SCT.evs``):
readers extract just the codes they need from the packed words on the card
(``codes_at``), the 'jax' filter backend and the host aggregate routes
unpack a transient column per call on the card (``code_column``), and the
'numpy' filter and compaction backends one on the host (``host_codes``).

The competitors stay on the host, as in the reference: a 'plain' SCT keeps
its raw ``S<w>`` value column, a 'heavy' one its rows (key 8 bytes, seqno
8, value w) zlib-compressed per block at level 1, so its disk bytes and
blocks are the reference's.  A 'blob' SCT keeps (log id, offset) pointers
into the append-only value logs of its tree's ``BlobManager`` (WiscKey /
BlobDB key-value separation), which it holds a reference to; with
``compress`` each log is zlib-compressed whole.  Readers decode through
three methods that dispatch on ``codec``: ``raw_values`` (every value, each
'heavy' block decompressed, each 'blob' log read once), ``value_at`` (one
value; one block or one log read) and ``decode_slice`` (the values of
[a, b); every block or log the slice touches).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import BlockIndex
from repro_torch.core.opd import OPD
from repro_torch.kernels import ops
from repro_torch.kernels.bitpack import unpack_codes_plain
from repro_torch.storage.io import FileStore

SEQNO_BYTES = 8
PTR_BYTES = 8
CODECS = ("opd", "plain", "heavy", "blob")
# the reference's estimate of a 'heavy' record's compressed share of its raw
# bytes (``repro/core/sct.py:288``); it sizes files, not the zlib output
HEAVY_COMPRESS_EST = 0.5


def pack_width(code_bits: int) -> int:
    """Pack width: next power of two (1, 2, 4, 8, 16, 32), so fields never
    straddle a 32-bit word."""
    for w in (1, 2, 4, 8, 16, 32):
        if code_bits <= w:
            return w
    return 32


class BlobManager:
    """Append-only value logs with garbage-ratio GC (the WiscKey / BlobDB
    competitor), on the host.  A log is one store object: its raw S<w>
    values, or with ``compress`` their bytes zlib-compressed at level 1 and
    charged at the compressed size.  Reads are charged as the reference
    charges them: a raw log one I/O of ``value_width`` bytes a value read,
    a compressed log its whole size in one I/O, and it is really
    decompressed whole on every read.  ``live`` and ``total`` count each
    log's values that runs still point to and that it holds."""

    def __init__(self, store: FileStore, value_width: int,
                 compress: bool = False, gc_threshold: float = 0.5):
        self.store = store
        self.value_width = value_width
        self.compress = compress
        self.gc_threshold = gc_threshold
        self.live: Dict[int, int] = {}     # log id -> values still pointed to
        self.total: Dict[int, int] = {}    # log id -> values it holds
        self.gc_runs = 0
        self.gc_bytes_rewritten = 0

    def write_log(self, values: np.ndarray, fid: Optional[int] = None) -> int:
        """Write ``values`` (S<w>) as one log (under ``fid`` if given, else
        a new id); returns its id.  The liveness tables are the caller's."""
        if self.compress:
            obj = zlib.compress(values.tobytes(), level=1)
            nbytes = len(obj)
        else:
            obj, nbytes = values.copy(), int(values.nbytes)
        return self.store.write(obj, nbytes, fid=fid)

    def append(self, values: np.ndarray) -> Tuple[int, np.ndarray]:
        """Write values as a new log; returns (its id, the values' offsets)."""
        n = values.shape[0]
        fid = self.write_log(values)
        self.live[fid] = n
        self.total[fid] = n
        return fid, np.arange(n, dtype=np.uint64)

    def log_values(self, fid: int) -> np.ndarray:
        """Every value of log ``fid`` (S<w>), decompressed whole where the
        log is compressed; no I/O is charged.  A missing log raises."""
        obj = self.store.payload(fid)
        if self.compress:
            return np.frombuffer(zlib.decompress(obj), f"S{self.value_width}")
        return obj

    def read_values(self, fid: int, ptrs: np.ndarray) -> np.ndarray:
        """The values at offsets ``ptrs`` of log ``fid``: random value reads,
        one I/O a value (BlobDB's scan weakness), or for a compressed log
        the whole file read and decompressed."""
        values = self.log_values(fid)
        n = ptrs.shape[0]
        if self.compress:
            self.store.stats.add_read(self.store.size_of(fid), 1)
        else:
            self.store.stats.add_read(n * self.value_width, n)
        return values[ptrs.astype(np.int64)]

    def mark_dead(self, fid: int, count: int) -> None:
        if fid in self.live:
            self.live[fid] = max(0, self.live[fid] - int(count))

    def forget(self, fid: int) -> None:
        """Drop a log from the liveness tables (GC rewrote or freed it)."""
        self.live.pop(fid, None)
        self.total.pop(fid, None)

    def live_fids(self) -> List[int]:
        return list(self.live)

    def garbage_ratio(self, fid: int) -> float:
        t = self.total.get(fid, 0)
        return 0.0 if t == 0 else 1.0 - self.live.get(fid, 0) / t

    def gc_candidates(self) -> List[int]:
        """Logs whose garbage ratio is above the threshold, in write order."""
        return [f for f in self.live
                if self.garbage_ratio(f) > self.gc_threshold]


@dataclasses.dataclass
class SCT:
    file_id: int
    level: int
    codec: str                # 'opd' | 'plain' | 'heavy' | 'blob'
    keys: np.ndarray          # uint64 [n], (key asc, seqno desc)
    seqnos: np.ndarray        # uint64 [n]
    tombs: np.ndarray         # bool [n]
    blocks: BlockIndex
    key_bytes: int
    value_width: int
    disk_bytes: int
    # --- 'opd' ---
    packed: Optional[torch.Tensor] = None   # int32 words on the card (uint32)
    code_bits: int = 0                      # pack width
    opd: Optional[OPD] = None               # memory-resident dictionary
    live: Optional[torch.Tensor] = None     # bool [n] on the card: ~tombs
    # --- 'plain' ---
    values: Optional[np.ndarray] = None     # S<w> [n] on the host
    # --- 'heavy' ---
    zblocks: Optional[List[bytes]] = None   # zlib rows, one per block
    zblock_entries: int = 0
    # --- 'blob' ---
    vfids: Optional[np.ndarray] = None      # int64 [n] log ids, -1 = none
    vptrs: Optional[np.ndarray] = None      # uint64 [n] offsets in the log
    # the tree's value logs, which a 'blob' SCT reads through; not part of
    # the SCT's value
    blob_mgr: Optional[BlobManager] = dataclasses.field(
        default=None, repr=False, compare=False)
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
        return self.opd.nbytes if self.opd is not None else 0

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

    # ------------------------------------------------------------------ #
    # decoding, one dispatch on the codec each
    # ------------------------------------------------------------------ #
    def raw_values(self) -> np.ndarray:
        """A competitor's raw value column S<w> [n]: a 'plain' SCT's own
        column, every block of a 'heavy' one really decompressed, a 'blob'
        one's values read from each log it points into (b"" at its
        tombstones).  The decode cost the paper's design avoids: 'opd'
        readers stay on the codes, so an 'opd' SCT raises."""
        if self.codec == "plain":
            return self.values
        if self.codec == "heavy":
            return self._decompress_rows(0, len(self.zblocks))
        if self.codec == "blob":
            return self._blob_values(0, self.n)
        raise ValueError("raw_values() decodes the competitors only; "
                         "'opd' readers work on the codes")

    def value_at(self, pos: int) -> bytes:
        """Decoded value of live entry ``pos``: one code from the packed
        words, the 'plain' column, one 'heavy' block decompressed, or one
        value read from a 'blob' log."""
        if self.codec == "plain":
            return bytes(self.values[pos])
        if self.codec == "blob":
            return bytes(self.blob_mgr.read_values(
                int(self.vfids[pos]), self.vptrs[pos:pos + 1])[0])
        if self.codec == "heavy":
            blk = pos // self.zblock_entries
            rows = self._decompress_rows(blk, blk + 1)
            return bytes(rows[pos - blk * self.zblock_entries])
        idx = torch.tensor([pos], dtype=torch.int64, device=self.packed.device)
        return bytes(self.opd.values[int(self.codes_at(idx)[0])])

    def decode_slice(self, a: int, b: int) -> np.ndarray:
        """Values of entries [a, b) (``a < b``), b"" at an 'opd' or 'blob'
        tombstone.  'opd' reads the slice's codes from the packed words on
        the card and maps them through the dictionary (a run of tombstones
        only has an empty one and reads nothing); 'heavy' decompresses
        every block the slice touches, 'blob' reads every log it points
        into once."""
        if self.codec == "plain":
            return self.values[a:b]
        if self.codec == "blob":
            return self._blob_values(a, b)
        if self.codec == "heavy":
            epb = self.zblock_entries
            b_lo = a // epb
            rows = self._decompress_rows(b_lo, (b - 1) // epb + 1)
            return rows[a - b_lo * epb:b - b_lo * epb]
        if self.opd.size == 0:
            return np.zeros(b - a, self.opd.values.dtype)
        idx = torch.arange(a, b, dtype=torch.int64, device=self.packed.device)
        out = self.opd.decode(self.codes_at(idx).cpu().numpy())
        out[self.tombs[a:b]] = b""
        return out

    def _blob_values(self, a: int, b: int) -> np.ndarray:
        """The values of 'blob' entries [a, b), one ``read_values`` per log
        they point into; b"" at tombstones."""
        out = np.zeros(b - a, f"S{self.value_width}")
        fids, ptrs = self.vfids[a:b], self.vptrs[a:b]
        live = fids >= 0
        for fid in np.unique(fids[live]):
            sel = live & (fids == fid)
            out[sel] = self.blob_mgr.read_values(int(fid), ptrs[sel])
        return out

    def _decompress_rows(self, b_lo: int, b_hi: int) -> np.ndarray:
        """The values of 'heavy' blocks [b_lo, b_hi), each block's rows
        really zlib-decompressed."""
        w, row = self.value_width, 8 + 8 + self.value_width
        if b_hi <= b_lo:
            return np.zeros(0, f"S{w}")
        raw = np.frombuffer(b"".join(zlib.decompress(self.zblocks[j])
                                     for j in range(b_lo, b_hi)), np.uint8)
        return raw.reshape(-1, row)[:, 16:].copy().view(f"S{w}").reshape(-1)


def record_disk_bytes(codec: str, key_bytes: int, value_width: int,
                      code_bits: int = 32) -> float:
    """Estimated bytes a record takes on disk, per codec (drives file
    splitting and so the tree's shape)."""
    base = key_bytes + SEQNO_BYTES
    if codec == "plain":
        return base + value_width
    if codec == "heavy":
        return (base + value_width) * HEAVY_COMPRESS_EST
    if codec == "blob":
        return base + PTR_BYTES    # the values are charged to their logs
    if codec == "opd":
        return base + pack_width(code_bits) / 8.0
    raise _unknown(codec)


def _unknown(codec: str) -> ValueError:
    return ValueError(f"codec {codec!r} is not one of "
                      f"{' or '.join(map(repr, CODECS))}")


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


def _zlib_blocks(keys: np.ndarray, seqnos: np.ndarray, values: np.ndarray,
                 epb: int) -> Tuple[List[bytes], int]:
    """Rows (key 8 bytes, seqno 8, value w) compressed ``epb`` at a time by
    zlib at level 1; returns (blocks, their total bytes)."""
    n = keys.shape[0]
    w = values.dtype.itemsize
    rows = np.zeros((n, 8 + 8 + w), np.uint8)
    rows[:, :8] = keys.view(np.uint8).reshape(n, 8)
    rows[:, 8:16] = seqnos.view(np.uint8).reshape(n, 8)
    rows[:, 16:] = values.view(np.uint8).reshape(n, w)
    zblocks = [zlib.compress(rows[lo:lo + epb].tobytes(), level=1)
               for lo in range(0, n, epb)]
    return zblocks, sum(len(z) for z in zblocks)


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
    codec: str = "opd",
    blob_mgr: Optional[BlobManager] = None,
    raw_values: Optional[np.ndarray] = None,
    encoded: Optional[Tuple[torch.Tensor, OPD]] = None,
    packed_encoded: Optional[Tuple[torch.Tensor, int, OPD]] = None,
    blob_refs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> SCT:
    """Build + "write" one SCT from exactly one value source.  'plain' and
    'heavy' take raw values (S<w>, on the host).  'blob' takes raw values
    (flush: the live ones appended to a new log of ``blob_mgr``) or
    ``blob_refs`` = (log ids, offsets) from compaction, which moves the
    pointers and leaves the values where they are.  'opd' takes raw values
    (flush: OPD construction, then the pack kernel), ``encoded`` = (int32
    codes on the card, -1 at tombstones; opd) from the 'jax' and 'numpy'
    compaction backends (the pack kernel; no column is kept), or
    ``packed_encoded`` = (packed words on the card, pack width, opd) from
    the 'jax_packed' backend."""
    n = keys.shape[0]
    rec = record_disk_bytes(codec, key_bytes, value_width)
    epb = max(1, int(block_bytes // max(rec, 1)))
    sct = SCT(file_id=-1, level=level, codec=codec, keys=keys, seqnos=seqnos,
              tombs=tombs, blocks=BlockIndex.build(keys, epb,
                                                   bloom_bits_per_key),
              key_bytes=key_bytes, value_width=value_width, disk_bytes=0,
              max_seqno=int(seqnos.max()) if n else 0)
    # competitors keep no zone map or weight sums, as in the reference
    if codec == "plain":
        sct.values = raw_values
        disk = (n * (key_bytes + SEQNO_BYTES + value_width)
                + sct.blocks.nbytes)
    elif codec == "heavy":
        sct.zblocks, zbytes = _zlib_blocks(keys, seqnos, raw_values, epb)
        sct.zblock_entries = epb
        disk = zbytes + n * (key_bytes - 8) + sct.blocks.nbytes
    elif codec == "blob":
        # the log is written before the SCT's id is allocated, as in the
        # reference: both take their ids from the store's one counter
        sct.blob_mgr = blob_mgr
        sct.vfids, sct.vptrs = (blob_refs if blob_refs is not None
                                else _append_blob(blob_mgr, raw_values, tombs))
        disk = (n * (key_bytes + SEQNO_BYTES + PTR_BYTES)
                + sct.blocks.nbytes)
    else:
        disk = _attach_opd(sct, device, raw_values, encoded, packed_encoded)
    sct.disk_bytes = int(disk)
    # the id is allocated before the write, in the reference's order:
    # file ids and so the round-robin compaction victims depend on it
    sct.file_id = store.alloc_id()
    store.write(sct, sct.disk_bytes, fid=sct.file_id)
    return sct


def _append_blob(blob_mgr: BlobManager, raw_values: np.ndarray,
                 tombs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The live values into a new log (none when every entry is a
    tombstone); returns (log ids, offsets), -1 and 0 at tombstones."""
    live = ~tombs
    fids = np.full(tombs.shape[0], -1, np.int64)
    ptrs = np.zeros(tombs.shape[0], np.uint64)
    if live.any():
        fid, ptrs[live] = blob_mgr.append(raw_values[live])
        fids[live] = fid
    return fids, ptrs


def _attach_opd(sct: SCT, device, raw_values, encoded, packed_encoded) -> int:
    """The 'opd' arm of ``build_sct``: packed words, dictionary, zones and
    weight sums onto ``sct``; returns its disk bytes."""
    n, tombs, blocks = sct.n, sct.tombs, sct.blocks
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
    sct.packed, sct.code_bits, sct.opd, sct.live = packed, width, opd, live
    # the per-code weights are the aggregate planner's SUM table too
    sct.facts["weight_table"] = wtab.to(torch.int32)
    return (n * (sct.key_bytes + SEQNO_BYTES) + 4 * int(packed.shape[0])
            + opd.nbytes + blocks.nbytes)


def sct_from_arrays(fields: Dict[str, object], device,
                    blob_mgr: Optional[BlobManager] = None) -> SCT:
    """An SCT from the reference's per-SCT numpy arrays (a plain dict):
    ``codec`` ('opd' when absent), ``keys``, ``seqnos``, ``tombs``, the
    ``BlockIndex`` fields (``entries_per_block``, ``first_keys``,
    ``last_keys``, ``bloom_words``, ``n_hashes``, ``nbits``, and for 'opd'
    ``code_lo``, ``code_hi``, ``weight_sums``), ``file_id``, ``level``,
    ``disk_bytes``, ``key_bytes`` and ``value_width``; then the codec's
    values: ``packed`` (uint32), ``code_bits`` and ``opd_values`` for
    'opd', ``values`` (S<w>) for 'plain', ``zblocks`` (bytes) and
    ``zblock_entries`` for 'heavy', ``vfids`` and ``vptrs`` for 'blob',
    whose values stay in the logs of ``blob_mgr``."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(device)

    codec = str(fields.get("codec", "opd"))
    if codec not in CODECS:
        raise _unknown(codec)
    keys = np.asarray(fields["keys"], np.uint64)
    seqnos = np.asarray(fields["seqnos"], np.uint64)
    tombs = np.asarray(fields["tombs"], np.bool_)
    blocks = BlockIndex(
        int(fields["entries_per_block"]),
        np.asarray(fields["first_keys"], np.uint64),
        np.asarray(fields["last_keys"], np.uint64),
        np.asarray(fields["bloom_words"], np.uint32),
        int(fields["n_hashes"]), int(fields["nbits"]))
    sct = SCT(file_id=int(fields["file_id"]), level=int(fields["level"]),
              codec=codec, keys=keys, seqnos=seqnos, tombs=tombs,
              blocks=blocks, key_bytes=int(fields["key_bytes"]),
              value_width=int(fields["value_width"]),
              disk_bytes=int(fields["disk_bytes"]),
              max_seqno=int(seqnos.max()) if keys.shape[0] else 0)
    if codec == "plain":
        sct.values = np.asarray(fields["values"], f"S{sct.value_width}")
    elif codec == "heavy":
        sct.zblocks = [bytes(z) for z in fields["zblocks"]]
        sct.zblock_entries = int(fields["zblock_entries"])
    elif codec == "blob":
        sct.vfids = np.asarray(fields["vfids"], np.int64)
        sct.vptrs = np.asarray(fields["vptrs"], np.uint64)
        sct.blob_mgr = blob_mgr
    else:
        blocks.code_lo = dev(fields["code_lo"], np.int64)
        blocks.code_hi = dev(fields["code_hi"], np.int64)
        blocks.weight_sums = dev(fields["weight_sums"], np.int64)
        packed = np.ascontiguousarray(np.asarray(fields["packed"], np.uint32))
        sct.packed = torch.from_numpy(packed.view(np.int32).copy()).to(device)
        sct.code_bits = int(fields["code_bits"])
        sct.opd = OPD(np.asarray(fields["opd_values"]))
        sct.live = torch.from_numpy(~tombs).to(device)
    return sct
