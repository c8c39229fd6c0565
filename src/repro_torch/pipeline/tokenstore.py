"""LSM-OPD-backed training-data store: the paper's technique as a
framework feature.

A training fleet's data plane is an HTAP workload: continuous sample
ingestion concurrent with filtered scans (data selection, curriculum) from
many data-parallel readers.  TokenStore maps this onto the LSM-OPD engine:

  * sample metadata, a fixed-width tag string such as b"web/high/en", is
    the OPD-encoded value column: selection predicates (prefix / range on
    tags) evaluate directly on compressed codes (``fused_zone_filter`` on
    the card under the port's default backend),
  * token payloads ride a separate payload column, never touched by
    selection scans,
  * compaction dedupes re-ingested samples on dictionaries only,
  * MVCC snapshots give every reader a consistent view while ingestion
    continues.

Batches are sharded across data-parallel ranks by a key hash, so every
host draws a disjoint stream without coordination.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import LSMConfig, LSMTree, Predicate
from repro_torch.core.blocks import splitmix64


@dataclasses.dataclass(frozen=True)
class TokenStoreConfig:
    meta_width: int = 48            # fixed-width tag strings (S_V)
    file_bytes: int = 1 * 2**20
    l0_limit: int = 4
    size_ratio: int = 8
    # the port's engine defaults; the reference's store filters on 'numpy'
    # and compacts on LSMConfig's 'numpy'
    filter_backend: str = "fused"
    compaction_backend: str = "jax_packed"


class TokenStore:
    def __init__(self, cfg: TokenStoreConfig = TokenStoreConfig(),
                 device=None):
        """The store's tree lies on ``device``: the card unless the caller
        asks for the CPU."""
        self.cfg = cfg
        self.lsm = LSMTree(LSMConfig(
            codec="opd",
            value_width=cfg.meta_width,
            file_bytes=cfg.file_bytes,
            l0_limit=cfg.l0_limit,
            size_ratio=cfg.size_ratio,
            filter_backend=cfg.filter_backend,
            compaction_backend=cfg.compaction_backend,
        ), device=device)
        # payload column (key-value separation for the large token arrays)
        self._payloads: Dict[int, np.ndarray] = {}
        self.payload_bytes = 0

    # ------------------------------------------------------------------ #
    def put_sample(self, sample_id: int, tokens: np.ndarray, meta: bytes) -> None:
        self.lsm.put(sample_id, meta[: self.cfg.meta_width])
        arr = np.asarray(tokens, np.int32)
        self._payloads[sample_id] = arr
        self.payload_bytes += arr.nbytes
        self.lsm.store.stats.add_write(arr.nbytes, 0)

    def delete_sample(self, sample_id: int) -> None:
        self.lsm.delete(sample_id)
        arr = self._payloads.pop(sample_id, None)
        if arr is not None:
            self.payload_bytes -= arr.nbytes

    def __len__(self) -> int:
        return len(self._payloads)

    # ------------------------------------------------------------------ #
    def select(self, pred: Predicate, dp_rank: int = 0, dp_size: int = 1
               ) -> np.ndarray:
        """Keys whose current metadata matches pred, restricted to this
        data-parallel rank's deterministic shard."""
        keys = self.lsm.filter(pred).keys
        if dp_size > 1:
            owner = splitmix64(keys) % np.uint64(dp_size)
            keys = keys[owner == np.uint64(dp_rank)]
        return keys

    def batches(
        self,
        pred: Predicate,
        batch_size: int,
        seq_len: int,
        dp_rank: int = 0,
        dp_size: int = 1,
        seed: int = 0,
        max_batches: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Pack selected samples into fixed [B, S] next-token batches."""
        keys = self.select(pred, dp_rank, dp_size)
        rng = np.random.default_rng(seed + dp_rank)
        rng.shuffle(keys)
        stream: list = []
        n_emitted = 0
        need = batch_size * (seq_len + 1)
        for k in keys.tolist():
            toks = self._payloads.get(k)
            if toks is None:
                continue
            self.lsm.store.stats.add_read(toks.nbytes, 1)
            stream.append(toks)
            total = sum(t.shape[0] for t in stream)
            while total >= need:
                flat = np.concatenate(stream)
                block = flat[:need].reshape(batch_size, seq_len + 1)
                rest = flat[need:]
                stream = [rest] if rest.size else []
                total = rest.size
                yield {
                    "tokens": block[:, :-1].astype(np.int32),
                    "labels": block[:, 1:].astype(np.int32),
                    "mask": np.ones((batch_size, seq_len), np.float32),
                }
                n_emitted += 1
                if max_batches is not None and n_emitted >= max_batches:
                    return
