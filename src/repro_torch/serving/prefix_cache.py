"""LSM-OPD-backed prefix-cache index for serving fleets.

Serving reuses KV-cache pages across requests that share a prompt prefix.
The index mapping prefix hash -> (page ids, routing tag) is an HTAP
workload: every admitted request writes, every scheduler tick runs tag
scans ("which cached prefixes belong to tenant X?"), and eviction is a
scan over coldness tags.  Tags are the OPD-encoded value column, so those
scans run on compressed codes (``fused_zone_filter`` on the card under the
port's default backend) while admission keeps point-lookup latency.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import LSMConfig, LSMTree, Predicate
from repro_torch.core.blocks import splitmix64


@dataclasses.dataclass(frozen=True)
class PrefixCacheConfig:
    tag_width: int = 32
    file_bytes: int = 256 * 1024
    l0_limit: int = 4
    # the port's engine defaults; the reference takes LSMConfig's 'numpy'
    filter_backend: str = "fused"
    compaction_backend: str = "jax_packed"


def prefix_key(tokens: np.ndarray) -> int:
    """Order-sensitive 64-bit rolling hash of a token prefix."""
    h = np.uint64(0xCBF29CE484222325)
    with np.errstate(over="ignore"):
        for t in np.asarray(tokens, np.uint64):
            h = splitmix64(h ^ t)
    return int(h)


class PrefixCacheIndex:
    def __init__(self, cfg: PrefixCacheConfig = PrefixCacheConfig(),
                 device=None):
        """The index's tree lies on ``device``: the card unless the caller
        asks for the CPU."""
        self.cfg = cfg
        self.lsm = LSMTree(LSMConfig(
            codec="opd", value_width=cfg.tag_width,
            file_bytes=cfg.file_bytes, l0_limit=cfg.l0_limit,
            filter_backend=cfg.filter_backend,
            compaction_backend=cfg.compaction_backend), device=device)
        self._pages: Dict[int, List[int]] = {}  # key -> KV page ids

    # ------------------------------------------------------------------ #
    def admit(self, tokens: np.ndarray, pages: Sequence[int],
              tag: bytes) -> int:
        """Register a cached prefix with its routing/coldness tag."""
        k = prefix_key(tokens)
        self.lsm.put(k, tag[: self.cfg.tag_width])
        self._pages[k] = list(pages)
        return k

    def lookup(self, tokens: np.ndarray) -> Optional[Tuple[bytes, List[int]]]:
        """Exact point lookup of a prefix (bloom + per-run search)."""
        k = prefix_key(tokens)
        tag = self.lsm.get(k)
        if tag is None:
            return None
        return tag.rstrip(b"\x00"), self._pages.get(k, [])

    def retag(self, tokens: np.ndarray, tag: bytes) -> None:
        """e.g. demote hot->cold; an LSM update, GC'd at compaction."""
        k = prefix_key(tokens)
        self.lsm.put(k, tag[: self.cfg.tag_width])

    def evict_prefixes(self, tokens_list: Sequence[np.ndarray]) -> None:
        for t in tokens_list:
            k = prefix_key(t)
            self.lsm.delete(k)
            self._pages.pop(k, None)

    # ------------------------------------------------------------------ #
    def scan(self, pred: Predicate) -> np.ndarray:
        """Scheduler scan on compressed tags: which prefixes match?"""
        return self.lsm.filter(pred).keys

    def eviction_candidates(self, cold_prefix: bytes) -> List[List[int]]:
        """Page lists of every prefix currently tagged cold."""
        keys = self.scan(Predicate("prefix", cold_prefix))
        return [self._pages[k] for k in keys.tolist() if k in self._pages]

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "prefixes": len(self._pages),
            "index_disk_bytes": self.lsm.disk_bytes,
            "dict_bytes": self.lsm.dict_bytes,
        }
