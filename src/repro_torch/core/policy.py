"""Compaction policy: the leveled policy the engine consults for triggers.

Port of the part of ``repro/core/policy.py`` that the leveled engine uses:
one sorted run per level with an L0 trigger at ``l0_limit`` runs.  The
tiered, lazy-leveled and hybrid policies, per-policy size ratios and the
online ``PolicyTuner`` are not ported yet (ROADMAP §1, policy).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    kind: str = "leveled"

    def __post_init__(self):
        if self.kind != "leveled":
            raise ValueError(f"compaction policy {self.kind!r} is not ported "
                             "yet (ROADMAP §1, policy)")

    def l0_trigger(self, l0_limit: int) -> int:
        """Compact L0 when ``len(L0) > trigger``."""
        return l0_limit

    def describe(self) -> str:
        return self.kind


def make_policy(cfg) -> CompactionPolicy:
    """Policy from an ``LSMConfig``."""
    return CompactionPolicy(kind=cfg.compaction_policy)


def run_depth(runs) -> int:
    """Max number of file key ranges covering any single key (interval
    max-overlap): the runs a reader must consult at one level."""
    spans = [(s.min_key, s.max_key) for s in runs if s.n]
    if not spans:
        return 0
    events = []
    for lo, hi in spans:
        events.append((lo, 0))       # open before close at the same key:
        events.append((hi, 1))       # touching ranges count as overlap
    events.sort()
    depth = best = 0
    for _, kind in events:
        depth += 1 if kind == 0 else -1
        best = max(best, depth)
    return best
