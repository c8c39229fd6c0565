"""Per-stage timing, mirroring the paper's seven-stage breakdown.

Port of ``repro/core/stats.py``.  Stage seconds are host wall-clock
(``perf_counter``) around each stage; work the stage left queued on the
card is not waited for unless the stage itself synchronises.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator


class StageStats:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def total(self) -> float:
        return sum(self.seconds.values())

    def merged(self, other: "StageStats") -> "StageStats":
        return StageStats.merge_all((self, other))

    @staticmethod
    def merge_all(many: Iterable["StageStats"]) -> "StageStats":
        """Per-stage seconds and counts summed over components: the sharded
        engine's report, one stage row over every shard tree and every
        tree a split retired."""
        out = StageStats()
        for st in many:
            for k, v in st.seconds.items():
                out.seconds[k] += v
            for k, v in st.counts.items():
                out.counts[k] += v
        return out

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}={v * 1e3:.2f}ms"
                          for k, v in sorted(self.seconds.items()))
        return f"StageStats({parts})"
