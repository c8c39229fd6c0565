"""Pluggable compaction policies and online per-tree policy tuning.

Port of ``repro/core/policy.py``.  Compaction is four decisions (trigger,
victim, granularity, layout; Sarkar et al., PAPERS.md), and the policy
makes them a configuration axis of the engine:

  ``leveled``       one sorted run per level; a level past its byte
                    capacity sheds one victim file into the overlapping
                    files below (the engine's default).
  ``tiered``        up to K overlapping sorted runs per level; on reaching
                    K the whole level is merged K-way into ONE new run
                    stacked on the level below.  Write amplification drops
                    from ~T*L to ~L, a scan reads up to K*L runs.
  ``lazy_leveled``  tiering in the upper levels, leveling at the two
                    deepest (Dostoevsky's middle point).
  ``hybrid``        an explicit per-level 'L'/'T' choice vector.

The engine consults the policy through four hooks (``LSMTree``): the
per-level *mode*, the L0 *trigger*, the byte *capacity* (a policy may
override the size ratio T, so the tuner varies it per tree without
touching the frozen ``LSMConfig``) and the K of tiered levels.  No answer
depends on the policy: the filter, aggregate and range paths merge by
(key, seqno) and a point lookup takes the newest visible version across
the candidate runs, so overlapping runs read correctly at any level.

``PolicyTuner`` fits write and scan weights from the tree's counters
(ingest bytes, scan operations, the zone short-circuit rate), scores the
neighbouring (policy, T, K) points with the port's ``costmodel`` and
hill-climbs with hysteresis between compaction rounds.  A switch only
changes what future compactions do: the next merges rewrite the tree
toward the new shape.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

POLICY_KINDS = ("leveled", "tiered", "lazy_leveled", "hybrid")

MODE_LEVELED = "L"
MODE_TIERED = "T"


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """An immutable policy value: swap the whole object to migrate.
    ``size_ratio=None`` takes the tree configuration's T."""

    kind: str = "leveled"
    size_ratio: Optional[int] = None    # None -> cfg.size_ratio
    tier_runs: int = 4                  # K (tiered levels)
    level_modes: Optional[Tuple[str, ...]] = None  # hybrid choice vector

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(f"unknown compaction policy {self.kind!r}")
        if self.kind == "hybrid" and not self.level_modes:
            raise ValueError("hybrid policy needs a level_modes vector")
        if self.level_modes is not None and any(
                m not in (MODE_LEVELED, MODE_TIERED)
                for m in self.level_modes):
            raise ValueError(f"bad level_modes {self.level_modes!r}")
        if self.tier_runs < 2:
            raise ValueError("tier_runs must be >= 2")

    def mode(self, level: int, max_levels: int) -> str:
        """'L' or 'T' for one level >= 1 (L0 always stacks flushes)."""
        if self.kind == "leveled":
            return MODE_LEVELED
        if self.kind == "tiered":
            return MODE_TIERED
        if self.kind == "lazy_leveled":
            # leveling at the cascade's last output level and its feeder
            return MODE_LEVELED if level >= max_levels - 2 else MODE_TIERED
        modes = self.level_modes
        return modes[min(level, len(modes) - 1)]

    def l0_trigger(self, l0_limit: int) -> int:
        """Compact L0 when ``len(L0) > trigger``: a tiered L0 triggers at K
        runs, never below the configured leveled limit."""
        if self.kind == "leveled":
            return l0_limit
        if self.kind == "hybrid" and self.level_modes[0] == MODE_LEVELED:
            return l0_limit
        return max(l0_limit, self.tier_runs - 1)

    def ratio(self, default: int) -> int:
        return self.size_ratio if self.size_ratio is not None else default

    def describe(self) -> str:
        t = f",T={self.size_ratio}" if self.size_ratio is not None else ""
        k = f",K={self.tier_runs}" if self.kind != "leveled" else ""
        v = f",{''.join(self.level_modes)}" if self.kind == "hybrid" else ""
        return f"{self.kind}{t}{k}{v}"


def make_policy(cfg) -> CompactionPolicy:
    """Policy from an ``LSMConfig`` (``compaction_policy``, ``tier_runs``,
    ``level_modes``); raises ``ValueError`` where ``CompactionPolicy``
    refuses them."""
    return CompactionPolicy(kind=cfg.compaction_policy,
                            tier_runs=cfg.tier_runs,
                            level_modes=cfg.level_modes)


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


# --------------------------------------------------------------------------- #
# online tuner: costmodel closed forms x the tree's counters -> hill-climb
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class TuneDecision:
    old: str
    new: str
    old_cost: float
    new_cost: float
    w_write: float
    w_scan: float


class PolicyTuner:
    """Per-tree online (policy, T, K) search, called between compaction
    rounds (the end of ``LSMTree.compact``; the background compaction
    worker once the debt is zero).  Each call:

      1. reads the workload deltas since the last retune: logical ingest
         bytes against scan operations (filters, aggregates, range merges,
         point lookups), and the zone short-circuit rate;
      2. returns None unless ``MIN_OPS`` worth of signal arrived;
      3. scores the current point and its hill-climb neighbours with
         ``costmodel.policy_cost`` under the fitted weights;
      4. adopts the best neighbour only if it undercuts the current point
         by the ``HYSTERESIS`` factor (no thrashing between near ties).

    The switch is ``tree.set_policy``: readers never pause.
    """

    T_CHOICES = (4, 6, 8, 10, 14)
    K_CHOICES = (2, 3, 4, 6, 8)
    KINDS = ("leveled", "tiered", "lazy_leveled")
    MIN_OPS = 64.0
    HYSTERESIS = 0.85

    def __init__(self):
        self.n_retunes = 0
        self.n_switches = 0
        self.history: List[TuneDecision] = []
        self._last_ingest = 0
        self._last_scans = 0

    def _scan_ops(self, tree) -> int:
        c = 0
        for st in (tree.filter_stats, tree.agg_stats, tree.lookup_stats):
            c += st.counts.get("merge", 0)
        c += tree.lookup_stats.counts.get("lookup", 0)  # point gets pay
        c += tree.agg_stats.counts.get("agg_fastpath_runs", 0)  # per run
        c += tree.agg_stats.counts.get("agg_fallback_runs", 0)
        return c

    def _zone_skip(self, tree) -> float:
        c = tree.agg_stats.counts
        sc = c.get("agg_tiles_shortcircuit", 0)
        ev = c.get("agg_tiles_evaluated", 0)
        return sc / max(1, sc + ev)

    def fit_weights(self, tree) -> Tuple[float, float]:
        """(w_write, w_scan) since the last retune: logical bytes ingested
        against scan operations served (only the mix ranks the points)."""
        ingest = tree.ingest_bytes - self._last_ingest
        scans = self._scan_ops(tree) - self._last_scans
        return float(max(0, ingest)), float(max(0, scans))

    def _commit_window(self, tree) -> None:
        self._last_ingest = tree.ingest_bytes
        self._last_scans = self._scan_ops(tree)

    def candidates(self, cur: CompactionPolicy,
                   default_T: int) -> List[CompactionPolicy]:
        """``cur``, every other kind at the current (T, K), and the current
        kind at the neighbouring T and K steps."""
        T = cur.ratio(default_T)
        K = cur.tier_runs
        out = [cur]
        for kind in self.KINDS:
            if kind != cur.kind:
                out.append(CompactionPolicy(kind=kind, size_ratio=T,
                                            tier_runs=K))
        ti = self._nearest(self.T_CHOICES, T)
        for j in (ti - 1, ti + 1):
            if 0 <= j < len(self.T_CHOICES) and self.T_CHOICES[j] != T:
                out.append(dataclasses.replace(
                    cur, size_ratio=self.T_CHOICES[j]))
        if cur.kind != "leveled":
            ki = self._nearest(self.K_CHOICES, K)
            for j in (ki - 1, ki + 1):
                if 0 <= j < len(self.K_CHOICES) and self.K_CHOICES[j] != K:
                    out.append(dataclasses.replace(
                        cur, tier_runs=self.K_CHOICES[j]))
        return out

    @staticmethod
    def _nearest(choices: Tuple[int, ...], v: int) -> int:
        return min(range(len(choices)), key=lambda i: abs(choices[i] - v))

    def maybe_retune(self, tree) -> Optional[TuneDecision]:
        """One tuning step; the decision when the window had enough signal
        (whether or not the policy switched), else None."""
        from repro_torch.core import costmodel as cm

        w_write, w_scan = self.fit_weights(tree)
        ops = w_write / max(1, tree.cfg.value_width + tree.cfg.key_bytes) \
            + w_scan
        if ops < self.MIN_OPS:
            return None
        self._commit_window(tree)
        self.n_retunes += 1
        zone_skip = self._zone_skip(tree)
        p = cm.CostParams(
            N=max(1024, tree.ingest_bytes
                  // max(1, tree.cfg.key_bytes + tree.cfg.value_width)),
            F=tree.cfg.file_bytes, S_K=tree.cfg.key_bytes,
            S_V=tree.cfg.value_width,
        )
        cur = tree.policy
        default_T = tree.cfg.size_ratio

        def score(pol: CompactionPolicy) -> float:
            return cm.policy_cost(
                p, pol.kind, T=pol.ratio(default_T), K=pol.tier_runs,
                w_write=w_write, w_scan=w_scan, zone_skip=zone_skip,
                level_modes=pol.level_modes)

        cur_cost = score(cur)
        best, best_cost = cur, cur_cost
        for cand in self.candidates(cur, default_T):
            c = score(cand)
            if c < best_cost:
                best, best_cost = cand, c
        decision = TuneDecision(cur.describe(), best.describe(),
                                cur_cost, best_cost, w_write, w_scan)
        if best != cur and best_cost < cur_cost * self.HYSTERESIS:
            tree.set_policy(best)
            self.n_switches += 1
        self.history.append(decision)
        return decision
