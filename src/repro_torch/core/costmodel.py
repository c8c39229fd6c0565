"""Analytic cost model from paper §4.2 (Table 1 terms + inequality I1).

Port of ``repro/core/costmodel.py``, whole: pure Python, kept as the
port's own copy so that nothing here imports the reference package.  The
closed-form compaction / filter CPU+I/O costs for the three designs the
paper analyzes (no compression, heavy compression, LSM-OPD), the
aggregate costs, the per-policy closed forms ``PolicyTuner`` scores
candidates with (``policy_levels`` .. ``policy_cost``), and inequality
I1:

    D_i log2 D_i  <  (F / S_V) * (S_V - S_O) / (S_K + S_O)

below which LSM-OPD compactions are strictly cheaper than uncompressed
compactions.  Paper example: F=32MB, S_V=64, S_K=16, S_O=4 gives a border
around D_i ~ 9e4 (NDV/file ~ 5%).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Table 1. Costs are per-byte (IPB = instructions per byte, relative)."""

    N: int = 2**24          # total inserted KV pairs
    F: int = 32 * 2**20     # file size (bytes)
    T: int = 10             # size ratio
    S_K: int = 16           # key bytes
    S_V: int = 64           # uncompressed value bytes
    S_O: int = 4            # OPD-encoded value bytes
    D_i: int = 10**5        # distinct values per file
    C_K: float = 1.0        # merge-sort cost of keys
    C_C: float = 0.3        # copy cost
    C_E: float = 50.0       # heavy compress
    C_D: float = 20.0       # heavy decompress
    C_S: float = 1.0        # string comparison
    r: float = 0.01         # filter selectivity
    S_I: int = 512          # SIMD width (bytes)

    # ---------------- derived tree shape (Figure 4 effect) --------------- #
    def n_files(self, record_bytes: float) -> int:
        return max(1, math.ceil(self.N * record_bytes / self.F))

    def levels_of(self, m: int) -> float:
        """sum_i l_i for m files under leveling with ratio T (paper's
        l_i = ceil(log_T(i(T-1)+1)) closed form)."""
        return sum(math.ceil(math.log(i * (self.T - 1) + 1, self.T)) for i in range(1, m + 1))

    @property
    def m_plain(self) -> int:
        return self.n_files(self.S_K + self.S_V)

    @property
    def m_heavy(self) -> int:
        return self.n_files((self.S_K + self.S_V) * 0.5)

    @property
    def m_opd(self) -> int:
        return self.n_files(self.S_K + self.S_O)


def compaction_io(p: CostParams) -> Dict[str, float]:
    """C_IO = sum_i F * l_i * T (total compaction I/O per design)."""
    return {
        "plain": p.F * p.levels_of(p.m_plain) * p.T,
        "heavy": p.F * p.levels_of(p.m_heavy) * p.T,
        "opd": p.F * p.levels_of(p.m_opd) * p.T,
    }


def compaction_cpu(p: CostParams) -> Dict[str, float]:
    """The three C_CPU expressions of §4.2.1 (same notation)."""
    per_file_keys = (p.N / p.m_plain) * p.S_K * p.C_K
    plain = (per_file_keys + p.F * p.C_C) * p.levels_of(p.m_plain) * p.T

    per_file_keys_h = (p.N / p.m_heavy) * p.S_K * p.C_K
    heavy = (per_file_keys_h + p.F * (p.C_C + p.C_D + p.C_E)) * p.levels_of(p.m_heavy) * p.T

    per_file_keys_o = (p.N / p.m_opd) * p.S_K * p.C_K
    dict_term = p.S_V * p.C_S * p.D_i * math.log2(max(p.D_i, 2))
    opd = (per_file_keys_o + p.F * p.C_C + dict_term) * p.levels_of(p.m_opd) * p.T
    return {"plain": plain, "heavy": heavy, "opd": opd}


def filter_io(p: CostParams) -> Dict[str, float]:
    return {
        "plain": p.m_plain * p.F,
        "heavy": p.m_heavy * p.F,
        "opd": p.m_opd * p.F,
    }


def filter_cpu(p: CostParams) -> Dict[str, float]:
    """The three filter C_CPU expressions of §4.2.2."""
    shared = p.r * p.N * (p.S_K * p.C_K + (p.S_K + p.S_V) * p.C_C)
    plain = p.N * p.S_V * p.C_S + shared
    heavy = p.m_heavy * p.F * p.C_D + p.N * p.S_V * p.C_S + shared
    dict_lookup = sum(
        math.log2(max(p.D_i, 2)) * p.S_V * p.C_S for _ in range(p.m_opd)
    )
    simd = p.N * p.S_O * p.C_S / p.S_I
    opd = dict_lookup + simd + shared
    return {"plain": plain, "heavy": heavy, "opd": opd}


def aggregate_cpu(p: CostParams) -> Dict[str, float]:
    """Analytics-scan CPU (§4.2.2 structure applied to aggregation):
    codes-scanned vs values-decoded work for one full-column aggregate
    (count / min / max / group-by histogram).

    plain  touches every value byte once (N * S_V * C_S) — aggregation
           is a comparison-per-byte scan over decoded values.
    heavy  decompresses every file first (m * F * C_D), then plain.
    opd    scans packed CODES (N * S_O / S_I with SIMD) and folds per
           dictionary, not per row: each file contributes D_i * S_V
           dictionary-table work (weight/label gather) and the fold
           itself — no per-row value decode ever happens.
    """
    plain = p.N * p.S_V * p.C_S  # aggregation emits scalars, no row copy
    heavy = p.m_heavy * p.F * p.C_D + plain
    dict_term = p.m_opd * p.D_i * p.S_V * p.C_S
    opd = p.N * p.S_O * p.C_S / p.S_I + dict_term
    return {"plain": plain, "heavy": heavy, "opd": opd}


def aggregate_io(p: CostParams, zone_skip: float = 0.0) -> Dict[str, float]:
    """Bytes a full-column aggregate must read.  plain/heavy read every
    stored value byte; OPD reads the packed code column plus each file's
    dictionary, and the zone-map tile short-circuit skips a further
    ``zone_skip`` fraction of the code bytes (tiles answered in closed
    form from their zone are never fetched)."""
    assert 0.0 <= zone_skip <= 1.0
    plain = float(p.N * p.S_V)
    heavy = plain * 0.5  # the model's heavy codec halves stored bytes
    codes = p.N * p.S_O * (1.0 - zone_skip)
    dicts = p.m_opd * p.D_i * p.S_V
    return {"plain": plain, "heavy": heavy, "opd": float(codes + dicts)}


# --------------------------------------------------------------------------- #
# per-policy closed forms (Sarkar et al. design space; docs/DESIGN.md §12)
# --------------------------------------------------------------------------- #
def policy_levels(p: CostParams, T: Optional[int] = None,
                  record_bytes: Optional[float] = None) -> int:
    """Tree depth L for N records under size ratio T (both policies fill
    the same total bytes; tiering just holds them as K runs/level)."""
    T = T if T is not None else p.T
    rec = record_bytes if record_bytes is not None else (p.S_K + p.S_O)
    data = max(1.0, p.N * rec / p.F)
    return max(1, math.ceil(math.log(data, max(2, T))))


def policy_write_amp(policy: str, T: int, K: int, L: int,
                     level_modes=None) -> float:
    """Times each ingested byte is rewritten by compaction (per Sarkar et
    al. / Dostoevsky): leveling rewrites a level's resident data ~T times
    before it overflows, tiering once per level, lazy-leveling pays the
    leveled price only at the bottom."""
    if policy == "leveled":
        return float(T) * L
    if policy == "tiered":
        return float(L)
    if policy == "lazy_leveled":
        return float(L - 1) + T
    if policy == "hybrid":
        modes = level_modes or ()
        amp = 0.0
        for i in range(L):
            m = modes[min(i, len(modes) - 1)] if modes else "L"
            amp += float(T) if m == "L" else 1.0
        return amp
    raise ValueError(policy)


def policy_read_runs(policy: str, T: int, K: int, L: int,
                     level_modes=None) -> float:
    """Sorted runs a scan must consult: 1/level under leveling, up to K
    under tiering (lazy-leveling: K per upper level + 1 at the bottom)."""
    if policy == "leveled":
        return float(L)
    if policy == "tiered":
        return float(K) * L
    if policy == "lazy_leveled":
        return float(K) * max(0, L - 1) + 1
    if policy == "hybrid":
        modes = level_modes or ()
        runs = 0.0
        for i in range(L):
            m = modes[min(i, len(modes) - 1)] if modes else "L"
            runs += 1.0 if m == "L" else float(K)
        return runs
    raise ValueError(policy)


def policy_compaction_io(p: CostParams, policy: str,
                         T: Optional[int] = None, K: Optional[int] = None,
                         level_modes=None) -> float:
    """Total compaction bytes for ingesting N records under (policy, T,
    K): ingested bytes x write amplification (read+write charged once,
    matching ``compaction_io``'s leveled structure)."""
    T = T if T is not None else p.T
    K = K if K is not None else 4
    L = policy_levels(p, T)
    return p.N * (p.S_K + p.S_O) * policy_write_amp(
        policy, T, K, L, level_modes)


def policy_compaction_cpu(p: CostParams, policy: str,
                          T: Optional[int] = None, K: Optional[int] = None,
                          level_modes=None) -> float:
    """Merge CPU: key merge-sort + dictionary rebuild per rewrite pass
    (the §4.2.1 OPD expression with the leveled ``levels_of * T`` factor
    replaced by the policy's write amplification)."""
    T = T if T is not None else p.T
    K = K if K is not None else 4
    L = policy_levels(p, T)
    amp = policy_write_amp(policy, T, K, L, level_modes)
    per_byte = p.S_K * p.C_K / max(1, p.S_K + p.S_O)
    dict_term = p.S_V * p.C_S * p.D_i * math.log2(max(p.D_i, 2)) \
        * (amp * p.N * (p.S_K + p.S_O) / p.F) / max(1, p.m_opd)
    return p.N * (p.S_K + p.S_O) * amp * (per_byte + p.C_C) + dict_term


def policy_scan_io(p: CostParams, policy: str,
                   T: Optional[int] = None, K: Optional[int] = None,
                   zone_skip: float = 0.0, level_modes=None) -> float:
    """Bytes one full scan reads under (policy, T, K): every run costs
    its code column (zone short-circuits skip ``zone_skip`` of it) plus
    a per-run dictionary + seek overhead — more runs, more overhead."""
    T = T if T is not None else p.T
    K = K if K is not None else 4
    L = policy_levels(p, T)
    runs = policy_read_runs(policy, T, K, L, level_modes)
    codes = p.N * p.S_O * (1.0 - zone_skip)
    per_run = p.D_i * p.S_V + p.F * 0.01  # dict + fixed per-run overhead
    return codes + runs * per_run


def policy_cost(p: CostParams, policy: str, T: Optional[int] = None,
                K: Optional[int] = None, *, w_write: float,
                w_scan: float, zone_skip: float = 0.0,
                level_modes=None) -> float:
    """Combined workload cost for the tuner: write work weighted by the
    observed ingest volume + scan work weighted by the observed scan op
    count.  Normalized per unit of each weight so the mix (not the
    absolute traffic) decides the ranking."""
    ingested = max(1.0, p.N * (p.S_K + p.S_O))
    write_unit = (policy_compaction_io(p, policy, T, K, level_modes)
                  + policy_compaction_cpu(p, policy, T, K, level_modes)) \
        / ingested
    scan_unit = policy_scan_io(p, policy, T, K, zone_skip, level_modes)
    return w_write * write_unit + w_scan * scan_unit


def inequality_I1_border(p: CostParams) -> float:
    """Largest D_i * log2(D_i) for which OPD compaction beats plain."""
    return (p.F / p.S_V) * (p.S_V - p.S_O) / (p.S_K + p.S_O)


def inequality_I1_holds(p: CostParams) -> bool:
    return p.D_i * math.log2(max(p.D_i, 2)) < inequality_I1_border(p)


def border_ndv(p: CostParams) -> int:
    """Solve D log2 D = border numerically for the critical NDV/file."""
    lo, hi = 2, 2**40
    target = inequality_I1_border(p)
    while lo < hi:
        mid = (lo + hi) // 2
        if mid * math.log2(mid) < target:
            lo = mid + 1
        else:
            hi = mid
    return lo
