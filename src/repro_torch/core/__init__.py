# The LSM-OPD engine on the card: OPD encoding, SCT layout with packed
# codes and zone maps, Algorithm-1 compaction and the fused zone filter.
from repro_torch.core.lsm import LSMConfig, LSMTree, Snapshot
from repro_torch.core.opd import OPD, Predicate, as_fixed_bytes
from repro_torch.core.policy import CompactionPolicy, run_depth
from repro_torch.core.sct import SCT, pack_width, sct_from_arrays
from repro_torch.core.stats import StageStats
from repro_torch.core.version import Version, VersionEdit, VersionSet

__all__ = [
    "LSMConfig", "LSMTree", "Snapshot", "OPD", "Predicate", "as_fixed_bytes",
    "CompactionPolicy", "run_depth", "SCT", "pack_width", "sct_from_arrays",
    "StageStats", "Version", "VersionEdit", "VersionSet",
]
