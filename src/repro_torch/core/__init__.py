# The LSM-OPD engine on the card: OPD encoding, SCT layout with packed
# codes and zone maps, Algorithm-1 compaction and the fused zone filter,
# plus the version-set state layer, the group-commit WAL and the background
# maintenance scheduler.
from repro_torch.core.lsm import LSMConfig, LSMTree, Snapshot
from repro_torch.core.maintenance import (MaintenanceError,
                                          MaintenanceScheduler)
from repro_torch.core.opd import OPD, Predicate, as_fixed_bytes
from repro_torch.core.policy import CompactionPolicy, run_depth
from repro_torch.core.sct import (SCT, pack_width, sct_from_arrays,
                                  sct_to_arrays)
from repro_torch.core.stats import StageStats
from repro_torch.core.version import Version, VersionEdit, VersionSet
from repro_torch.core.wal import WALError, WALRecord, WALWriter

__all__ = [
    "LSMConfig", "LSMTree", "Snapshot", "MaintenanceError",
    "MaintenanceScheduler", "OPD", "Predicate", "as_fixed_bytes",
    "CompactionPolicy", "run_depth", "SCT", "pack_width", "sct_from_arrays",
    "sct_to_arrays", "StageStats", "Version", "VersionEdit", "VersionSet",
    "WALError", "WALRecord", "WALWriter",
]
