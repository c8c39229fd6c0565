# Range-sharded LSM-OPD engine: key router, scatter-gather scans over a
# pinned snapshot vector, shard-parallel execution, hot-shard splits.
from repro_torch.shard.executor import ShardExecutor
from repro_torch.shard.rebalance import (HotShardSplitter, RebalanceConfig,
                                         split_shard)
from repro_torch.shard.router import KEY_MAX, ShardRouter
from repro_torch.shard.sharded_lsm import ShardedLSM, ShardSnapshot

__all__ = [
    "KEY_MAX", "ShardRouter", "ShardExecutor", "ShardedLSM", "ShardSnapshot",
    "RebalanceConfig", "HotShardSplitter", "split_shard",
]
