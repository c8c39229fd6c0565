# The thread pool the maintenance scheduler runs its workers on.  The rest
# of the reference's shard package (router, sharded engine, rebalance)
# comes with scale-out.
from repro_torch.shard.executor import ShardExecutor

__all__ = ["ShardExecutor"]
