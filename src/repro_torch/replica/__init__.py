"""Shard replication: leader/follower WAL shipping, bounded-staleness
follower reads, and crash-safe failover.

Port of ``repro/replica``.  The WAL (``core.wal``) already frames every
acknowledged write as a seqno-ordered record stream; this package ships
that stream to follower trees which replay it through their own memtable,
flush and compaction, so a follower serves the same packed-code scan and
aggregate path on the card as the leader.
"""

from repro_torch.replica.link import (ReplicationLag, ReplicationLink,
                                      ReplicationLog, ResyncRequired)
from repro_torch.replica.replicated import (EPOCH_FILE, ReadPolicy,
                                            ReplicaSnapshot, ReplicatedShard)

__all__ = [
    "ReplicationLink",
    "ReplicationLog",
    "ReplicationLag",
    "ResyncRequired",
    "ReadPolicy",
    "ReplicaSnapshot",
    "ReplicatedShard",
    "EPOCH_FILE",
]
