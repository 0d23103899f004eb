"""The distributed layer: the sharding rules (``sharding``), the GPipe
schedule (``pipeline``), int8 error-feedback all-reduce
(``grad_compression``), and multi-host tier management (the cluster
coordinator over per-host sessions)."""

from . import sharding
from .coordinator import ClusterCoordinator, HostTierManager, ShardMigration

__all__ = ["sharding", "ClusterCoordinator", "HostTierManager",
           "ShardMigration"]
