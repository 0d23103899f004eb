"""Multi-host tier management: the cluster coordinator over per-host
sessions.  The reference package's sharding, pipeline and gradient
compression are still to be ported (ROADMAP.md, queue 1: "`distributed/`,
`launch/dryrun.py` and `roofline.py`")."""

from .coordinator import ClusterCoordinator, HostTierManager, ShardMigration

__all__ = ["ClusterCoordinator", "HostTierManager", "ShardMigration"]
