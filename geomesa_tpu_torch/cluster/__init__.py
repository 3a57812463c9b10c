"""Partition-tolerant cluster serving: Z-sharded scatter-gather.

``ClusterDataStore`` fronts N shard groups that own disjoint z-prefix
ranges of the keyspace (the tablet-split shape of the reference, one
level up): writes route to the owning group, reads scatter to all
groups under per-leg deadlines/hedges/breakers and merge exactly.
``cluster://h1:p1,h2:p2`` opens the federation form over web servers.
"""

from .autoscale import RESHARD_AUTO, Autoscaler
from .coordinator import (CLUSTER_ALLOW_PARTIAL, CLUSTER_HEDGE_MS,
                          CLUSTER_LEG_DEADLINE_S, ClusterDataStore,
                          ClusterQueryResult, PartialCount,
                          ShardUnavailableError)
from .partition import PREFIX_BITS, ZPrefixPartitioner
from .reshard import (RESHARD_ENABLED, Resharder, ReshardError,
                      StaleTopologyError)

__all__ = ["ClusterDataStore", "ClusterQueryResult",
           "ShardUnavailableError", "PartialCount", "ZPrefixPartitioner",
           "PREFIX_BITS", "CLUSTER_LEG_DEADLINE_S", "CLUSTER_HEDGE_MS",
           "CLUSTER_ALLOW_PARTIAL", "Resharder", "ReshardError",
           "StaleTopologyError", "Autoscaler", "RESHARD_ENABLED",
           "RESHARD_AUTO"]
