"""Distribution layer: meshes of torch devices, sharded scans, the ring
joins and KNN.

The reference distributes scans across database tablet/region servers
and reduces partial aggregates client-side (SURVEY.md 2.5/2.6); here the
"servers" are shards on the mesh's devices, the "iterator stack" is a
kernel run on each shard, and the "client reduce" is a sum, min, max or
concatenation of the shards' results in shard order. Ring pipelines
(ring.py) cover the join/KNN shapes the reference runs on Spark
executors.
"""

from .mesh import (DistributedExtentData, DistributedScanData, data_mesh,
                   distributed_count, distributed_density,
                   distributed_histogram, distributed_minmax,
                   distributed_scan_mask, distributed_tristate,
                   exact_hit_rows, exact_host_mask, shard_extent_data,
                   shard_scan_data)
from .ring import (distributed_knn, ring_dwithin_counts, shard_points,
                   shard_points_split)

__all__ = ["DistributedExtentData", "DistributedScanData", "data_mesh",
           "distributed_count", "distributed_density",
           "distributed_histogram", "distributed_minmax",
           "distributed_scan_mask", "distributed_tristate",
           "exact_hit_rows", "exact_host_mask", "shard_extent_data",
           "shard_scan_data",
           "distributed_knn", "ring_dwithin_counts", "shard_points",
           "shard_points_split"]
