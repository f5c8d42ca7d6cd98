"""Multi-device detection and streamed advisory tables (the JAX
package's parallel/): the dp×db mesh with one kernel launch per cell
(mesh.py), the multi-process plumbing and ingest queue (multihost.py),
and graftstream (stream.py)."""

from .mesh import (Mesh, MeshDetector, QueryPartition, ShardedTable,
                   best_db_shards, device_slots, make_mesh,
                   mesh_from_devices, partition_queries, shard_arrays,
                   shard_table, sharded_csr_join, sharded_csr_join_compact,
                   sharded_shiftor_scan)
from .stream import (SliceCache, SlicePlan, StreamingDetector,
                     StreamOptions, clip_descriptors, hbm_budget_bytes,
                     merge_slice_bits, plan_slices, slice_bounds,
                     touched_slices)

__all__ = ["Mesh", "MeshDetector", "QueryPartition", "ShardedTable",
           "best_db_shards", "device_slots", "make_mesh",
           "mesh_from_devices", "partition_queries", "shard_arrays",
           "shard_table", "sharded_csr_join", "sharded_csr_join_compact",
           "sharded_shiftor_scan",
           "SliceCache", "SlicePlan", "StreamingDetector", "StreamOptions",
           "clip_descriptors", "hbm_budget_bytes", "merge_slice_bits",
           "plan_slices", "slice_bounds", "touched_slices"]
