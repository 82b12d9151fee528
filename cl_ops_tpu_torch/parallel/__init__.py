"""The distributed layer: row-partitioned tables over a mesh of devices.

Counterpart of `cl_ops_tpu/parallel/` (its first half: the mesh, the
partition exchange, the splitters, the scans and the sorts). A `Mesh`
(`mesh.py`) is a tuple of torch devices driven from one process, and a
`Sharded` holds one tensor per position; every exchange between positions
goes through the mesh's collective methods, which copy. Each position's
work runs the port's kernels: the fused bitonic sort, scan_block and
seg_scan_carry.

Quick start (four shards of one card):
  from cl_ops_tpu_torch import parallel
  mesh = parallel.make_mesh(devices=["cuda:0"] * 4)
  out = parallel.dist_sort(np_keys, mesh).numpy()
"""

from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, make_mesh, replicated,
                                            row_sharding)
from cl_ops_tpu_torch.parallel.scan import dist_scan, dist_segmented_scan
from cl_ops_tpu_torch.parallel.shuffle import partition_exchange
from cl_ops_tpu_torch.parallel.sort import dist_sort, dist_sort_i32_cols
from cl_ops_tpu_torch.parallel.splitters import (dist_sort_sample,
                                                 keyed_exchange_once,
                                                 keyed_exchange_replan,
                                                 plan_splitters,
                                                 range_partition_exchange)

__all__ = ["DATA_AXIS", "dist_scan", "dist_segmented_scan", "dist_sort",
           "dist_sort_i32_cols", "dist_sort_sample", "keyed_exchange_once",
           "keyed_exchange_replan", "make_mesh", "partition_exchange",
           "plan_splitters", "range_partition_exchange", "replicated",
           "row_sharding"]
