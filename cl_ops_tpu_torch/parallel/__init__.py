"""The distributed layer: row-partitioned tables over a mesh of devices.

Counterpart of `cl_ops_tpu/parallel/`: the mesh, the partition exchange,
the splitters, the scans and the sorts, and the operators built on them
(the hash join and its expansion, GROUP BY, window functions, top-k and
DISTINCT). A `Mesh` (`mesh.py`) is a tuple of torch devices driven from one
process, and a `Sharded` holds one tensor per position; every exchange
between positions goes through the mesh's collective methods, which copy.
`multiproc.py` gives a mesh across processes over torch.distributed, on
which every operator runs unchanged. Each position's work runs the port's
kernels: the fused bitonic sort, the band probe, scan_block, scan_carry
and seg_scan_carry.

Quick start (four shards of one card):
  from cl_ops_tpu_torch import parallel
  mesh = parallel.make_mesh(devices=["cuda:0"] * 4)
  out = parallel.dist_sort(np_keys, mesh).numpy()
  found, vals = parallel.dist_hash_join(dim_keys, dim_vals, fact_keys,
                                        mesh, capacity_build=...,
                                        capacity_probe=...)
"""

from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, make_mesh, replicated,
                                            row_sharding)
from cl_ops_tpu_torch.parallel.aggregate import (dist_group_aggregate,
                                                 dist_group_aggregate_cols)
from cl_ops_tpu_torch.parallel.join import (dist_hash_join,
                                            dist_hash_join_expand)
from cl_ops_tpu_torch.parallel.scan import dist_scan, dist_segmented_scan
from cl_ops_tpu_torch.parallel.shuffle import partition_exchange
from cl_ops_tpu_torch.parallel.sort import dist_sort, dist_sort_i32_cols
from cl_ops_tpu_torch.parallel.splitters import (dist_sort_sample,
                                                 keyed_exchange_once,
                                                 keyed_exchange_replan,
                                                 plan_splitters,
                                                 range_partition_exchange)
from cl_ops_tpu_torch.parallel.topk import dist_distinct, dist_top_k
from cl_ops_tpu_torch.parallel.window import (dist_window_cols,
                                              dist_window_scan)

__all__ = ["DATA_AXIS", "dist_distinct", "dist_group_aggregate",
           "dist_group_aggregate_cols", "dist_hash_join",
           "dist_hash_join_expand",
           "dist_scan", "dist_segmented_scan", "dist_sort",
           "dist_sort_i32_cols", "dist_sort_sample", "dist_top_k",
           "dist_window_cols", "dist_window_scan",
           "keyed_exchange_once", "keyed_exchange_replan", "make_mesh",
           "partition_exchange", "plan_splitters",
           "range_partition_exchange", "replicated", "row_sharding"]
