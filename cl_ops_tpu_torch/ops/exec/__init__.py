"""Query-execution operators: filter, GROUP BY (sorted and dense), join,
window functions, top-k and DISTINCT."""

from cl_ops_tpu_torch.ops.exec.aggregate import (group_aggregate_cols,
                                                 group_aggregate_direct,
                                                 group_aggregate_prefix,
                                                 group_aggregate_sorted)
from cl_ops_tpu_torch.ops.exec.dense_agg import (DENSE_MAX_GROUPS,
                                                 group_aggregate_dense_cols)
from cl_ops_tpu_torch.ops.exec.filter import count_where, filter_compact
from cl_ops_tpu_torch.ops.exec.join import (hash_join, hash_join_expand,
                                            hash_u32)
from cl_ops_tpu_torch.ops.exec.topk import distinct, top_k
from cl_ops_tpu_torch.ops.exec.window import (WINDOW_AGGS, window_cols,
                                              window_scan)

__all__ = ["DENSE_MAX_GROUPS", "WINDOW_AGGS", "count_where", "distinct",
           "filter_compact", "group_aggregate_cols",
           "group_aggregate_dense_cols", "group_aggregate_direct",
           "group_aggregate_prefix", "group_aggregate_sorted", "hash_join",
           "hash_join_expand", "hash_u32", "top_k", "window_cols",
           "window_scan"]
