"""Query-execution operators: filter, GROUP BY and join."""

from cl_ops_tpu_torch.ops.exec.aggregate import (group_aggregate_cols,
                                                 group_aggregate_direct,
                                                 group_aggregate_prefix,
                                                 group_aggregate_sorted)
from cl_ops_tpu_torch.ops.exec.filter import count_where, filter_compact
from cl_ops_tpu_torch.ops.exec.join import (hash_join, hash_join_expand,
                                            hash_u32)

__all__ = ["count_where", "filter_compact", "group_aggregate_cols",
           "group_aggregate_direct", "group_aggregate_prefix",
           "group_aggregate_sorted", "hash_join", "hash_join_expand",
           "hash_u32"]
