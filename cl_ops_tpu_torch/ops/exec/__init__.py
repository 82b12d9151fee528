"""Query-execution operators: filter and GROUP BY (join is not ported yet)."""

from cl_ops_tpu_torch.ops.exec.aggregate import (group_aggregate_cols,
                                                 group_aggregate_direct,
                                                 group_aggregate_prefix,
                                                 group_aggregate_sorted)
from cl_ops_tpu_torch.ops.exec.filter import count_where, filter_compact

__all__ = ["count_where", "filter_compact", "group_aggregate_cols",
           "group_aggregate_direct", "group_aggregate_prefix",
           "group_aggregate_sorted"]
