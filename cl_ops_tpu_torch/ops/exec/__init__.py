"""Query-execution operators: filter (GROUP BY and join are not ported yet)."""

from cl_ops_tpu_torch.ops.exec.filter import count_where, filter_compact

__all__ = ["count_where", "filter_compact"]
