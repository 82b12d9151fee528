"""Flagship pipelines (the framework's "models")."""

from cl_ops_tpu_torch.models.pipeline import (analytics_query, generate_table,
                                              q1_query, rollup_query,
                                              sort_pipeline, star_query)

__all__ = ["analytics_query", "generate_table", "q1_query", "rollup_query",
           "sort_pipeline", "star_query"]
