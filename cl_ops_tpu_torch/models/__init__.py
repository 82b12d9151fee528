"""Flagship pipelines (the framework's "models")."""

from cl_ops_tpu_torch.models.pipeline import generate_table, sort_pipeline

__all__ = ["generate_table", "sort_pipeline"]
