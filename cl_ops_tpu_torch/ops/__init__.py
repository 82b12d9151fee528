"""Operator families: rng, scan, sort, exec (query operators)."""

from cl_ops_tpu_torch.ops import exec, rng, scan, sort  # noqa: F401

__all__ = ["exec", "rng", "scan", "sort"]
