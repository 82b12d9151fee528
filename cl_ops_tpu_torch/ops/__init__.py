"""Operator families: rng, sort, exec (query operators)."""

from cl_ops_tpu_torch.ops import exec, rng, sort  # noqa: F401

__all__ = ["exec", "rng", "sort"]
