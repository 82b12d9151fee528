"""Random number generation: the Threefry-2x32 counter-based generator."""

from cl_ops_tpu_torch.ops.rng import threefry  # noqa: F401

__all__ = ["threefry"]
