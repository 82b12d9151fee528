"""Seed-hash functions for device-side (DEV_GID) seeding.

Counterpart of `cl_ops_tpu/ops/rng/hashes.py` (the predefined hashes of the
reference's init kernel, `src/cl_ops/rng/clo_rng_init.cl:27-38`): KNUTH
(multiplicative, result masked to 32 bits) and XS1 (xor-shift-multiply),
plus identity when no hash is given. A caller may pass any Python callable
instead, taking and returning u64 bits in an int64 tensor.

u64 values are held as int64 bits; the wrapping products go through
`utils/intmath.py`, and right shifts are logical (`intmath.shr64`).
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils import intmath


def _u64_bits(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as u64 bits in int64 (unsigned narrower types
    zero-extend, signed ones sign-extend, as numpy's astype(uint64))."""
    return intmath.astype(x, torch.int64)


def knuth(x: torch.Tensor) -> torch.Tensor:
    """x = (x * 2654435761) % 2^32, computed in 64-bit like the OpenCL macro
    (only the low word of x reaches the result)."""
    return intmath.mul32_low(_u64_bits(x) & 0xFFFFFFFF, 2654435761)


def xs1(x: torch.Tensor) -> torch.Tensor:
    """Three xor-shift-multiply rounds on the full 64-bit value."""
    x = _u64_bits(x)
    x = intmath.mul64(intmath.shr64(x, 16) ^ x, 0x45D9F3B)
    x = intmath.mul64(intmath.shr64(x, 16) ^ x, 0x45D9F3B)
    return intmath.shr64(x, 16) ^ x


_HASHES = {None: lambda x: x, "": lambda x: x, "knuth": knuth, "xs1": xs1}


def apply_hash(name_or_fn: Union[str, Callable, None], seeds):
    if callable(name_or_fn):
        return name_or_fn(seeds)
    try:
        fn = _HASHES[name_or_fn]
    except KeyError:
        raise BadArgsError(
            f"unknown seed hash {name_or_fn!r}; known: knuth, xs1") from None
    return fn(seeds)
