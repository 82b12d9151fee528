"""Bit-exact hand-over of data between numpy and torch.

The state the two packages must agree on is the data itself, so tests hand
the same numpy arrays to both. Unsigned tensors cross as their signed twins
and are re-viewed (`.view()` is the one uint32/uint64 op every torch build
has). bfloat16 has no numpy dtype here: it crosses as uint16 bit patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize, signed_equivalent
from cl_ops_tpu_torch.utils.platform import default_device


def to_torch(array, device=None, dtype=None) -> torch.Tensor:
    """numpy array -> tensor on `device` (None = "cuda"), bit for bit.

    `dtype` reinterprets the bits as another type of the same width, e.g.
    uint16 bit patterns as torch.bfloat16.
    """
    a = np.ascontiguousarray(array)
    if not a.flags.writeable:  # torch tensors are always writable
        a = a.copy()
    if a.dtype.kind == "u":
        t = torch.from_numpy(a.view(f"i{a.dtype.itemsize}"))
        t = t.view(canonicalize(a.dtype))
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.view(canonicalize(dtype))
    return t.to(default_device(device))


def to_numpy(tensor: torch.Tensor, dtype=None) -> np.ndarray:
    """tensor -> host numpy array, bit for bit.

    bfloat16 comes back as uint16 bit patterns; `dtype` reinterprets the
    result as another numpy dtype of the same width (e.g. int32 limbs holding
    u32 bits as np.uint32).
    """
    t = tensor.detach()
    if t.dtype == torch.bfloat16:
        out = t.view(torch.int16).cpu().numpy().view(np.uint16)
    elif t.dtype in (torch.uint16, torch.uint32, torch.uint64):
        out = t.view(signed_equivalent(t.dtype)).cpu().numpy().view(
            f"u{t.dtype.itemsize}")
    else:
        out = t.cpu().numpy()
    return out if dtype is None else out.view(dtype)


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """uint16/32/64 tensors as their signed twins (same bits); others as
    they are. Gathers, selects and compares of bits run on this view."""
    if t.dtype in (torch.uint16, torch.uint32, torch.uint64):
        return t.view(signed_equivalent(t.dtype))
    return t


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for any dtype (unsigned ones are gathered as signed bits)."""
    return signed_view(x)[idx].view(x.dtype)


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """u32 bits (uint32 or int32 tensor) -> int64 values in [0, 2^32).

    uint32 tensors support no comparison or arithmetic on some torch builds,
    so predicates over u32 columns compare the widened values.
    """
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & 0xFFFFFFFF
