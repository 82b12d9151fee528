"""Scalar type registry.

The 11 OpenCL scalar types of the reference's CloType table
(`src/cl_ops/common/clo_common.c:54-124`) plus bfloat16, each mapped to a
`torch.dtype` and, where numpy has one, a numpy dtype. Plain numpy has no
bfloat16, so on the numpy side bfloat16 travels as uint16 bit patterns (see
`cl_ops_tpu_torch.interop`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

DTypeLike = Union[str, np.dtype, type, torch.dtype]


@dataclasses.dataclass(frozen=True)
class TypeInfo:
    """One scalar type: OpenCL-style name, torch and numpy dtypes, size."""

    name: str                   # OpenCL-style name, e.g. "uint"
    dtype: torch.dtype          # canonical torch dtype
    np_dtype: Optional[np.dtype]  # None for bfloat16
    size: int                   # sizeof in bytes
    is_integer: bool
    is_signed: bool


def _ti(name: str, tdt: torch.dtype, np_dtype, signed: bool,
        integer: bool = True) -> TypeInfo:
    return TypeInfo(name=name, dtype=tdt,
                    np_dtype=None if np_dtype is None else np.dtype(np_dtype),
                    size=tdt.itemsize, is_integer=integer, is_signed=signed)


# Mirrors the 11-entry clo_type_info table (clo_common.c:54-68).
_TYPE_TABLE: tuple[TypeInfo, ...] = (
    _ti("char", torch.int8, np.int8, True),
    _ti("uchar", torch.uint8, np.uint8, False),
    _ti("short", torch.int16, np.int16, True),
    _ti("ushort", torch.uint16, np.uint16, False),
    _ti("int", torch.int32, np.int32, True),
    _ti("uint", torch.uint32, np.uint32, False),
    _ti("long", torch.int64, np.int64, True),
    _ti("ulong", torch.uint64, np.uint64, False),
    _ti("half", torch.float16, np.float16, True, integer=False),
    _ti("float", torch.float32, np.float32, True, integer=False),
    _ti("double", torch.float64, np.float64, True, integer=False),
)
_BFLOAT16 = _ti("bfloat16", torch.bfloat16, None, True, integer=False)

_BY_NAME = {t.name: t for t in _TYPE_TABLE + (_BFLOAT16,)}
_BY_TORCH = {t.dtype: t for t in _TYPE_TABLE + (_BFLOAT16,)}
_BY_NUMPY = {t.np_dtype: t for t in _TYPE_TABLE}


def all_type_names() -> list[str]:
    """Names of the 11 reference-parity scalar types (clo_common.c:54-68)."""
    return [t.name for t in _TYPE_TABLE]


def type_by_name(name: str) -> TypeInfo:
    """Name -> TypeInfo, like clo_type_by_name (clo_common.c:108-124)."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown type name {name!r}; known: {sorted(_BY_NAME)}") from None


def type_info(dt: DTypeLike) -> TypeInfo:
    """TypeInfo of a name, a torch dtype, or anything numpy calls a dtype."""
    if isinstance(dt, torch.dtype):
        info = _BY_TORCH.get(dt)
    elif isinstance(dt, str) and dt in _BY_NAME:
        info = _BY_NAME[dt]
    else:
        info = _BY_NUMPY.get(np.dtype(dt))
    if info is None:
        raise KeyError(f"dtype {dt} is not in the scalar type registry")
    return info


def canonicalize(dt: DTypeLike) -> torch.dtype:
    """Accept an OpenCL-style name, numpy dtype, python type or torch dtype
    and return the torch dtype."""
    return type_info(dt).dtype


def type_name(dt: DTypeLike) -> str:
    """dtype -> OpenCL-style name, like clo_type_get_name (clo_common.c:78-92)."""
    return type_info(dt).name


def type_sizeof(dt: DTypeLike) -> int:
    """dtype -> size in bytes, like clo_type_sizeof (clo_common.c:95-105)."""
    return type_info(dt).size


def default_sum_dtype(elem_dtype: DTypeLike) -> torch.dtype:
    """Widening rule for scan sums (elem type -> accumulator type).

    The reference lets the caller pick any sum type >= the elem type
    (clo_scan_bench defaults uint -> ulong); the default is the next wider
    type of the same kind, capped at 64 bits. float16/bfloat16 sum in
    float32; float32 and float64 keep their width.
    """
    t = type_info(elem_dtype)
    if not t.is_integer:
        return torch.float32 if t.size <= 2 else t.dtype
    width = min(t.size * 2, 8)
    return canonicalize(f"{'i' if t.is_signed else 'u'}{width}")


def signed_equivalent(dt: DTypeLike) -> torch.dtype:
    """Signed integer dtype of the same width, for `.view()` bit work."""
    return {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[type_sizeof(dt)]


def unsigned_equivalent(dt: DTypeLike) -> torch.dtype:
    """Unsigned integer dtype of the same width (for radix key bit tricks)."""
    return {1: torch.uint8, 2: torch.uint16, 4: torch.uint32,
            8: torch.uint64}[type_sizeof(dt)]
