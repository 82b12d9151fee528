"""Bit/worksize utilities.

Parity with the reference's bit tricks (`src/cl_ops/common/clo_common.c:141-199`)
and worksize macros (`clo_common.in.h:53-70`). These are host-side helpers used
when planning kernel grids; on tensors use torch ops.
"""

from __future__ import annotations


def nlpo2(x: int) -> int:
    """Next (largest) power of 2 >= x. Parity: clo_nlpo2 (clo_common.c:141-152).

    The reference returns nlpo2(0) == 1 via its OR-cascade on x-1; we keep that.
    """
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def ones32(x: int) -> int:
    """Population count of the low 32 bits. Parity: clo_ones32 (clo_common.c:162-173)."""
    return bin(x & 0xFFFFFFFF).count("1")


def tzc(x: int) -> int:
    """Trailing zero count (32-bit). Parity: clo_tzc (clo_common.c:183-186).

    Like the reference (ones32((x & -x) - 1)), tzc(0) == 32.
    """
    x &= 0xFFFFFFFF
    if x == 0:
        return 32
    return ((x & -x) - 1).bit_length()


def log2_floor(x: int) -> int:
    """floor(log2(x)) for x >= 1. Parity: clo_sum usage pattern / stage counts."""
    if x < 1:
        raise ValueError("log2_floor requires x >= 1")
    return x.bit_length() - 1


def sum_1_to_n(x: int) -> int:
    """Triangular sum 1+2+...+x. Parity: clo_sum (clo_common.c:196-199)."""
    return x * (x + 1) // 2


def cdiv(a: int, b: int) -> int:
    """Ceiling division. Parity: CLO_DIV_CEIL (clo_common.in.h:56)."""
    return -(-a // b)


def round_up(x: int, mult: int) -> int:
    """Round x up to a multiple of mult. Parity: CLO_GWS_MULT (clo_common.in.h:64)."""
    return cdiv(x, mult) * mult


def is_po2(x: int) -> bool:
    """Power-of-2 test. Parity: CLO_IS_PO2 (clo_common.in.h:70)."""
    return x > 0 and (x & (x - 1)) == 0
