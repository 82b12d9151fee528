"""Integer arithmetic mod 2^bits with CPU-safe torch ops.

Signed overflow is undefined in the C++ under torch's integer kernels, and
this CPU build has no arithmetic on uint16/32/64. So sums that must wrap are
taken in int64 where they cannot overflow and then wrapped explicitly, and
64-bit sums are split into 32-bit halves whose partial sums cannot overflow.
Unsigned tensors are worked on as their signed views (same bits).
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.dtypes import signed_equivalent
from cl_ops_tpu_torch.interop import signed_view

_M32 = 0xFFFFFFFF


def is_unsigned(dtype: torch.dtype) -> bool:
    return dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def is_int(dtype: torch.dtype) -> bool:
    return dtype != torch.bool and not dtype.is_floating_point \
        and not dtype.is_complex


def _join64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 with high word hi mod 2^32 and low word lo (0 <= lo < 2^32)."""
    h = torch.remainder(hi + (1 << 31), 1 << 32) - (1 << 31)
    return h * (1 << 32) + lo  # in [-2^63, 2^63): no overflow


def wrap(x64: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values mod 2^bits of the integer `dtype`, as a `dtype` tensor."""
    bits = 8 * dtype.itemsize
    if bits == 64:
        return x64.view(dtype)
    h = 1 << (bits - 1)
    w = x64 & (2 * h - 1)
    w = torch.where(w >= h, w - 2 * h, w).to(signed_equivalent(dtype))
    return w.view(dtype) if is_unsigned(dtype) else w


def to_i64(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 with the value (unsigned narrower types zero-
    extend) or, for 64-bit types, the bits."""
    s = signed_view(x).to(torch.int64)
    if is_unsigned(x.dtype) and x.dtype.itemsize < 8:
        s = s & ((1 << (8 * x.dtype.itemsize)) - 1)
    return s


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer -> integer conversion mod 2^bits, as numpy's astype: widening
    sign- or zero-extends by the source's signedness, narrowing truncates."""
    if x.dtype == dtype:
        return x
    if x.dtype.itemsize == dtype.itemsize:  # same bits
        return signed_view(x).view(dtype)
    if x.dtype.itemsize < dtype.itemsize and not is_unsigned(x.dtype):
        return x.to(signed_equivalent(dtype)).view(dtype)  # in range
    return wrap(to_i64(x), dtype)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod 2^bits for two integer tensors of one dtype."""
    dt = a.dtype
    if dt.itemsize < 8:
        return wrap(to_i64(a) - to_i64(b), dt)
    sa, sb = signed_view(a), signed_view(b)
    lo = (sa & _M32) - (sb & _M32)
    hi = (sa >> 32) - (sb >> 32) + (lo >> 32)
    return _join64(hi, lo & _M32).view(dt)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod 2^bits for two integer tensors of one dtype."""
    dt = a.dtype
    if dt.itemsize < 8:
        return wrap(to_i64(a) + to_i64(b), dt)
    sa, sb = signed_view(a), signed_view(b)
    lo = (sa & _M32) + (sb & _M32)
    hi = (sa >> 32) + (sb >> 32) + (lo >> 32)
    return _join64(hi, lo & _M32).view(dt)


def row_sums(x: torch.Tensor) -> torch.Tensor:
    """Sums along dim 1 of a 2-D integer tensor mod 2^bits, in its dtype;
    rows must stay shorter than 2^31."""
    dt = x.dtype
    if dt.itemsize < 8:
        return wrap(to_i64(x).sum(1), dt)
    s = signed_view(x)
    lo = (s & _M32).sum(1)
    hi = (s >> 32).sum(1) + (lo >> 32)
    return _join64(hi, lo & _M32).view(dt)


def cumsum(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sums of a 1-D integer tensor mod 2^bits, in its dtype; n must
    stay below 2^31."""
    dt = x.dtype
    if dt.itemsize < 8:
        incl = wrap(torch.cumsum(to_i64(x), 0), dt)
    else:
        s = signed_view(x)
        lo = torch.cumsum(s & _M32, 0)
        hi = torch.cumsum(s >> 32, 0) + (lo >> 32)
        incl = _join64(hi, lo & _M32).view(dt)
    if not exclusive or x.numel() == 0:
        return incl
    zero = torch.zeros(1, dtype=signed_view(incl).dtype, device=x.device)
    return torch.cat([zero, signed_view(incl)[:-1]]).view(dt)


def full(n: int, value, dtype: torch.dtype, device) -> torch.Tensor:
    """A length-n tensor of `value` in `dtype`; unsigned values are stored
    through their signed bits."""
    if is_unsigned(dtype):
        bits = 8 * dtype.itemsize
        v = int(value) & ((1 << bits) - 1)
        v = v - (1 << bits) if v >= 1 << (bits - 1) else v
        return torch.full((n,), v, dtype=signed_equivalent(dtype),
                          device=device).view(dtype)
    return torch.full((n,), value, dtype=dtype, device=device)


def where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """torch.where for two tensors of one dtype, unsigned ones included."""
    return torch.where(mask, signed_view(a), signed_view(b)).view(a.dtype)


def int_limits(dtype: torch.dtype) -> tuple[int, int]:
    """(min, max) of an integer dtype."""
    bits = 8 * dtype.itemsize
    if is_unsigned(dtype):
        return 0, (1 << bits) - 1
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
