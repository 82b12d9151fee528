"""Order-preserving key normalization to signed-i32 limbs.

Counterpart of `cl_ops_tpu/ops/sort/keys.py`: every key dtype maps by an
order-preserving bijection onto one or two int32 limbs, most significant
first, so that signed lexicographic comparison of the limbs equals the key
dtype's natural order. The bit work runs on int32/int64 views, because some
torch builds have no arithmetic on uint32/uint64.

  unsigned ints -> sign bit flipped on every limb
  signed ints   -> high limb as is, low limb (64-bit) sign-flipped
  floats        -> negative: all bits but the sign flipped; else as is
                   (-inf < ... < -0 < +0 < ... < +inf < NaN)
  half/bfloat16 -> widened to float32 first (order-preserving)
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadDtypeError

_MIN32 = -(1 << 31)          # 0x80000000 as int32
_MIN64 = -(1 << 63)          # 0x8000000000000000 as int64
_LOW31 = 0x7FFFFFFF


def _split64(x64):
    """int64 -> (high, low) int32 words."""
    return (x64 >> 32).to(torch.int32), x64.to(torch.int32)


def _join64(hi, lo):
    """(high, low) int32 words -> int64."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def _f32_limb(u):
    """float32 bits (int32) -> ordered limb; the map is its own inverse."""
    return torch.where(u < 0, u ^ _LOW31, u)


def num_limbs(dtype) -> int:
    """1 for <=32-bit keys, 2 for 64-bit keys."""
    return 2 if canonicalize(dtype).itemsize == 8 else 1


def to_limbs(keys: torch.Tensor) -> list[torch.Tensor]:
    """Map keys to order-preserving int32 limbs (most-significant first)."""
    dt = canonicalize(keys.dtype)
    if dt in (torch.uint64, torch.int64):
        hi, lo = _split64(keys.view(torch.int64))
        return [hi ^ _MIN32 if dt == torch.uint64 else hi, lo ^ _MIN32]
    if dt == torch.uint32:
        return [keys.view(torch.int32) ^ _MIN32]
    if dt == torch.uint16:
        return [(keys.view(torch.int16).to(torch.int32) & 0xFFFF) ^ _MIN32]
    if dt == torch.uint8:
        return [keys.to(torch.int32) ^ _MIN32]
    if dt in (torch.int8, torch.int16, torch.int32):
        return [keys.to(torch.int32)]
    if dt == torch.float64:
        u = keys.view(torch.int64)
        hi, lo = _split64(torch.where(u < 0, ~u, u ^ _MIN64))
        return [hi ^ _MIN32, lo ^ _MIN32]
    if dt in (torch.float32, torch.float16, torch.bfloat16):
        return [_f32_limb(keys.to(torch.float32).view(torch.int32))]
    raise BadDtypeError(f"unsupported sort key dtype {dt}")


def from_limbs(limbs: list[torch.Tensor], dtype) -> torch.Tensor:
    """Inverse of to_limbs: recover keys of `dtype` from (reordered) limbs."""
    dt = canonicalize(dtype)
    if dt == torch.uint64:
        return _join64(limbs[0] ^ _MIN32, limbs[1] ^ _MIN32).view(dt)
    if dt == torch.int64:
        return _join64(limbs[0], limbs[1] ^ _MIN32)
    if dt == torch.uint32:
        return (limbs[0] ^ _MIN32).view(dt)
    if dt == torch.uint16:
        return (limbs[0] ^ _MIN32).to(torch.int16).view(dt)
    if dt in (torch.uint8, torch.int8, torch.int16, torch.int32):
        l = limbs[0] ^ _MIN32 if dt == torch.uint8 else limbs[0]
        return l.to(dt)
    if dt == torch.float64:
        o = _join64(limbs[0] ^ _MIN32, limbs[1] ^ _MIN32)
        return torch.where(o >= 0, ~o, o ^ _MIN64).view(dt)
    if dt == torch.bfloat16:
        # the float32 bits came from widening a bfloat16: their high half is
        # that bfloat16, NaN payloads included (a rounding conversion may
        # rewrite NaNs)
        return (_f32_limb(limbs[0]) >> 16).to(torch.int16).view(dt)
    if dt in (torch.float32, torch.float16):
        return _f32_limb(limbs[0]).view(torch.float32).to(dt)
    raise BadDtypeError(f"unsupported sort key dtype {dt}")


def sentinel_max_limbs(n_limbs: int) -> list[int]:
    """Limb values sorting AFTER every real key (for pow-2 padding)."""
    return [_LOW31] * n_limbs  # i32 max == the largest limb
