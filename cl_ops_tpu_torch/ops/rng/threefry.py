"""Threefry-2x32 counter-based PRNG in plain torch integer ops.

Counterpart of `cl_ops_tpu/ops/rng/threefry.py`: value =
threefry(key, (stream, counter)), 20 rounds (Salmon et al., "Parallel Random
Numbers: As Easy as 1, 2, 3", SC'11). The words are held as int32 tensors
carrying u32 bits: additions wrap mod 2^32 and XOR is sign-agnostic, and the
one logical right shift (in the rotation) is masked after the arithmetic
shift.
"""

from __future__ import annotations

import torch

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # key-schedule parity constant


def _i32(v: int) -> int:
    """Python int -> the signed int32 value with the same low 32 bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _u32_tensor(x, device=None) -> torch.Tensor:
    """Counter input -> int32 tensor of its u32 bits.

    Accepts python ints, uint32/int32 tensors (bits as they are) and wider
    integer tensors (low 32 bits).
    """
    if not isinstance(x, torch.Tensor):
        return torch.tensor(_i32(int(x)), dtype=torch.int32, device=device)
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype == torch.int32:
        return x
    return x.to(torch.int64).to(torch.int32)  # keeps the low 32 bits


def _rotl32(x, r: int):
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(key0, key1, x0, x1):
    """20-round Threefry-2x32 block cipher.

    key0/key1 are python ints; x0/x1 tensors or ints (broadcastable). Returns
    (y0, y1) as int32 tensors of u32 bits.
    """
    dev = next((t.device for t in (x0, x1) if isinstance(t, torch.Tensor)),
               None)
    k0, k1 = int(key0) & 0xFFFFFFFF, int(key1) & 0xFFFFFFFF
    k2 = k0 ^ k1 ^ _PARITY
    x0 = _u32_tensor(x0, dev)
    x1 = _u32_tensor(x1, dev)
    x0, x1 = torch.broadcast_tensors(x0 + _i32(k0), x1 + _i32(k1))

    schedule = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
    for block, (ka, kb) in enumerate(schedule):
        rots = _ROTATIONS[:4] if block % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl32(x1, r) ^ x0
        x0 = x0 + _i32(ka)
        x1 = x1 + _i32(kb + block + 1)
    return x0, x1


def key_from_seed(seed: int) -> tuple[int, int]:
    """Derive a (k0, k1) u32 key pair from a 64-bit integer seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(seed: int, stream_ids, counters) -> torch.Tensor:
    """One u32 (as int32 bits) per (stream, counter) coordinate."""
    return random_bits_2x(seed, stream_ids, counters)[0]


def random_bits_2x(seed: int, stream_ids, counters):
    """Like random_bits but returns both 32-bit output words (y0, y1)."""
    k0, k1 = key_from_seed(seed)
    return threefry2x32(k0, k1, stream_ids, counters)
