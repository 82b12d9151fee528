"""Per-stream stateful generators with reference parity.

Counterpart of `cl_ops_tpu/ops/rng/generators.py`: the six generators of
the reference registry (`src/cl_ops/rng/clo_rng.c:60-68`: lcg, xorshift64,
xorshift128, mwc64x, parkmiller, tauslcg) plus counter-based Threefry, each
a function `step(states) -> (new_states, draws)` over the whole stream
array at once. The integer recurrences are reproduced exactly, so each
stream's sequence is bit-identical to the JAX package's given equal states.

State layouts (per stream), each clo_statetype, held in the signed torch
type of its width (`state_dtype` names the logical type):
  lcg         u64 scalar    (clo_rng_lcg.cl:30)          int64
  xorshift64  u64 scalar    (clo_rng_xorshift64.cl:28)   int64
  xorshift128 u32[4]        (clo_rng_xorshift128.cl:30)  int32
  mwc64x      u32[2]        (clo_rng_mwc64x.cl:28)       int32
  parkmiller  i32 scalar    (clo_rng_parkmiller.cl:30)   int32
  tauslcg     u32[4]        (clo_rng_tauslcg.cl:33)      int32
  threefry    u32[2]        (stream id, draw counter)    int32

Draws are int32 tensors of u32 bits. Within a step, u32 words are worked
on as int64 values in [0, 2^32), masked after every `<<` and `*`; u64
products go through `utils/intmath.py`, so no int64 operation overflows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from cl_ops_tpu_torch.core.registry import Registry
from cl_ops_tpu_torch.interop import widen_u32
from cl_ops_tpu_torch.ops.rng import threefry as tf3
from cl_ops_tpu_torch.utils import intmath

M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GeneratorDef:
    """One generator: state layout + seed conversion + step function.

    The analog of the reference's `CloRngInfo` registry entry
    (`src/cl_ops/rng/clo_rng.c:49-68`): {name, kernel source, seed size}.
    """

    name: str
    state_dtype: np.dtype  # logical type; tensors hold its bits signed
    state_words: int  # trailing state dim per stream; 0 => scalar state
    # seed_from_u64(u64 bits in int64[n]) -> states tensor of state_shape(n)
    seed_from_u64: Callable[[torch.Tensor], torch.Tensor]
    # step(states) -> (new_states, int32 draws[n] of u32 bits)
    step: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
    # optional batch(states, draws) -> (new_states, int32[draws, n]); only
    # counter-based generators can produce all draws in one pass
    batch: Callable | None = None

    def state_shape(self, n_streams: int) -> tuple[int, ...]:
        if self.state_words == 0:
            return (n_streams,)
        return (n_streams, self.state_words)

    @property
    def storage_dtype(self) -> torch.dtype:
        """The torch type the states are held in."""
        return {4: torch.int32, 8: torch.int64}[self.state_dtype.itemsize]

    @property
    def seed_bytes(self) -> int:
        """Per-stream state size in bytes (parity: clo_rng_get_size)."""
        return max(self.state_words, 1) * np.dtype(self.state_dtype).itemsize


generators: Registry[GeneratorDef] = Registry("rng generator")


def _i32(x64: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 values as int32 bits."""
    return intmath.astype(x64, torch.int32)


def _words(states: torch.Tensor) -> list[torch.Tensor]:
    """The u32 words of (n, k) int32 states as int64 values."""
    return [widen_u32(states[..., i]) for i in range(states.shape[-1])]


def _stack32(words) -> torch.Tensor:
    return torch.stack([_i32(w) if w.dtype == torch.int64 else w
                        for w in words], dim=-1)


# --- lcg: Knuth/Java 48-bit LCG (clo_rng_lcg.cl:43-59) ----------------------

def _lcg_step(states):
    s = (intmath.mul48(states, 0x5DEECE66D) + 0xB) & ((1 << 48) - 1)
    return s, _i32(s >> 16)


def _identity_u64_seed(seeds):
    return seeds


generators.register("lcg")(lambda: GeneratorDef(
    "lcg", np.dtype(np.uint64), 0, _identity_u64_seed, _lcg_step))


# --- xorshift64 (clo_rng_xorshift64.cl:43-63) -------------------------------

def _xs64_step(states):
    s = states
    s = s ^ (s << 21)
    s = s ^ intmath.shr64(s, 35)
    s = s ^ (s << 4)
    return s, _i32(s)  # low 32 bits, like convert_uint


generators.register("xorshift64")(lambda: GeneratorDef(
    "xorshift64", np.dtype(np.uint64), 0, _identity_u64_seed, _xs64_step))


# --- xorshift128 (clo_rng_xorshift128.cl:42-59) -----------------------------

def _xs128_seed(seeds):
    # clo_ulong2statetype: (s, s>>16, s>>32, s>>46) each masked to 32 bits
    # (clo_rng_xorshift128.cl:32)
    return _stack32([seeds, intmath.shr64(seeds, 16),
                     intmath.shr64(seeds, 32), intmath.shr64(seeds, 46)])


def _xs128_step(states):
    x, _, _, w = _words(states)
    t = x ^ ((x << 11) & M32)
    w_new = _i32(w ^ (w >> 19) ^ (t ^ (t >> 8)))
    return torch.cat([states[:, 1:], w_new[:, None]], dim=1), w_new


generators.register("xorshift128")(lambda: GeneratorDef(
    "xorshift128", np.dtype(np.uint32), 4, _xs128_seed, _xs128_step))


# --- mwc64x: Thomas' multiply-with-carry (clo_rng_mwc64x.cl:42-62) ----------

_MWC_A = 4294883355


def _lo_hi(seeds):
    return seeds & M32, intmath.shr64(seeds, 32)


def _mwc_seed(seeds):
    # as_uint2(ulong) on a little-endian device: x = low word, c = high word.
    return _stack32(_lo_hi(seeds))


def _mwc_step(states):
    x, c = _words(states)
    res = _i32(x ^ c)
    hi, lo = intmath.mul32_wide(x, _MWC_A)
    x_new = (lo + c) & M32  # wrapping u32 mul-add
    c_new = (hi + (x_new < c).to(torch.int64)) & M32
    return _stack32([x_new, c_new]), res


generators.register("mwc64x")(lambda: GeneratorDef(
    "mwc64x", np.dtype(np.uint32), 2, _mwc_seed, _mwc_step))


# --- parkmiller: minimal standard (clo_rng_parkmiller.cl:43-59) -------------

def _pm_seed(seeds):
    return _i32(seeds)  # as_int of the low 32 bits


def _pm_step(states):
    # torch.fmod is C's truncated remainder, OpenCL's % on negative states
    # (torch.remainder is floored and diverges there).
    s = torch.fmod(states.to(torch.int64) * 16807, 2147483647)
    # Return shifts a bit into the sign position (clo_rng_parkmiller.cl:57).
    return s.to(torch.int32), _i32((s & M32) << 1)


generators.register("parkmiller")(lambda: GeneratorDef(
    "parkmiller", np.dtype(np.int32), 0, _pm_seed, _pm_step))


# --- tauslcg: combined Tausworthe + LCG, GPU Gems 3 ch.37 with sub-stream
# skipping (clo_rng_tauslcg.cl:51-100) ---------------------------------------

def _taus_step(z, s1, s2, s3, m):
    b = (((z << s1) & M32) ^ z) >> s2
    return (((z & m) << s3) & M32) ^ b


def _tauslcg_seed(seeds):
    lo, hi = _lo_hi(seeds)
    # as_uint4((ulong2)(seed, seed)) little-endian -> (lo, hi, lo, hi)
    return _stack32([lo, hi, lo, hi])


def _tauslcg_step(states):
    x, y, z, w = _words(states)
    nx = _taus_step(y, 13, 19, 12, 4294967294)
    ny = _taus_step(z, 2, 25, 4, 4294967288)
    nz = _taus_step(w, 3, 11, 17, 4294967294)
    nw = (1664525 * x + 1013904223) & M32
    new = _stack32([nx, ny, nz, nw])
    return new, new[:, 0]


generators.register("tauslcg")(lambda: GeneratorDef(
    "tauslcg", np.dtype(np.uint32), 4, _tauslcg_seed, _tauslcg_step))


# --- threefry: counter-based flagship (see threefry.py) ---------------------

def _threefry_seed(seeds):
    # State = (stream word, counter). The stream word folds in the full seed.
    lo, hi = _lo_hi(seeds)
    return _stack32([lo ^ hi, torch.zeros_like(lo)])


def _threefry_step(states):
    stream, counter = states[:, 0], states[:, 1]
    val = tf3.random_bits(0, stream, counter)
    return _stack32([stream, widen_u32(counter) + 1]), val


def _threefry_batch(states, draws: int):
    """All draws at once: vals[d, s] = threefry(stream_s, counter_s + d),
    counters mod 2^32, one pass over the (draws, streams) grid where the
    stateful generators need `draws` dependent steps."""
    stream, counter = states[:, 0], widen_u32(states[:, 1])
    d = torch.arange(draws, dtype=torch.int64, device=states.device)
    vals = tf3.random_bits(0, stream[None, :],
                           _i32(counter[None, :] + d[:, None]))
    return _stack32([stream, counter + draws]), vals


generators.register("threefry")(lambda: GeneratorDef(
    "threefry", np.dtype(np.uint32), 2, _threefry_seed, _threefry_step,
    batch=_threefry_batch))


def generator_names() -> list[str]:
    return generators.names()


def get_generator(name: str) -> GeneratorDef:
    return generators.get(name)()
