"""RNG objects: seeding strategies, stream state, and the draw API.

Counterpart of `cl_ops_tpu/ops/rng/rng.py` (the reference's CloRNG class,
`src/cl_ops/rng/clo_rng.c:262-446`): an Rng owns a state tensor and draws
from it. The four seeding strategies (`src/cl_ops/rng/clo_rng.in.h:78-92`):

  DEV_GID   — state[i] = ulong2state(hash(i + main_seed)), computed on the
              device (ref: clo_rng_init kernel, clo_rng_init.cl:46-60)
  HOST_MT   — numpy's MT19937 fills the raw state words on the host, as
              the JAX package does, so the states equal its bit for bit
  EXT_DEV   — caller passes an existing state tensor (validated)
  EXT_HOST  — caller passes a host array, copied to the device

Draw API parity (`src/cl_ops/rng/clo_rng_api.cl:33-105`): `next_int(n)` is a
modulo-range draw; vector widths 2/4/8 stride the state array by the number
of work-items exactly like GID2/GID4/GID8 (`clo_rng_workitem.cl:24-32`), so a
state buffer of w*g streams serves g work-items drawing w values each.
Draws come back as torch.uint32 views of their bits
(`interop.to_numpy` gives np.uint32).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.rng.generators import GeneratorDef, get_generator
from cl_ops_tpu_torch.ops.rng.hashes import apply_hash
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.platform import default_device


class SeedType(enum.Enum):
    """Parity with CloRngSeedType (clo_rng.in.h:78-92)."""

    DEV_GID = "dev_gid"
    HOST_MT = "host_mt"
    EXT_DEV = "ext_dev"
    EXT_HOST = "ext_host"


class Rng:
    """A named generator plus its stream state tensor.

    Draw methods rebind `self.states` to the advanced states.
    """

    def __init__(self, gen: GeneratorDef, states: torch.Tensor):
        self._gen = gen
        self.states = states

    # -- introspection (parity: clo_rng_get_size / get_device_seeds) --------
    @property
    def name(self) -> str:
        return self._gen.name

    @property
    def num_streams(self) -> int:
        return int(self.states.shape[0])

    @property
    def seed_bytes(self) -> int:
        """Per-stream state size in bytes (clo_rng_get_size, clo_rng.c:456)."""
        return self._gen.seed_bytes

    def get_source(self):
        """The generator's step function — the clo_rng_get_source analog
        (the reference hands out OpenCL C source, `clo_rng.c:431-446`): a
        callable states -> (new states, draws) to run on get_device_seeds."""
        return self._gen.step

    def get_device_seeds(self) -> torch.Tensor:
        """The live state tensor (clo_rng_get_device_seeds parity)."""
        return self.states

    # -- draws ---------------------------------------------------------------
    def next_raw(self) -> torch.Tensor:
        """Advance every stream once; return u32 draws, shape (num_streams,)."""
        self.states, vals = self._gen.step(self.states)
        return vals.view(torch.uint32)

    def next_int(self, n: int, width: int = 1) -> torch.Tensor:
        """Draw integers in [0, n) (clo_rng_next_int{,2,4,8}).

        With width w, the num_streams = w*g states are viewed as w stripes of
        g streams (GID striding, clo_rng_workitem.cl:24-32); returns shape
        (w, g) — row k holds work-item draws from stripe k. width=1 returns
        shape (num_streams,).
        """
        if width not in (1, 2, 4, 8):
            raise BadArgsError(f"width must be 1/2/4/8, got {width}")
        if self.num_streams % width:
            raise BadArgsError(
                f"num_streams {self.num_streams} not divisible by width {width}")
        vals = intmath.wrap(interop.widen_u32(self.next_raw()) % n,
                            torch.uint32)
        if width == 1:
            return vals
        return vals.reshape(width, self.num_streams // width)

    def generate(self, draws_per_stream: int) -> torch.Tensor:
        """Batch generation: (draws_per_stream, num_streams) u32 matrix.

        The analog of the reference bench's per-run kernel loop
        (`src/benchmarks/clo_rng_bench.c:302-324`): threefry computes every
        draw in one pass; the stateful generators step `draws_per_stream`
        times into one preallocated tensor.
        """
        gen = self._gen
        if gen.batch is not None:
            self.states, vals = gen.batch(self.states, draws_per_stream)
            return vals.view(torch.uint32)
        out = torch.empty((draws_per_stream, self.num_streams),
                          dtype=torch.int32, device=self.states.device)
        for d in range(draws_per_stream):
            self.states, out[d] = gen.step(self.states)
        return out.view(torch.uint32)


def rng_new(
    name: str,
    seed_type: SeedType | str = SeedType.DEV_GID,
    num_streams: int = 0,
    main_seed: int = 0,
    hash_name: Optional[str] = None,
    ext_states=None,
    *,
    device=None,
) -> Rng:
    """Create an Rng — the analog of clo_rng_new (clo_rng.c:262-380).

    Args:
      name: generator name (lcg, xorshift64, xorshift128, mwc64x, parkmiller,
        tauslcg, threefry).
      seed_type: one of SeedType (or its string value).
      num_streams: number of independent streams (ref: seeds_count).
      main_seed: base seed (DEV_GID: added to stream id; HOST_MT: MT seed).
      hash_name: for DEV_GID — None (identity), "knuth", "xs1"
        (clo_rng_init.cl:27-38 predefined hashes) or a callable on u64 bits
        in an int64 tensor.
      ext_states: for EXT_DEV/EXT_HOST — caller-provided states with shape
        gen.state_shape(num_streams) (validated like clo_rng.c:247-258).
        EXT_DEV keeps a tensor where it lies; EXT_HOST copies to `device`.
      device: where the states live (None = "cuda"; raises without CUDA).
    """
    gen = get_generator(name)
    if isinstance(seed_type, str):
        seed_type = SeedType(seed_type)

    if seed_type in (SeedType.EXT_DEV, SeedType.EXT_HOST):
        if ext_states is None:
            raise BadArgsError(f"{seed_type.value} seeding needs ext_states")
        want_shape = gen.state_shape(
            num_streams or int(np.shape(ext_states)[0]))
        if tuple(np.shape(ext_states)) != want_shape:
            raise BadArgsError(
                f"ext_states shape {tuple(np.shape(ext_states))} != expected "
                f"{want_shape} for generator {name!r}")
        if isinstance(ext_states, torch.Tensor):
            # values mod 2^bits, as numpy's astype
            states = intmath.astype(ext_states, gen.storage_dtype)
            if seed_type == SeedType.EXT_DEV:
                return Rng(gen, states)
            return Rng(gen, states.to(default_device(device), copy=True))
        host = np.asarray(ext_states).astype(gen.state_dtype)
        return Rng(gen, interop.to_torch(host, device).view(
            gen.storage_dtype))

    if num_streams <= 0:
        raise BadArgsError("num_streams must be positive")
    dev = default_device(device)

    if seed_type == SeedType.DEV_GID:
        # seed = gid + main_seed mod 2^64, hashed, then converted to the
        # state layout, all on the device (ref init kernel
        # clo_rng_init.cl:46-60).
        gids = torch.arange(num_streams, dtype=torch.int64, device=dev)
        base = torch.full_like(gids, intmath.i64(main_seed))
        seeds = apply_hash(hash_name, intmath.add(gids, base))
        return Rng(gen, gen.seed_from_u64(seeds))

    # HOST_MT: fill the raw state words from a host Mersenne Twister.
    words = max(gen.state_words, 1)
    word_bytes = gen.state_dtype.itemsize
    mt = np.random.RandomState(np.uint32(main_seed & 0xFFFFFFFF))
    raw = mt.randint(0, 2**32, size=num_streams * words * word_bytes // 4,
                     dtype=np.uint32)
    host = raw.view(gen.state_dtype).reshape(gen.state_shape(num_streams))
    return Rng(gen, interop.to_torch(host, dev).view(gen.storage_dtype))
