"""RNG operator family: six reference-parity generators + counter-based Threefry.

Counterpart of `cl_ops_tpu/ops/rng` (the reference's rng module,
`src/cl_ops/rng/`):
  rng_new(...)          — clo_rng_new (clo_rng.c:262)
  Rng.next_int(n, w)    — clo_rng_next_int{,2,4,8} (clo_rng_api.cl:33-105)
  Rng.generate(k)       — batched stream generation (bench hot path)
  generator_names()     — the registry (clo_rng.c:60-68)
"""

from cl_ops_tpu_torch.ops.rng.generators import (GeneratorDef,
                                                 generator_names,
                                                 get_generator, generators)
from cl_ops_tpu_torch.ops.rng.hashes import apply_hash, knuth, xs1
from cl_ops_tpu_torch.ops.rng.rng import Rng, SeedType, rng_new
from cl_ops_tpu_torch.ops.rng.threefry import (key_from_seed, random_bits,
                                               random_bits_2x, threefry2x32)

__all__ = [
    "GeneratorDef", "Rng", "SeedType", "apply_hash", "generator_names",
    "generators", "get_generator", "key_from_seed", "knuth", "random_bits",
    "random_bits_2x", "rng_new", "threefry2x32", "xs1",
]
