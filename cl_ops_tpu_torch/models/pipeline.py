"""Flagship end-to-end pipelines (the framework's "models").

Counterpart of `cl_ops_tpu/models/pipeline.py`: generate_table and
sort_pipeline (Threefry-generate keys -> sort -> sortedness check). The
pipelines that need GROUP BY or join come with those operators.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.interop import widen_u32
from cl_ops_tpu_torch.ops.rng import threefry
from cl_ops_tpu_torch.utils.platform import default_device


def _mod_u32(bits: torch.Tensor, m: int) -> torch.Tensor:
    """(u32 bits % m) as a uint32 tensor."""
    return (widen_u32(bits) % m).to(torch.int32).view(torch.uint32)


def generate_table(n: int, seed: int = 0, key_space: int = 1 << 20,
                   value_space: int = 1 << 10, device=None):
    """Threefry-generated (keys, values) uint32 fact table on `device`
    (None = "cuda")."""
    ids = torch.arange(n, dtype=torch.int32,
                       device=default_device(device))
    keys = _mod_u32(threefry.random_bits(seed, ids, 0), key_space)
    values = _mod_u32(threefry.random_bits(seed, ids, 1), value_space)
    return keys, values


def sort_pipeline(n: int, seed: int = 0, device=None):
    """Generate n random keys, sort them with abitonic, return
    (sorted keys, is_sorted) with is_sorted a 0-d bool tensor."""
    from cl_ops_tpu_torch.ops.sort import sort_new
    keys, _ = generate_table(n, seed, device=device)
    sorted_keys = sort_new("abitonic").sort_with_device_data(keys)
    w = widen_u32(sorted_keys)
    return sorted_keys, torch.all(w[1:] >= w[:-1])
