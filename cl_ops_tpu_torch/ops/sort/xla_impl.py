"""The vendor sorter, registered under the JAX package's name "xla".

Counterpart of `cl_ops_tpu/ops/sort/xla_impl.py`, which calls
`lax.sort(..., is_stable=True)`: a stable lexicographic sort of the limbs by
`torch.sort(stable=True)`, the payload carried along. One or two limbs sort
as one int64 composite that keeps their order; more limbs would sort
stably one at a time, the least significant first. It ports no Pallas
kernel (the JAX package has none here): it is the registry's known-good
baseline and a second oracle.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.ops.sort.abstract import SortImplDef, sort_impls


def stable_order(limbs) -> torch.Tensor:
    """The int64 permutation that sorts the limb rows stably."""
    if len(limbs) == 1:
        return torch.sort(limbs[0], stable=True).indices
    if len(limbs) == 2:
        # high * 2^32 + (low + 2^31): its signed order is the limbs' order
        key = (limbs[0].to(torch.int64) << 32) \
            + limbs[1].to(torch.int64) + (1 << 31)
        return torch.sort(key, stable=True).indices
    perm = torch.arange(limbs[0].numel(), device=limbs[0].device)
    for limb in reversed(limbs):
        perm = perm[torch.sort(limb[perm], stable=True).indices]
    return perm


def _make_xla(spec, options):
    def fn(limbs, payload):
        perm = stable_order(limbs)
        return (tuple(l[perm] for l in limbs),
                payload[perm] if payload is not None else None)
    return fn


sort_impls.register("xla")(lambda: SortImplDef(
    name="xla",
    in_place=False,
    make_limb_sorter=_make_xla,
    kernel_names=("torch_sort",),
    smem_usage=lambda kernel, numel, options, n_arrays: 0,
))
