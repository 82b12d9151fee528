"""The "gselect" sorter: the O(n^2) rank-by-counting sort, in torch ops.

Counterpart of `cl_ops_tpu/ops/sort/gselect.py` (the reference's global
selection sort, `clo_sort_gselect.cl:38-57`): each row's output position is
the count of rows that sort before it. The row index is the last comparison
limb, the reference's stable tie-break `(key_i == key_g) && (i < g)`, so
ranks are unique and the sort is stable; the rows are then placed by a
unique-index scatter. The comparison runs as broadcast compares of `chunk=`
rows (default 4096) against all rows at a time, chunk x n booleans each.
Like the reference it is only sensible for small n: an oracle, not a fast
path. The JAX package computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort.abstract import SortImplDef, sort_impls


def _lex_lt(a, b):
    """Strict lexicographic a < b, broadcasting column tuples."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _make_gselect(spec, options):
    chunk = int(options.get("chunk", 4096))
    if chunk <= 0:
        raise BadArgsError(f"chunk must be positive, got {chunk}")

    def fn(limbs, payload):
        n = limbs[0].numel()
        dev = limbs[0].device
        keys = (*limbs, torch.arange(n, dtype=torch.int32, device=dev))
        every = tuple(k[None, :] for k in keys)
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        for s in range(0, n, chunk):
            rows = tuple(k[s:s + chunk, None] for k in keys)
            # row i's rank: the rows j with key_j < key_i
            rank[s:s + chunk] = _lex_lt(every, rows).sum(dim=1)
        cols = list(limbs) + ([payload] if payload is not None else [])
        out = [torch.empty_like(c).index_copy_(0, rank, c) for c in cols]
        return (tuple(out[:len(limbs)]),
                out[len(limbs)] if payload is not None else None)
    return fn


sort_impls.register("gselect")(lambda: SortImplDef(
    name="gselect",
    in_place=False,
    make_limb_sorter=_make_gselect,
    kernel_names=("gselect_rank",),
    smem_usage=lambda kernel, numel, options, n_arrays: 0,
))
