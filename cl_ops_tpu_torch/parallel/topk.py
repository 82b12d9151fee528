"""Distributed ORDER BY ... LIMIT k and SELECT DISTINCT across the mesh.

Counterpart of `cl_ops_tpu/parallel/topk.py`: select, then merge. Every
position solves its shard exactly with the single-card operator
(`ops/exec/topk.py`), contributes a candidate set bounded by the answer's
size, and one merge over the small union finishes. The bound is what
makes it exact: no position can place more than min(k, shard rows) rows
in the global top k, and the global distinct set lies in the union of the
positions' distinct sets.

The candidates reach every position by `mesh.all_gather`; the first
position of each process merges them with the fused bitonic sort, and the
result is replicated (`replicated(mesh)`), so every process of a mesh
across processes can read it, as the JAX package's `out_shardings=P()`.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.exec.topk import distinct, top_k
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, _device_scope,
                                            iota_sharded, put_sharded,
                                            replicate)


def _check_split(n: int, n_chips: int) -> None:
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")


def _merge(mesh: Mesh, per, fn):
    """Gather each candidate column of `per` (one tuple of columns per
    position) to every position, run fn on the first position's copy of
    the union, and replicate fn's outputs over the mesh."""
    cols = [mesh.all_gather([p[i] for p in per])[0]
            for i in range(len(per[0]))]
    with _device_scope(mesh.devices[0]):
        out = fn(*cols)
    return tuple(replicate(t, mesh) for t in out)


def dist_top_k(values, k: int, mesh: Mesh, *payload_cols,
               largest: bool = False, axis: str = DATA_AXIS, **topk_kw):
    """The k extreme rows of a row-sharded column, with payload columns.

    Args mirror ops/exec/topk.top_k (`oversample` and `sample_size` pass
    through `topk_kw`); `values` and the payload columns are row-sharded
    over the mesh. Returns (top_values, *top_payloads), each a replicated
    Sharded of k rows, ascending (descending with largest=True), ties
    broken by GLOBAL input position, as the single-card operator. Pass
    iota_sharded(n, mesh) as a payload column to receive the winners'
    positions.
    """
    n = values.shape[0]
    n_chips = mesh.shape[axis]
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    if k > n:
        raise ValueError(f"k={k} exceeds row count {n}")
    _check_split(n, n_chips)
    kk = min(k, n // n_chips)
    vs = put_sharded(values, mesh, axis)
    pays = [put_sharded(c, mesh, axis) for c in payload_cols]
    spec = tuple(c.dtype for c in pays)

    def local(me, v, gp, *ps):
        tv, tpos, *tp = top_k(v, kk, gp, *ps, largest=largest, **topk_kw)
        limbs = keymod.to_limbs(tv)
        if largest:
            limbs = [~c for c in limbs]
        return (*limbs, tpos, *psort.cols_to_i32(tuple(tp))[0])

    per = mesh.map(local, vs, iota_sharded(n, mesh, axis), *pays)
    nl = keymod.num_limbs(vs.dtype)

    def merge(*cols):
        # (limbs, global position) is unique: the payloads ride
        out = psort.sort_i32_cols(cols, num_keys=nl + 1, pad_safe=True)
        limbs = [c[:k] for c in out[:nl]]
        if largest:
            limbs = [~c for c in limbs]
        return (keymod.from_limbs(limbs, vs.dtype),
                *psort.cols_from_i32([c[:k] for c in out[nl + 1:]], spec))

    return _merge(mesh, per, merge)


def dist_distinct(keys, mesh: Mesh, *, capacity: int,
                  axis: str = DATA_AXIS):
    """SELECT DISTINCT over a row-sharded column.

    Returns (unique_values, count), replicated Shardeds: the first `count`
    slots hold the distinct values ascending, later slots are padding.
    `capacity` bounds the GLOBAL distinct count (ops/exec/topk.distinct's
    contract); each position's distinct count is within it.

    Each position's padding slots are overwritten with its first unique
    value, so they collapse in the merge instead of inventing keys.
    """
    ks = put_sharded(keys, mesh, axis)
    _check_split(ks.shape[0], mesh.shape[axis])
    cap_local = min(capacity, ks.shape[0] // mesh.shape[axis])

    def local(me, k):
        uniq, cnt = distinct(k, capacity=cap_local)
        idx = torch.arange(cap_local, device=k.device)
        u = signed_view(uniq)
        return (torch.where(idx < cnt, u, u[0]).view(uniq.dtype),)

    return _merge(mesh, mesh.map(local, ks),
                  lambda c: distinct(c, capacity=capacity))
