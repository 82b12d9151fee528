"""Multi-position sort: hypercube bitonic exchange over the mesh.

Counterpart of `cl_ops_tpu/parallel/sort.py`: the position-level replay of
the fused bitonic sort (`ops/sort/bitonic_kernels.py`), one more level of
the same network above the kernels' shared-memory tiles and device-memory
steps.

Algorithm (Batcher exchange, as in MPI bitonic sorts): every shard is kept
sorted ascending, first by the fused sort (block_sort, multi_stage,
pair_cross, block_merge). For each hypercube stage K and step J, position
`me` receives position `me ^ J`'s shard through `mesh.ppermute`; the
keep-min side takes the elementwise lexicographic min of (own, reversed
partner), the other side the max, which for two ascending runs gives the
lower or upper half of their union as a bitonic sequence; then
`bitonic_merge_2d` (pair_cross + block_merge) restores ascending order.
Who keeps the min follows the bitonic schedule, ((me & K) == 0) ==
((me & J) == 0). Position order is fixed by the mesh, so the result is
deterministic.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import bitonic as bt
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            iota_sharded, put_sharded)
from cl_ops_tpu_torch.utils.bits import is_po2, log2_floor, nlpo2

_PAD = 0x7FFFFFFF  # i32 max: all-pad rows sort after every real row


def _exchange_step(own, got, me: int, k: int, j: int, merge: int):
    """Position me's half of hypercube step (k, j), then its merge."""
    rev = [torch.flip(t, [0]) for t in got]
    lt = bk._lex_lt(own, rev)
    lo, hi = (own, rev) if ((me & j) == 0) == ((me & k) == 0) \
        else (rev, own)
    cols = [torch.where(lt, a, b) for a, b in zip(lo, hi)]
    return bk.bitonic_merge_2d(cols, merge_elems=merge)


def _reshard_prefix(cols, n: int, mesh: Mesh) -> list[Sharded]:
    """The first n rows of equal padded shards, split evenly again: row g
    moves from padded shard g // padded to shard g // (n / positions),
    through `mesh.all_to_all` with one contiguous piece per pair. cols[i]
    holds the columns of this process's i-th position."""
    p = mesh.size
    padded, shard_n = cols[0][0].numel(), n // p

    def piece(s, d):
        lo = max(s * padded, d * shard_n)
        hi = min((s + 1) * padded, (d + 1) * shard_n)
        return slice(lo - s * padded, max(hi, lo) - s * padded)

    return [Sharded(mesh, mesh.all_to_all(
                [[cs[c][piece(s, d)] for d in range(p)]
                 for s, cs in zip(mesh.positions, cols)]))
            for c in range(len(cols[0]))]


def dist_sort_i32_cols(cols, mesh: Mesh, *,
                       axis: str = DATA_AXIS) -> tuple[Sharded, ...]:
    """Lexicographic global sort of int32 columns split over the mesh.

    The tuple-level primitive under dist_sort, the distributed sibling of
    psort.sort_i32_cols: every column takes part in the comparison, in
    order, so put a unique column (e.g. a global position iota) ahead of
    payload columns. Returns the sorted columns as Shardeds of the same
    split. The length must divide evenly over the mesh, whose size must be
    a power of two; shards are padded to a power of two with all-i32-max
    rows, which sort to the global tail and are cut off.
    """
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError(f"mesh axis size {n_chips} must be a power of 2")
    n = cols[0].shape[0]
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")
    shards = [put_sharded(c, mesh, axis) for c in cols]
    if any(s.dtype != torch.int32 for s in shards):
        raise BadArgsError("dist_sort_i32_cols sorts int32 columns")
    target = nlpo2(n // n_chips)
    block, merge = bt.resolve_geometry(target, len(cols))

    def local_sort(me, *cs):
        bufs, _ = bk.pad_and_reshape(cs, [_PAD] * len(cs))  # fresh copies
        return bk.bitonic_sort_2d(list(bufs), block_elems=block,
                                  merge_elems=merge)

    arrs = mesh.map(local_sort, *shards)
    for sk in range(1, log2_floor(n_chips) + 1):
        k = 1 << sk
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(n_chips)]
            recv = [mesh.ppermute([a[c] for a in arrs], perm)
                    for c in range(len(cols))]
            got = [[r[i] for r in recv] for i in range(len(arrs))]
            arrs = mesh.map(lambda me, own, g, k=k, j=j: _exchange_step(
                own, g, me, k, j, merge), arrs, got)
            j //= 2
    if target * n_chips == n:
        return tuple(Sharded(mesh, [a[c] for a in arrs])
                     for c in range(len(cols)))
    return tuple(_reshard_prefix(arrs, n, mesh))


def _take_global(x: Sharded, idx: Sharded, mesh: Mesh) -> Sharded:
    """x[idx] with global indices: every position gathers from its copy of
    the whole x (`mesh.all_gather`)."""
    full = mesh.all_gather(list(x.shards))
    return Sharded(mesh, mesh.map(lambda me, f, i: interop.take(f, i),
                                  full, idx))


def dist_sort(x, mesh: Mesh, values=None, *, axis: str = DATA_AXIS,
              ascending: bool = True):
    """Sort 1-D keys split evenly over the mesh.

    Returns the globally sorted keys as a Sharded of the same split, and
    the values reordered with them when given. Keys of any dtype of
    `ops/sort/keys.py` sort through their int32 limbs (inverted for a
    descending sort); when there are values or two limbs, a global row
    iota rides as the last sort column and gathers keys and values.
    """
    xs = put_sharded(x, mesh, axis)
    n = xs.shape[0]
    n_limbs = keymod.num_limbs(xs.dtype)
    limbs = mesh.map(lambda me, t: [l if ascending else ~l
                                    for l in keymod.to_limbs(t)], xs)
    cols = [Sharded(mesh, [l[i] for l in limbs]) for i in range(n_limbs)]
    needs_payload = values is not None or n_limbs > 1
    if needs_payload:
        cols.append(iota_sharded(n, mesh, axis))
    out = dist_sort_i32_cols(cols, mesh, axis=axis)
    if not needs_payload:
        return Sharded(mesh, mesh.map(
            lambda me, *ls: keymod.from_limbs(
                [l if ascending else ~l for l in ls], xs.dtype),
            *out[:n_limbs]))
    perm = out[n_limbs]
    sorted_x = _take_global(xs, perm, mesh)
    if values is None:
        return sorted_x
    return sorted_x, _take_global(put_sharded(values, mesh, axis), perm, mesh)
