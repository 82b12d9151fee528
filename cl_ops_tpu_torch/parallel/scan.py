"""Multi-position prefix sums: local scan + collective carry exchange.

Counterpart of `cl_ops_tpu/parallel/scan.py`, the distributed form of the
reference's three-kernel Blelloch hierarchy: each position scans its shard
(`ops/scan` scan_1d's 3-phase path, whose scan_block / scan_block_wide
kernels replace the TPU's `_scan_block_kernel` / `_wide_scan_block_kernel`),
`mesh.all_gather` hands every position the shards' totals, and each adds
the sum of the totals before it. Position order is fixed by the mesh, so
carries are deterministic.

Results are in `sum_dtype`, as documented. (The JAX `dist_scan` widens a
32-bit integer sum_dtype to 64 bits under x64: `jnp.sum` promotes the
gathered totals. Its values agree with these modulo 2^32.)
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.ops.scan import scan_1d, segmented_scan_1d
from cl_ops_tpu_torch.ops.scan.segmented import OPS, _identity
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            put_sharded)
from cl_ops_tpu_torch.utils import intmath

_MIN64 = -(1 << 63)


def _astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """numpy's astype: integers wrap, floats convert."""
    if intmath.is_int(x.dtype) and intmath.is_int(dtype):
        return intmath.astype(x, dtype)
    return x.to(dtype)


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """Integers as a signed tensor of the same order (unsigned widened or
    sign-flipped)."""
    if not intmath.is_unsigned(t.dtype):
        return t
    if t.dtype.itemsize < 8:
        return intmath.to_i64(t)
    return t.view(torch.int64) ^ _MIN64


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(a, b) elementwise in a's dtype (b broadcasts): integer sums wrap,
    integer min/max in the dtype's own order, float min/max propagate NaN
    as jnp.minimum/maximum do."""
    if op == "add":
        return intmath.add(a, b) if intmath.is_int(a.dtype) else a + b
    if not intmath.is_int(a.dtype):
        return (torch.minimum if op == "min" else torch.maximum)(a, b)
    oa, ob = _ordered(a), _ordered(b)
    take_b = ob < oa if op == "min" else ob > oa
    return intmath.where(take_b, b.expand_as(a), a)


def _fold(op: str, vals: torch.Tensor) -> torch.Tensor:
    """op over a short 1-D tensor, as a (1,) tensor."""
    acc = vals[:1]
    for i in range(1, vals.numel()):
        acc = _combine(op, acc, vals[i:i + 1])
    return acc


def _check_even(n: int, n_shards: int, axis: str) -> None:
    if n % n_shards:
        raise ValueError(f"array length {n} not divisible by mesh axis "
                         f"{axis}={n_shards}")


def dist_scan(x, mesh: Mesh, *, sum_dtype, exclusive: bool = True,
              axis: str = DATA_AXIS) -> Sharded:
    """Exclusive/inclusive prefix sum of 1-D rows split evenly over the
    mesh. Returns a row-sharded Sharded of dtype `sum_dtype`; integer sums
    wrap modulo 2^bits of it."""
    sd = canonicalize(sum_dtype)
    _check_even(x.shape[0], mesh.shape[axis], axis)
    xs = put_sharded(x, mesh, axis)

    def local(me, t):
        out = scan_1d(t, sum_dtype=sd, exclusive=exclusive)
        total = out[-1:]
        if exclusive:
            total = _combine("add", total, _astype(t[-1:], sd))
        return out, total

    per = mesh.map(local, xs)
    totals = mesh.all_gather([p[1] for p in per])

    def carry(me, p, tot):
        if me == 0:
            return p[0]
        # the uniform add of the totals before this position
        return _combine("add", p[0], _fold("add", tot[:me]))

    return Sharded(mesh, mesh.map(carry, per, totals))


def dist_segmented_scan(x, flags, mesh: Mesh, *, sum_dtype=None, op="add",
                        exclusive: bool = True,
                        axis: str = DATA_AXIS) -> Sharded:
    """Per-segment running sum/min/max of 1-D rows split over the mesh.

    Each position runs segmented_scan_1d (seg_scan_carry) on its shard;
    `mesh.all_gather` then hands every position each shard's (value since
    its last flag, has-flag) summary, and the carry of position i combines
    the tails from the last flagged position before i; it applies only to
    rows before i's first flag. The exclusive form shifts the inclusive
    result by one row, the previous position's last value crossing over
    through `mesh.ppermute`, so min and max work too.

    `flags` marks segment starts (nonzero). Returns a row-sharded Sharded
    of dtype sum_dtype (default: x's).
    """
    if op not in OPS:
        raise BadArgsError(f"unknown op {op!r}; known: {OPS}")
    n_shards = mesh.shape[axis]
    _check_even(x.shape[0], n_shards, axis)
    if tuple(flags.shape) != tuple(x.shape):
        raise ValueError(f"flags shape {tuple(flags.shape)} != values shape "
                         f"{tuple(x.shape)}")
    xs = put_sharded(x, mesh, axis)
    sd = canonicalize(sum_dtype if sum_dtype is not None else xs.dtype)
    ident = _identity(op, sd)

    def local(me, t, f):
        f = (f != 0).to(torch.int32)
        incl = segmented_scan_1d(_astype(t, sd), f, sum_dtype=sd, op=op,
                                 exclusive=False)
        return incl, f, (f.sum() > 0).to(torch.int32).reshape(1)

    per = mesh.map(local, xs, put_sharded(flags, mesh, axis))
    tails = mesh.all_gather([p[0][-1:] for p in per])
    hflags = mesh.all_gather([p[2] for p in per])

    def apply_carry(me, p, tl, hf):
        incl, f, _ = p
        idx = torch.arange(n_shards, device=incl.device)
        # last flagged position before me (0 when none): tails[start] is
        # already the value since its last flag
        start = torch.where((idx < me) & (hf > 0), idx, 0).max()
        live = (idx < me) & (idx >= start)
        idt = intmath.full(1, ident, sd, incl.device)
        carry = _fold(op, intmath.where(live, tl, idt.expand_as(tl)))
        noprior = torch.cumsum(f, 0) == 0
        return _combine(op, incl, intmath.where(
            noprior, carry.expand_as(incl), idt.expand_as(incl)))

    outs = mesh.map(apply_carry, per, tails, hflags)
    if not exclusive:
        return Sharded(mesh, outs)
    prev_last = mesh.ppermute([o[-1:] for o in outs],
                              [(i, i + 1) for i in range(n_shards - 1)])

    def shift(me, o, prev, p):
        shifted = torch.cat([signed_view(prev),
                             signed_view(o[:-1])]).view(sd)
        # segment starts and the global first row take the identity
        reset = p[1] > 0
        if me == 0:
            reset[0] = True
        idt = intmath.full(1, ident, sd, o.device)
        return intmath.where(reset, idt.expand_as(o), shifted)

    return Sharded(mesh, mesh.map(shift, outs, prev_last, per))
