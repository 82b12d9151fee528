"""Distributed window functions: `agg(v) OVER (PARTITION BY k ORDER BY o)`
across the mesh.

Counterpart of `cl_ops_tpu/parallel/window.py`, the mesh sibling of
`ops/exec/window.py`, composed from the layer's own primitives the way the
single-card operator composes the local ones:

  1. one global hypercube sort of (partition limbs, order limbs, global
     position, measures), `dist_sort_i32_cols`;
  2. partition-start flags, whose row at each position boundary compares
     with the previous position's last row (a `mesh.ppermute`): partitions
     freely straddle positions;
  3. one distributed segmented scan per running aggregate
     (`dist_segmented_scan`, seg_scan_carry) and, for lag/lead, segment
     ids from `dist_scan` and one-row global shifts;
  4. one restore sort keyed by the source position back to input row
     order, or `sorted_output=True` to skip it.

The global sort compares every column it carries, up to the fused sort's
MAX_COLS; where the measures or outputs need more columns they ride
further sorts under the same unique (keys, position) prefix, which order
the rows the same way.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.exec.aggregate import _to_float
from cl_ops_tpu_torch.ops.exec.window import (_RANK_AGGS, WINDOW_AGGS,
                                              _limb_change_flags)
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            iota_sharded, put_sharded)
from cl_ops_tpu_torch.parallel.scan import dist_scan, dist_segmented_scan
from cl_ops_tpu_torch.parallel.sort import dist_sort_i32_cols


def _each(mesh: Mesh, fn, *args) -> Sharded:
    """fn applied to every position's shards of `args`, as a Sharded."""
    return Sharded(mesh, mesh.map(lambda me, *a: fn(*a), *args))


def _columns(mesh: Mesh, fn, *args) -> list[Sharded]:
    """The columns that fn makes from every position's shards of `args`
    (fn returns a tuple of columns)."""
    per = mesh.map(lambda me, *a: tuple(fn(*a)), *args)
    return [Sharded(mesh, [p[i] for p in per]) for i in range(len(per[0]))]


def _sort_with_payload(prefix, payload, mesh: Mesh, axis: str):
    """Globally sort int32 columns by `prefix` (whose rows are unique),
    carrying `payload`: one dist_sort_i32_cols of up to MAX_COLS columns,
    more when the payload does not fit beside the prefix. Returns (sorted
    prefix, sorted payload)."""
    room = bk.MAX_COLS - len(prefix)
    chunks = [payload[i:i + room] for i in range(0, len(payload), room)]
    out = dist_sort_i32_cols((*prefix, *(chunks[0] if chunks else ())),
                             mesh, axis=axis)
    sp, spay = out[:len(prefix)], list(out[len(prefix):])
    for chunk in chunks[1:]:
        spay += dist_sort_i32_cols((*prefix, *chunk), mesh,
                                   axis=axis)[len(prefix):]
    return sp, spay


def _dist_change_flags(limbs, mesh: Mesh, axis: str) -> Sharded:
    """Row-change flags (int32) of globally sorted limb columns: 1 where a
    row differs from the one before it in any limb, and at global row 0.
    The first row of each position compares with the previous position's
    last row, which crosses by `mesh.ppermute`."""
    n_chips = mesh.shape[axis]
    prev = [mesh.ppermute([c[-1:] for c in col.shards],
                          [(i, i + 1) for i in range(n_chips - 1)])
            for col in limbs]

    def local(me, *args):
        cols, lasts = args[:len(limbs)], args[len(limbs):]
        flags = _limb_change_flags(cols)
        if me > 0:
            diff = torch.zeros(1, dtype=torch.bool, device=flags.device)
            for c, p in zip(cols, lasts):
                diff |= c[:1] != p
            flags[:1] = diff.to(torch.int32)
        return flags

    return Sharded(mesh, mesh.map(local, *limbs, *prev))


def _dist_roll(cols, mesh: Mesh, axis: str, shift: int) -> list[Sharded]:
    """Global one-row roll of sharded columns: shift=+1 gives out[i] =
    col[i-1] (global row 0 receives zeros), shift=-1 out[i] = col[i+1]
    (the last row zeros); callers mask the edges. The boundary row crosses
    positions by `mesh.ppermute`."""
    n_chips = mesh.shape[axis]
    out = []
    for col in cols:
        sc = _each(mesh, signed_view, col)
        if shift == 1:
            edge = mesh.ppermute([c[-1:] for c in sc.shards],
                                 [(i, i + 1) for i in range(n_chips - 1)])
            rolled = _each(mesh, lambda c, e: torch.cat([e, c[:-1]]),
                           sc, edge)
        else:
            edge = mesh.ppermute([c[:1] for c in sc.shards],
                                 [(i + 1, i) for i in range(n_chips - 1)])
            rolled = _each(mesh, lambda c, e: torch.cat([c[1:], e]),
                           sc, edge)
        out.append(_each(mesh, lambda c: c.view(col.dtype), rolled))
    return out


def dist_window_cols(keys, order, values, aggs, mesh: Mesh, *,
                     exclusive: bool = False, axis: str = DATA_AXIS,
                     sorted_output: bool = False):
    """Window columns over row-sharded inputs (see ops/exec/window.py).

    Args mirror window_cols; the 1-D inputs are row-sharded over the mesh
    (Shardeds, or anything put_sharded takes). Returns a tuple of per-row
    columns (row-sharded Shardeds) in input row order, or (columns,
    row_src) with sorted_output=True: outputs partition-grouped in (key,
    order, position) order, row_src[i] the input row now at global row i.
    """
    aggs, values = tuple(aggs), tuple(values)
    if len(values) != len(aggs) or not aggs:
        raise ValueError("values and aggs must be equal-length, non-empty")
    for a, v in zip(aggs, values):
        if a not in WINDOW_AGGS:
            raise ValueError(f"unknown window agg {a!r}; known: "
                             f"{WINDOW_AGGS}")
        if a not in _RANK_AGGS and a != "count" and v is None:
            raise ValueError(f"agg {a!r} needs a measure column")
    if order is None and any(a in ("rank", "dense_rank") for a in aggs):
        raise ValueError("rank/dense_rank require an order column")

    ks = put_sharded(keys, mesh, axis)
    n = ks.shape[0]
    kl = _columns(mesh, keymod.to_limbs, ks)
    ol = [] if order is None else _columns(
        mesh, keymod.to_limbs, put_sharded(order, mesh, axis))
    pos = iota_sharded(n, mesh, axis)

    # Repeated measures (the same object) ride the sort once.
    uniq = []
    for v in values:
        if v is not None and not any(v is u for u in uniq):
            uniq.append(v)
    ums = [put_sharded(u, mesh, axis) for u in uniq]
    spec = tuple(u.dtype for u in ums)
    enc = _columns(mesh, lambda *us: psort.cols_to_i32(us)[0], *ums) \
        if ums else []
    (*skl_sol, row_src), senc = _sort_with_payload((*kl, *ol, pos), enc,
                                                   mesh, axis)
    skl, sol = skl_sol[:len(kl)], skl_sol[len(kl):]
    suniq = _columns(mesh, lambda *e: psort.cols_from_i32(e, spec),
                     *senc) if ums else []

    def sorted_measure(v):
        return next(su for u, su in zip(uniq, suniq) if v is u)

    flags = _dist_change_flags(skl, mesh, axis)
    ones = _each(mesh, torch.ones_like, row_src)
    gidx = iota_sharded(n, mesh, axis)

    def seg(x, fl, **kw):
        return dist_segmented_scan(x, fl, mesh, axis=axis, **kw)

    rownum = seg_id = None

    def row_number():
        nonlocal rownum
        if rownum is None:
            rownum = seg(ones, flags, exclusive=False)
        return rownum

    results = []
    for a, v in zip(aggs, values):
        if a in ("row_number", "count"):
            rn = row_number()
            results.append(_each(mesh, lambda r: r - 1, rn)
                           if a == "count" and exclusive else rn)
        elif a in ("rank", "dense_rank"):
            tie = _each(mesh, torch.maximum, flags,
                        _dist_change_flags(sol, mesh, axis))
            if a == "dense_rank":
                results.append(seg(tie, flags, exclusive=False))
            else:
                results.append(_each(mesh, lambda r, t: r - t + 1,
                                     row_number(),
                                     seg(ones, tie, exclusive=False)))
        elif a in ("lag", "lead"):
            sv = sorted_measure(v)
            if seg_id is None:
                seg_id = dist_scan(flags, mesh, sum_dtype=torch.int32,
                                   exclusive=False, axis=axis)
            k = 1 if a == "lag" else -1
            shifted, rolled = _dist_roll((sv, seg_id), mesh, axis, k)

            lag = a == "lag"

            def pick(s, r, sid, g, lag=lag):
                keep = (r == sid) & (g >= 1 if lag else g < n - 1)
                return torch.where(keep, signed_view(s), 0).view(s.dtype)
            results.append(_each(mesh, pick, shifted, rolled, seg_id, gidx))
        elif a == "mean":
            sv = sorted_measure(v)
            s = seg(sv, flags, sum_dtype=torch.float32
                    if sv.dtype.is_floating_point else None,
                    exclusive=exclusive)
            results.append(_each(
                mesh, lambda t, r: _to_float(t, torch.float32)
                / (r - int(exclusive)).clamp(min=1).to(torch.float32),
                s, row_number()))
        else:
            op = {"sum": "add", "min": "min", "max": "max"}[a]
            results.append(seg(sorted_measure(v), flags, op=op,
                               exclusive=exclusive))

    if sorted_output:
        return tuple(results), row_src

    # One restore sort keyed by the unique source position brings every
    # output column home together.
    rspec = tuple(r.dtype for r in results)
    renc = _columns(mesh, lambda *rs: psort.cols_to_i32(rs)[0], *results)
    _, rout = _sort_with_payload((row_src,), renc, mesh, axis)
    return tuple(_columns(mesh, lambda *e: psort.cols_from_i32(e, rspec),
                          *rout))


def dist_window_scan(keys, values, mesh: Mesh, order=None, *, agg="sum",
                     exclusive: bool = False, axis: str = DATA_AXIS,
                     sorted_output: bool = False):
    """Single-measure distributed window aggregate (see dist_window_cols)."""
    out = dist_window_cols(keys, order, (values,), (agg,), mesh,
                           exclusive=exclusive, axis=axis,
                           sorted_output=sorted_output)
    if sorted_output:
        return out[0][0], out[1]
    return out[0]
