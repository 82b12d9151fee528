"""Window functions: per-partition running aggregates, ranks, lag/lead.

Counterpart of `cl_ops_tpu/ops/exec/window.py` (SQL `agg(v) OVER
(PARTITION BY k ORDER BY o)`). No kernel of its own: it composes the
bitonic sort (ops/exec/psort.py) and the segmented scan
(ops/scan/segmented.py), whose kernels are ported.

Pipeline (one sort for every requested window column):
  1. sort rows by (partition key, order, position) on normalized limbs;
     the unique position column makes the sort stable and doubles as the
     restore permutation; measure columns ride behind it as payload.
  2. partition-start flags from key-limb changes; one segmented scan per
     running aggregate; the rank family from segmented scans of ones.
  3. one batched restore sort (position, all outputs as payload) back to
     the input row order, or `sorted_output=True` to skip it and receive
     the row source permutation instead.

The JAX option use_pallas has no counterpart: CUDA tensors run the
kernels, CPU tensors their plain versions.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.exec.aggregate import _to_float
from cl_ops_tpu_torch.ops.scan.segmented import segmented_scan_1d
from cl_ops_tpu_torch.ops.sort import keys as keymod

_RANK_AGGS = ("row_number", "rank", "dense_rank")
_VALUE_AGGS = ("sum", "mean", "count", "min", "max", "lag", "lead")
WINDOW_AGGS = _VALUE_AGGS + _RANK_AGGS


def _limb_change_flags(limbs) -> torch.Tensor:
    """Segment-start flags (int32 0/1): any limb differs from its
    predecessor row."""
    n = limbs[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=limbs[0].device)
    new[:1] = True
    for c in limbs:
        new[1:] |= c[1:] != c[:-1]
    return new.to(torch.int32)


def _seg_count(flags: torch.Tensor, exclusive: bool) -> torch.Tensor:
    return segmented_scan_1d(torch.ones_like(flags), flags,
                             exclusive=exclusive)


def window_cols(keys, order, values, aggs, *, exclusive: bool = False,
                sorted_output: bool = False):
    """Compute window columns over one partition sort.

    keys: 1-D PARTITION BY column (any normalizable dtype). order: 1-D
    ORDER BY column, or None for unordered partitions (running aggregates
    then follow the input order; the rank family needs an order column).
    values: tuple of measure columns aligned with `aggs` (None for aggs
    that take no measure: count and the rank family). aggs: from
    sum/mean/count/min/max/lag/lead/row_number/rank/dense_rank; lag/lead
    are offset 1 within the partition, filled with the measure dtype's zero
    at partition edges; mean is float32. exclusive: running aggregates
    exclude the current row (rank family and lag/lead unaffected).
    sorted_output: skip the restore sort; outputs come partition-grouped,
    (key, order)-ascending, with `row_src`, where row_src[i] is the input
    row now at position i.

    Returns a tuple of per-row columns in input row order, or (tuple,
    row_src) when sorted_output=True.
    """
    aggs, values = tuple(aggs), tuple(values)
    if len(values) != len(aggs) or not aggs:
        raise BadArgsError("values and aggs must be equal-length, non-empty")
    for a, v in zip(aggs, values):
        if a not in WINDOW_AGGS:
            raise BadArgsError(f"unknown window agg {a!r}; known: "
                               f"{WINDOW_AGGS}")
        if a not in _RANK_AGGS and a != "count" and v is None:
            raise BadArgsError(f"agg {a!r} needs a measure column")
    if order is None and any(a in ("rank", "dense_rank") for a in aggs):
        raise BadArgsError("rank/dense_rank require an order column")

    n = keys.shape[0]
    dev = keys.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    kl = keymod.to_limbs(keys)
    ol = keymod.to_limbs(order) if order is not None else []

    # Repeated measures (the same tensor object) ride the sort once.
    uniq = []
    for v in values:
        if v is not None and not any(v is u for u in uniq):
            uniq.append(v)
    enc, spec = psort.cols_to_i32(tuple(uniq)) if uniq else ((), ())

    # (key, order, pos) is a unique prefix (pos < n also outranks the
    # i32-max pad rows), so the measures ride as payload.
    nk = len(kl) + len(ol) + 1
    out = psort.sort_i32_cols((*kl, *ol, pos, *enc), num_keys=nk,
                              pad_safe=True)
    skl = out[:len(kl)]
    sol = out[len(kl):len(kl) + len(ol)]
    row_src = out[len(kl) + len(ol)]
    suniq = psort.cols_from_i32(out[nk:], spec)

    def sorted_measure(v):
        return next(su for u, su in zip(uniq, suniq) if v is u)

    flags = _limb_change_flags(skl)
    seg_id = None  # lazily: running count of flags, for lag/lead
    rownum = None

    def row_number():
        nonlocal rownum
        if rownum is None:
            rownum = _seg_count(flags, False)
        return rownum

    results = []
    for a, v in zip(aggs, values):
        if a in ("row_number", "count"):
            rn = row_number()
            results.append(rn - 1 if (a == "count" and exclusive) else rn)
        elif a == "dense_rank":
            tie = flags | _limb_change_flags(sol)
            results.append(segmented_scan_1d(tie, flags, exclusive=False))
        elif a == "rank":
            tie = flags | _limb_change_flags(sol)
            results.append(row_number() - _seg_count(tie, False) + 1)
        elif a in ("lag", "lead"):
            sv = signed_view(sorted_measure(v))
            if seg_id is None:
                seg_id = torch.cumsum(flags, 0)
            k = 1 if a == "lag" else -1
            same = torch.roll(seg_id, k) == seg_id
            edge = (pos >= 1) if a == "lag" else (pos < n - 1)
            res = torch.where(same & edge, torch.roll(sv, k),
                              torch.zeros((), dtype=sv.dtype, device=dev))
            results.append(res.view(sorted_measure(v).dtype))
        elif a == "mean":
            sv = sorted_measure(v)
            s = segmented_scan_1d(
                sv, flags, sum_dtype=torch.float32
                if sv.dtype.is_floating_point else None, exclusive=exclusive)
            cnt = row_number() - 1 if exclusive else row_number()
            results.append(_to_float(s, torch.float32)
                           / cnt.clamp(min=1).to(torch.float32))
        else:
            op = {"sum": "add", "min": "min", "max": "max"}[a]
            results.append(segmented_scan_1d(sorted_measure(v), flags, op=op,
                                             exclusive=exclusive))

    if sorted_output:
        return tuple(results), row_src

    # One restore sort keyed by the unique source position brings every
    # output column home together.
    renc, rspec = psort.cols_to_i32(tuple(results))
    rout = psort.sort_i32_cols((row_src, *renc), num_keys=1, pad_safe=True)
    return psort.cols_from_i32(rout[1:], rspec)


def window_scan(keys, values, order=None, *, agg: str = "sum",
                exclusive: bool = False, sorted_output: bool = False):
    """Single-measure window aggregate (see window_cols)."""
    out = window_cols(keys, order, (values,), (agg,), exclusive=exclusive,
                      sorted_output=sorted_output)
    if sorted_output:
        return out[0][0], out[1]
    return out[0]
