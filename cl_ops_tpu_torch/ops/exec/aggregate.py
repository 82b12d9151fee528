"""GROUP BY aggregation.

Counterpart of `cl_ops_tpu/ops/exec/aggregate.py` (BASELINE.json: "GROUP BY
over 256M rows, 1M groups").

Strategies:
  * "direct" — keys are already dense group ids in [0, num_groups): one
    index_add_ / scatter_reduce_ into the table; out-of-range ids drop.
  * "sort"   — arbitrary keys: rows sort by key through the fused bitonic
    sort (ops/exec/psort.py), then a scatter-free boundary reduce: group
    totals are differences of a running sum (the scan_carry kernel) at
    group ends, and min/max are one segmented scan (seg_scan_carry) read at
    group ends, or boundary gathers where the values are part of the sort
    key. Groups come out in ascending key order.

Aggregations: sum, count, min, max, mean. No function here reads a device
value on the host: `n_valid` may be a 0-d tensor and `count` is returned as
one.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.interop import signed_view, take
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.scan.kernels import scan_1d
from cl_ops_tpu_torch.ops.scan.segmented import segmented_scan_1d
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.profiling import spanned

_AGGS = ("sum", "count", "min", "max", "mean")


def _seg_ok(dtype: torch.dtype) -> bool:
    """True when segmented min/max scans take this dtype (<=32-bit ints and
    float32); the others take the sort fallback of _boundary_reduce_cols."""
    return (intmath.is_int(dtype) and dtype.itemsize <= 4) \
        or dtype == torch.float32


def _csum(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Inclusive prefix sum in x's dtype (or `dtype`): 4- and 8-byte
    integers through the single-pass scan_carry kernel, narrower integers
    wrapped to their width, floats by torch.cumsum (as the JAX package
    keeps jnp.cumsum for them)."""
    if dtype is not None:
        x = x.to(dtype)
    if intmath.is_int(x.dtype) and x.dtype.itemsize in (4, 8):
        return scan_1d(x, sum_dtype=x.dtype, exclusive=False,
                       single_pass=True)
    if intmath.is_int(x.dtype):
        return intmath.cumsum(x)
    return torch.cumsum(x, 0)


def _init_scalar(dtype: torch.dtype, agg: str):
    if agg in ("min", "max"):
        if dtype.is_floating_point:
            return float("inf") if agg == "min" else float("-inf")
        lo, hi = intmath.int_limits(dtype)
        return hi if agg == "min" else lo
    return 0


def _init_table(n: int, dtype: torch.dtype, agg: str, device):
    return intmath.full(n, _init_scalar(dtype, agg), dtype, device)


def _mean_dtype(dtype: torch.dtype) -> torch.dtype:
    """dtype of (sum table) / (counts cast to the table's dtype): the JAX
    package's promotion, float32 for <=32-bit integers, float64 for 64-bit
    ones, floats unchanged."""
    if dtype.is_floating_point:
        return dtype
    return torch.float64 if dtype.itemsize == 8 else torch.float32


def _to_float(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer or float tensor -> float `dtype`, rounding once (unsigned
    values by their value, not their signed bits)."""
    if t.dtype.is_floating_point:
        return t.to(dtype)
    if t.dtype == torch.uint64:
        s = t.view(torch.int64)
        hi = ((s >> 32) & 0xFFFFFFFF).to(torch.float64) * float(1 << 32)
        return (hi + (s & 0xFFFFFFFF).to(torch.float64)).to(dtype)
    return intmath.to_i64(t).to(dtype)


def _mean(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """sums / max(counts, 1), with the counts cast to the sums' dtype first
    (wrapping for narrow integers) as the JAX package does."""
    cnts = counts.clamp(min=1)
    if sums.dtype.is_floating_point:
        return sums / cnts.to(sums.dtype)
    dt = _mean_dtype(sums.dtype)
    return _to_float(sums, dt) / _to_float(intmath.astype(cnts, sums.dtype),
                                           dt)


def _check_key_bits(keys: torch.Tensor, key_bits: int) -> None:
    if not 0 < key_bits <= 30:
        raise BadArgsError("key_bits must be in (0, 30]")
    if not intmath.is_int(keys.dtype) or keys.dtype.itemsize > 4:
        raise BadArgsError("key_bits packing needs a 4-byte-or-narrower "
                           "integer key column")


# --- direct ------------------------------------------------------------------

@spanned("clo.op:groupby")
def group_aggregate_direct(group_ids: torch.Tensor, values: torch.Tensor, *,
                           num_groups: int, agg: str = "sum") -> torch.Tensor:
    """Aggregate values by dense int group id in [0, num_groups).

    Returns the (num_groups,) table. Negative ids count from the end, as a
    JAX index does; ids outside [-num_groups, num_groups) drop. On the card
    float sums go through atomics and are not reproducible bit for bit;
    integer sums are.
    """
    if agg not in _AGGS:
        raise BadArgsError(f"unknown agg {agg!r}; known: {_AGGS}")
    dev = group_ids.device
    if agg == "count":
        values = torch.ones(group_ids.shape, dtype=torch.int32, device=dev)
    # dropped rows go to a spare last slot, so that no mask is read on the
    # host
    ids = intmath.to_i64(group_ids)
    ids = torch.where(ids < 0, ids + num_groups, ids)
    ids = torch.where((ids >= 0) & (ids < num_groups), ids, num_groups)
    dt = values.dtype
    table = _init_table(num_groups + 1, dt, agg, dev)
    if agg in ("min", "max"):
        reduce = "amin" if agg == "min" else "amax"
        if intmath.is_unsigned(dt) and dt.itemsize < 4:
            # zero-extended values order as unsigned
            t = intmath.to_i64(table).scatter_reduce(
                0, ids, intmath.to_i64(values), reduce)
            return intmath.astype(t, dt)[:num_groups]
        if intmath.is_unsigned(dt):  # unsigned order through the sign flip
            sign = -(1 << (8 * dt.itemsize - 1))
            t = (signed_view(table) ^ sign).scatter_reduce(
                0, ids, signed_view(values) ^ sign, reduce)
            return (t ^ sign).view(dt)[:num_groups]
        return table.scatter_reduce(0, ids, values, reduce)[:num_groups]
    if intmath.is_int(dt):
        table = intmath.astype(intmath.to_i64(table).index_add(
            0, ids, intmath.to_i64(values)), dt)
    else:
        table = table.index_add(0, ids, values)
    table = table[:num_groups]
    if agg == "mean":
        counts = torch.zeros(num_groups + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        return _mean(table, counts[:num_groups])
    return table


# --- sort-based --------------------------------------------------------------

def _sorted_aggregate(keys, values, *, num_groups: int, agg: str):
    """Sort rows by key with values as payload, then boundary-reduce. Only
    a min/max over a dtype the segmented scan cannot take puts the values
    into the sort key (the boundary-gather form)."""
    kl = keymod.to_limbs(keys)
    vl = keymod.to_limbs(values)
    need_order = agg in ("min", "max") and not _seg_ok(values.dtype)
    nk = len(kl) + (len(vl) if need_order else 0)
    out = psort.sort_i32_cols((*kl, *vl), num_keys=nk)
    skeys = keymod.from_limbs(list(out[:len(kl)]), keys.dtype)
    svals = keymod.from_limbs(list(out[len(kl):]), values.dtype)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg,
                            vals_in_key_order=need_order)


@spanned("clo.op:groupby")
def group_aggregate_prefix(keys, values, n_valid, *, num_groups: int,
                           agg: str = "sum", key_bits: int | None = None):
    """Aggregate only the first n_valid rows (the filter_compact composer).

    Rows sort by (validity, key) so the valid prefix is key-sorted and the
    boundary reduce ignores the tail. key_bits: a caller contract that keys
    are non-negative ints < 2^key_bits (<= 30); the validity bit then packs
    above the key in one sort column.
    """
    if agg not in _AGGS:
        raise BadArgsError(f"unknown agg {agg!r}; known: {_AGGS}")
    n = keys.shape[0]
    vl = keymod.to_limbs(values)
    inv = (torch.arange(n, dtype=torch.int32, device=keys.device)
           >= n_valid).to(torch.int32)
    need_order = agg in ("min", "max") and not _seg_ok(values.dtype)
    if key_bits is not None:
        _check_key_bits(keys, key_bits)
        packed = (inv << key_bits) | intmath.astype(keys, torch.int32)
        nk = 1 + (len(vl) if need_order else 0)
        out = psort.sort_i32_cols((packed, *vl), num_keys=nk)
        skeys = intmath.astype(out[0], keys.dtype)
        svals = keymod.from_limbs(list(out[1:]), values.dtype)
    else:
        kl = keymod.to_limbs(keys)
        nk = 1 + len(kl) + (len(vl) if need_order else 0)
        out = psort.sort_i32_cols((inv, *kl, *vl), num_keys=nk)
        skeys = keymod.from_limbs(list(out[1:1 + len(kl)]), keys.dtype)
        svals = keymod.from_limbs(list(out[1 + len(kl):]), values.dtype)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg,
                            n_valid=n_valid, vals_in_key_order=need_order)


def _table_dtype(values_dtype: torch.dtype, agg: str) -> torch.dtype:
    """Table dtype of an empty input. The JAX package takes the mean's
    from (value / int32), which promotes uint32 to int64 first."""
    if agg == "count":
        return torch.int32
    if agg == "mean":
        return torch.float64 if values_dtype == torch.uint32 \
            else _mean_dtype(values_dtype)
    return values_dtype


def _empty(keys, num_groups: int, table_dtypes):
    dev = keys.device
    return (torch.zeros(num_groups, dtype=signed_view(keys).dtype,
                        device=dev).view(keys.dtype),
            tuple(intmath.full(num_groups, 0, dt, dev) for dt in table_dtypes),
            torch.zeros((), dtype=torch.int32, device=dev))


@spanned("clo.op:groupby")
def group_aggregate_sorted(keys, values, *, num_groups: int, agg: str = "sum",
                           sorter=None, keys_sorted: bool = False):
    """Aggregate values by arbitrary key: sort -> boundary scan -> reduce.

    By default rows sort by key through the fused bitonic sort. An explicit
    registry `sorter` sorts by key with values as payload instead.
    keys_sorted=True skips the input sort (rows already key-grouped).

    Returns (group_keys, table, count): the first `count` entries hold one
    row per distinct key in ascending key order; later entries are padding
    (group key skeys[n-1], sums and counts 0, min/max the dtype's init).
    num_groups is the table capacity (the distinct-key count must not
    exceed it).
    """
    if agg not in _AGGS:
        raise BadArgsError(f"unknown agg {agg!r}; known: {_AGGS}")
    if keys.shape[0] == 0:
        gk, tables, count = _empty(keys, num_groups,
                                   (_table_dtype(values.dtype, agg),))
        return gk, tables[0], count
    if keys_sorted:
        return _boundary_reduce(keys, values, num_groups=num_groups, agg=agg)
    if sorter is None:
        return _sorted_aggregate(keys, values, num_groups=num_groups, agg=agg)
    skeys, svals = sorter.sort_with_device_data(keys, values)
    return _boundary_reduce(skeys, svals, num_groups=num_groups, agg=agg)


@spanned("clo.op:groupby")
def group_aggregate_cols(keys, values, aggs, *, num_groups: int,
                         n_valid=None, valid_mask=None,
                         keys_sorted: bool = False,
                         key_bits: int | None = None):
    """Multi-measure GROUP BY: one input sort, one boundary scan, one
    reduction per (column, agg), the SELECT sum(a), min(b), count(*) shape
    (e.g. TPC-H Q1).

    values: tuple of measure columns (same length); aggs: matching tuple of
    sum/count/min/max/mean ("count" ignores its column's values). A column
    passed several times (the same tensor object) is sorted once. n_valid
    aggregates only rows < n_valid; valid_mask only rows where the boolean
    mask holds (the fused WHERE: validity leads the sort). keys_sorted=True
    consumes pre-grouped rows with no input sort. key_bits: a caller
    contract that keys are non-negative ints < 2^key_bits (<= 30); the
    validity bit then packs above the key in one i32 sort column.

    Returns (group_keys, tables, count), tables aligned with `values`.
    """
    if len(values) != len(aggs) or not values:
        raise BadArgsError("values and aggs must be equal-length, non-empty")
    for a in aggs:
        if a not in _AGGS:
            raise BadArgsError(f"unknown agg {a!r}")
    if keys_sorted and (n_valid is not None or valid_mask is not None):
        raise BadArgsError("n_valid/valid_mask require the sorting path "
                           "(keys_sorted=False)")
    if key_bits is not None:
        _check_key_bits(keys, key_bits)
        if keys_sorted or (n_valid is None and valid_mask is None):
            key_bits = None  # nothing to pack without a validity bit
    if n_valid is not None and valid_mask is not None:
        raise BadArgsError("pass n_valid or valid_mask, not both")
    if keys.shape[0] == 0:
        return _empty(keys, num_groups, tuple(
            _table_dtype(v.dtype, a) for v, a in zip(values, aggs)))
    if keys_sorted:
        return _boundary_reduce_cols(keys, tuple(values),
                                     num_groups=num_groups, aggs=tuple(aggs),
                                     key_ordered=(False,) * len(values))
    # Several aggs over one measure column sort that column once.
    uniq, slot_map, seen = [], [], {}
    for v in values:
        j = seen.setdefault(id(v), len(uniq))
        if j == len(uniq):
            uniq.append(v)
        slot_map.append(j)
    # Only a first-column min/max over a dtype the segmented scan cannot
    # take pulls that column into the sort key (boundary-gather form).
    first_in_prefix = any(
        a in ("min", "max") and j == 0 and not _seg_ok(uniq[0].dtype)
        for a, j in zip(aggs, slot_map))
    key_ordered = tuple(j == 0 and first_in_prefix for j in slot_map)
    return _group_aggregate_cols_sort(
        keys, tuple(uniq), n_valid, valid_mask, num_groups=num_groups,
        aggs=tuple(aggs), key_ordered=key_ordered, slot_map=tuple(slot_map),
        first_in_prefix=first_in_prefix, key_bits=key_bits)


def _group_aggregate_cols_sort(keys, values, n_valid, valid_mask, *,
                               num_groups: int, aggs, key_ordered, slot_map,
                               first_in_prefix: bool, key_bits):
    # values holds the unique measure columns; slot_map maps each agg slot
    # to its column.
    kl = keymod.to_limbs(keys)
    vls = [keymod.to_limbs(v) for v in values]
    vcols = tuple(c for vl in vls for c in vl)
    n = keys.shape[0]
    if valid_mask is not None:
        inv = 1 - valid_mask.to(torch.int32)
        n_valid = valid_mask.sum(dtype=torch.int64)
    elif n_valid is not None:
        inv = (torch.arange(n, dtype=torch.int32, device=keys.device)
               >= n_valid).to(torch.int32)
    else:
        inv = None
    prefix = len(vls[0]) if first_in_prefix else 0
    if key_bits is not None and inv is not None:
        # One i32 column orders as (validity, key); for the valid prefix the
        # packed value is the key itself.
        packed = (inv << key_bits) | intmath.astype(keys, torch.int32)
        out = psort.sort_i32_cols((packed, *vcols), num_keys=1 + prefix)
        skeys = intmath.astype(out[0], keys.dtype)
        off = 1
    else:
        lead = (inv, *kl) if inv is not None else tuple(kl)
        out = psort.sort_i32_cols((*lead, *vcols),
                                  num_keys=len(lead) + prefix)
        skeys = keymod.from_limbs(list(out[len(lead) - len(kl):len(lead)]),
                                  keys.dtype)
        off = len(lead)
    suniq = []
    for v, vl in zip(values, vls):
        suniq.append(keymod.from_limbs(list(out[off:off + len(vl)]), v.dtype))
        off += len(vl)
    return _boundary_reduce_cols(
        skeys, tuple(suniq[j] for j in slot_map), num_groups=num_groups,
        aggs=aggs, key_ordered=key_ordered, n_valid=n_valid)


# --- the boundary reduce -----------------------------------------------------

def _boundary_reduce(skeys, svals, *, num_groups: int, agg: str,
                     n_valid=None, vals_in_key_order: bool = False):
    """_boundary_reduce_cols for one measure."""
    gk, tables, count = _boundary_reduce_cols(
        skeys, (svals,), num_groups=num_groups, aggs=(agg,),
        key_ordered=(vals_in_key_order,), n_valid=n_valid)
    return gk, tables[0], count


def _group_ends(is_end: torch.Tensor, num_groups: int, n: int):
    """Position of the (g+1)-th end flag for g < num_groups (rows past the
    last end hold n or more). Dense groups (num_groups * 64 >= n): one
    stable partition of the end positions through the sort; sparse groups:
    an exact searchsorted over the running end count."""
    gi = torch.arange(num_groups, dtype=torch.int32, device=is_end.device)
    if num_groups * 64 >= n and 2 * n < 2 ** 31:
        comb = psort.flag_pos_key(1 - is_end.to(torch.int32), n)
        spos_ends = psort.sort_i32_cols((comb,))[0]
        return spos_ends[gi.clamp(max=n - 1)]
    end_rank = _csum(is_end, torch.int32)
    return torch.searchsorted(end_rank, gi + 1, side="left", out_int32=True)


def _boundary_reduce_cols(skeys, svals, *, num_groups: int, aggs,
                          key_ordered, n_valid=None):
    """Scatter-free segmented reduce over key-sorted rows, N measures.

    The group boundaries are found once and every measure reduces against
    them. sum/count/mean: differences of the running sum at group ends.
    min/max: a key-ordered column (rows sorted by (key, value)) gathers its
    first/last value; a <=32-bit integer or float32 column runs one
    inclusive segmented scan read at the group ends; any other dtype sorts
    (group_id, value) once, with group_id computed once per call.

    n_valid: rows at positions >= n_valid are ignored (callers sort the
    valid rows into a prefix). Returns (group_keys, tables, count).
    """
    n = skeys.shape[0]
    dev = skeys.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev) if n_valid is None \
        else pos < n_valid
    sk = signed_view(skeys)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = valid & torch.cat([one, sk[1:] != sk[:-1]])
    count = is_new.sum(dtype=torch.int64)
    next_is_new = torch.cat([is_new[1:], one])
    next_invalid = torch.cat([~valid[1:], one])
    is_end = valid & (next_is_new | next_invalid)

    gi = torch.arange(num_groups, dtype=torch.int32, device=dev)
    valid_g = gi < count
    ends = torch.where(valid_g, _group_ends(is_end, num_groups, n).clamp(
        max=n - 1), n - 1).to(torch.int32)
    group_keys = take(skeys, ends)
    starts_g = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                          ends[:-1] + 1])

    def seg_diff(acc):
        end_acc = take(acc, ends)
        prev = torch.cat([signed_view(intmath.full(1, 0, acc.dtype, dev)),
                          signed_view(end_acc)[:-1]]).view(acc.dtype)
        diff = intmath.sub(end_acc, prev) if intmath.is_int(acc.dtype) \
            else end_acc - prev
        return intmath.where(valid_g, diff,
                             intmath.full(num_groups, 0, acc.dtype, dev))

    def init_where(dtype, agg, got):
        return intmath.where(valid_g, got,
                             _init_table(num_groups, dtype, agg, dev))

    vcnt_acc = None
    if any(a in ("count", "mean") for a in aggs):
        vcnt_acc = _csum(valid, torch.int32)
    group_id = None

    tables = []
    for sv, agg, ko in zip(svals, aggs, key_ordered):
        if agg in ("min", "max") and ko:
            src = ends if agg == "max" else starts_g.clamp(0, n - 1)
            tables.append(init_where(sv.dtype, agg, take(sv, src)))
        elif agg in ("min", "max") and _seg_ok(sv.dtype):
            # An inclusive segmented scan restarted at each group start
            # holds the group's min/max at its end position; invalid rows
            # lie past every end.
            seg = segmented_scan_1d(sv, is_new.to(torch.int32), op=agg,
                                    exclusive=False)
            tables.append(init_where(sv.dtype, agg, take(seg, ends)))
        elif agg in ("min", "max"):
            # 64-bit and half-precision values: one (group_id, value) sort.
            if group_id is None:
                group_id = _csum(is_new, torch.int32) - 1
            gid2 = torch.where(valid, group_id, num_groups)
            out = psort.sort_i32_cols((gid2, *keymod.to_limbs(sv)))
            sv2 = keymod.from_limbs(list(out[1:]), sv.dtype)
            side = "right" if agg == "max" else "left"
            src = torch.searchsorted(out[0], gi, side=side, out_int32=True)
            if agg == "max":
                src = src - 1
            tables.append(init_where(sv.dtype, agg,
                                     take(sv2, src.clamp(0, n - 1))))
        elif agg == "count":
            tables.append(seg_diff(vcnt_acc))
        else:
            if n_valid is not None:
                sv = intmath.where(valid, sv,
                                   intmath.full(n, 0, sv.dtype, dev))
            table = seg_diff(_csum(sv))
            if agg == "mean":
                table = _mean(table, seg_diff(vcnt_acc))
            tables.append(table)
    return group_keys, tuple(tables), count
