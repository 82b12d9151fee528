"""Distributed GROUP BY: hash-partition the rows by key, aggregate locally.

Counterpart of `cl_ops_tpu/parallel/aggregate.py` (BASELINE.json's "GROUP
BY over 256M rows, 1M groups" over the mesh). One keyed exchange carries
the key and every measure, so each key's rows land on one position, which
aggregates them exactly: positions hold disjoint group sets.

Locally each position sorts its received rows once by (inverted validity,
key limbs, first measure's limbs) with the other measures as payload (the
fused bitonic sort), and `_boundary_reduce_cols` reduces every (measure,
agg) pair against one boundary scan (scan_carry, seg_scan_carry). Measures
sort as order-normalized limbs, never as raw bits: a bitcast would order
float32 and uint32 values by their bit patterns, and min/max over the
first measure would gather the wrong group ends.

Skew: the exchange's overflow counter is checked, never discarded. Under
check="replan" an overflow re-plans (hash -> range splitters -> doubled
capacity, `splitters.keyed_exchange_replan`) and raises rather than drop
rows; check="defer" runs one exchange with no host read and returns its
`dropped` counter for the caller to verify.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.exec.aggregate import _AGGS, _boundary_reduce_cols
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, Sharded
from cl_ops_tpu_torch.parallel.shuffle import valid_slots
from cl_ops_tpu_torch.parallel.splitters import (CHECKS, keyed_exchange_once,
                                                 keyed_exchange_replan)
from cl_ops_tpu_torch.utils.bits import is_po2


def dist_group_aggregate(keys, values, mesh: Mesh, *, num_groups: int,
                         capacity: int, agg: str = "sum",
                         axis: str = DATA_AXIS, partition: str = "hash",
                         max_replan: int = 3, samples_per_chip: int = 256,
                         check: str = "replan"):
    """Aggregate values by key across the mesh.

    num_groups bounds the distinct keys of one position (its table);
    capacity bounds the rows of one (source -> partition) exchange bucket.
    check: "replan" re-plans on overflow and raises before dropping rows;
    "defer" runs one exchange with no host read and appends its per-position
    `dropped` counter (a Sharded) for the caller to check.

    Returns (group_keys, table, count), each a row-sharded Sharded:
    position c holds count[c] (key, aggregate) rows in ascending key order
    at the front of its num_groups slots; group sets are disjoint across
    positions. With check="defer" a trailing `dropped` is appended.
    """
    out = dist_group_aggregate_cols(
        keys, (values,), (agg,), mesh, num_groups=num_groups,
        capacity=capacity, axis=axis, partition=partition,
        max_replan=max_replan, samples_per_chip=samples_per_chip,
        check=check)
    return (out[0], out[1][0], *out[2:])


def dist_group_aggregate_cols(keys, values, aggs, mesh: Mesh, *,
                              num_groups: int, capacity: int,
                              axis: str = DATA_AXIS,
                              partition: str = "hash", max_replan: int = 3,
                              samples_per_chip: int = 256,
                              check: str = "replan"):
    """Multi-measure distributed GROUP BY (`SELECT sum(a), min(b),
    count(*)`), the mesh-level group_aggregate_cols.

    values: tuple of measure columns; aggs: the matching tuple from
    sum/count/min/max/mean. A column passed several times (the same object)
    rides the exchange and the sort once. Same skew and `check` contract as
    dist_group_aggregate.

    Returns (group_keys, tables, count), tables a tuple aligned with
    `values`, each a row-sharded Sharded; with check="defer" a trailing
    `dropped`.
    """
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError("mesh axis size must be a power of 2")
    if check not in CHECKS:
        raise ValueError(f"unknown check {check!r}")
    values, aggs = tuple(values), tuple(aggs)
    if len(values) != len(aggs) or not values:
        raise ValueError("values and aggs must be equal-length, non-empty")
    for a in aggs:
        if a not in _AGGS:
            raise ValueError(f"unknown agg {a!r}")
    uniq, slots = [], []
    for v in values:
        j = next((i for i, u in enumerate(uniq) if u is v), len(uniq))
        if j == len(uniq):
            uniq.append(v)
        slots.append(j)
    # the first measure (and its aliases) rides the sort key, so min/max
    # over it gather the group ends
    key_ordered = tuple(j == 0 for j in slots)
    sides = [(keys, tuple(uniq))]
    if check == "defer":
        (res,), (dropped,) = keyed_exchange_once(
            sides, mesh, capacities=(capacity,), axis=axis,
            partition=partition, samples_per_chip=samples_per_chip)
        cap = capacity
    else:
        (res,), (cap,) = keyed_exchange_replan(
            sides, mesh, capacities=(capacity,), axis=axis,
            partition=partition, max_replan=max_replan,
            samples_per_chip=samples_per_chip,
            op_name="dist_group_aggregate")

    def local(me, counts, k, *vs):
        # Validity leads the sort (inverted: valid rows form the key-sorted
        # prefix), so it never enters key space and every real key value,
        # the dtype's extremes included, aggregates.
        inv = (~valid_slots(counts, cap)).to(torch.int32)
        limbs = keymod.to_limbs(k)
        vlimbs = [keymod.to_limbs(v) for v in vs]
        out = psort.sort_i32_cols(
            (inv, *limbs, *(c for vl in vlimbs for c in vl)),
            num_keys=1 + len(limbs) + len(vlimbs[0]), pad_safe=True)
        off = 1 + len(limbs)
        sk = keymod.from_limbs(list(out[1:off]), k.dtype)
        svs = []
        for v, vl in zip(vs, vlimbs):
            svs.append(keymod.from_limbs(list(out[off:off + len(vl)]),
                                         v.dtype))
            off += len(vl)
        gk, tables, cnt = _boundary_reduce_cols(
            sk, tuple(svs[j] for j in slots), num_groups=num_groups,
            aggs=aggs, key_ordered=key_ordered, n_valid=counts.sum())
        return gk, tables, cnt.to(torch.int32).reshape(1)

    per = mesh.map(local, *res)
    out = (Sharded(mesh, [p[0] for p in per]),
           tuple(Sharded(mesh, [p[1][i] for p in per])
                 for i in range(len(values))),
           Sharded(mesh, [p[2] for p in per]))
    return out + (dropped,) if check == "defer" else out
