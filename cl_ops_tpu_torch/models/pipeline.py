"""Flagship end-to-end pipelines (the framework's "models").

Counterpart of `cl_ops_tpu/models/pipeline.py`: generate_table,
sort_pipeline (Threefry-generate keys -> sort -> sortedness check),
analytics_query (generate -> filter -> GROUP BY), star_query (generate ->
filter -> join -> GROUP BY), q1_query (the TPC-H Q1 shape) and
rollup_query (a semi join whose sorted output feeds GROUP BY without a
sort of its own).

The arguments the JAX package does not have (`device`, and rollup_query's
`defer`, which JAX takes after `use_pallas`) are keyword-only, so a call
that passes JAX's `use_pallas` by position raises TypeError instead of
changing meaning.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.interop import signed_view, widen_u32
from cl_ops_tpu_torch.ops.exec.aggregate import (group_aggregate_cols,
                                                 group_aggregate_prefix,
                                                 group_aggregate_sorted)
from cl_ops_tpu_torch.ops.exec.filter import filter_compact
from cl_ops_tpu_torch.ops.exec.join import hash_join
from cl_ops_tpu_torch.ops.rng import threefry
from cl_ops_tpu_torch.utils.platform import default_device


def _mod_u32(bits: torch.Tensor, m: int) -> torch.Tensor:
    """(u32 bits % m) as a uint32 tensor."""
    return (widen_u32(bits) % m).to(torch.int32).view(torch.uint32)


def generate_table(n: int, seed: int = 0, key_space: int = 1 << 20,
                   value_space: int = 1 << 10, *, device=None):
    """Threefry-generated (keys, values) uint32 fact table on `device`
    (None = "cuda")."""
    ids = torch.arange(n, dtype=torch.int32,
                       device=default_device(device))
    keys = _mod_u32(threefry.random_bits(seed, ids, 0), key_space)
    values = _mod_u32(threefry.random_bits(seed, ids, 1), value_space)
    return keys, values


def sort_pipeline(n: int, seed: int = 0, *, device=None):
    """Generate n random keys, sort them with abitonic, return
    (sorted keys, is_sorted) with is_sorted a 0-d bool tensor."""
    from cl_ops_tpu_torch.ops.sort import sort_new
    keys, _ = generate_table(n, seed, device=device)
    sorted_keys = sort_new("abitonic").sort_with_device_data(keys)
    w = widen_u32(sorted_keys)
    return sorted_keys, torch.all(w[1:] >= w[:-1])


def _key_bits(num_groups: int) -> int | None:
    """The key_bits packing hint for group ids < num_groups (None above
    30 bits)."""
    kb = max((num_groups - 1).bit_length(), 1)
    return kb if kb <= 30 else None


def analytics_query(n: int, num_groups: int = 1024, seed: int = 0,
                    threshold: int = 512, *, device=None):
    """SELECT key % G, SUM(value) FROM t WHERE value < threshold GROUP BY 1.

    Generate a table on `device` (None = "cuda") -> filter_compact ->
    group_aggregate_prefix over the kept prefix. Returns (count of kept
    rows, the (num_groups,) uint32 table indexed by group id).
    """
    keys, values = generate_table(n, seed, device=device)
    count, fvals, fkeys = filter_compact(
        values, lambda v: widen_u32(v) < threshold, keys)
    gids = (widen_u32(fkeys) % num_groups).to(torch.int32)
    gk, tbl, gcnt = group_aggregate_prefix(
        gids, fvals, count, num_groups=num_groups, agg="sum",
        key_bits=_key_bits(num_groups))
    return count, _by_group_id(gk, tbl, gcnt, num_groups)


def _by_group_id(gk, tbl, gcnt, num_groups: int) -> torch.Tensor:
    """Re-index a prefix aggregate's table by group id. Slots past the
    group count drop into a spare last slot, so no mask is read on the
    host."""
    slot = torch.arange(num_groups, dtype=torch.int32, device=gk.device)
    keep = (slot < gcnt) & (gk >= 0) & (gk < num_groups)
    dest = torch.where(keep, gk, num_groups).to(torch.int64)
    table = torch.zeros(num_groups + 1, dtype=torch.int32, device=gk.device)
    table.index_put_((dest,), signed_view(tbl))
    return table[:num_groups].view(tbl.dtype)


def star_query(n: int, dim_rows: int = 1 << 14, num_cats: int = 256,
               seed: int = 0, threshold: int = 512, *, device=None):
    """SELECT d.cat, SUM(f.value) FROM fact f JOIN dim d ON f.key = d.key
    WHERE f.value < threshold GROUP BY d.cat: the star-schema shape.

    Generate a fact table on `device` (None = "cuda") with keys in
    [0, dim_rows) and a dimension of dim_rows keys with Threefry
    categories -> filter_compact -> hash_join on the direct band probe (the
    dimension fits one window: dim_rows <= 16384) -> group_aggregate_prefix
    over the joined category. Returns (count of kept rows, the (num_cats,)
    uint32 table indexed by category).
    """
    keys, values = generate_table(n, seed, key_space=dim_rows, device=device)
    ids = torch.arange(dim_rows, dtype=torch.int32, device=keys.device)
    dim_keys = ids.view(torch.uint32)
    dim_cat = (widen_u32(threefry.random_bits(seed + 1, ids, 2))
               % num_cats).to(torch.int32)
    count, fvals, fkeys = filter_compact(
        values, lambda v: widen_u32(v) < threshold, keys)
    _, cats = hash_join(dim_keys, dim_cat, fkeys, build_sorted=True,
                        probe_impl="direct")
    gk, tbl, gcnt = group_aggregate_prefix(
        cats, fvals, count, num_groups=num_cats, agg="sum",
        key_bits=_key_bits(num_cats))
    return count, _by_group_id(gk, tbl, gcnt, num_cats)


def q1_query(n: int, num_groups: int = 64, seed: int = 0,
             threshold: int = 768, *, device=None):
    """SELECT key, SUM(qty), SUM(price), MIN(qty), MAX(price), COUNT(*),
    AVG(price) FROM t WHERE qty < threshold GROUP BY key: the TPC-H Q1
    shape, one group_aggregate_cols call in its fused-WHERE form (the mask
    leads the sort, packed above the key).

    Returns (count, group_keys, tables, group_count), tables the six
    aggregate columns in the SELECT order.
    """
    ids = torch.arange(n, dtype=torch.int32, device=default_device(device))

    def column(counter: int, modulus: int) -> torch.Tensor:
        bits = threefry.random_bits(seed, ids, counter)
        return (widen_u32(bits) % modulus).to(torch.int32)
    keys = column(0, num_groups)
    qty = column(1, 1024)
    price = column(2, 10000)
    mask = qty < threshold
    count = mask.sum(dtype=torch.int64)
    gk, tables, gcnt = group_aggregate_cols(
        keys, (qty, price, qty, price, qty, price),
        ("sum", "sum", "min", "max", "count", "mean"),
        num_groups=num_groups, valid_mask=mask,
        key_bits=_key_bits(num_groups))
    return count, gk, tables, gcnt


def rollup_query(n: int, dim_rows: int = 1 << 20, seed: int = 0,
                 *, defer: bool = False, device=None):
    """SELECT f.key, SUM(f.measure) FROM fact f SEMI JOIN dim d ON f.key =
    d.key GROUP BY f.key: the big-dimension rollup.

    The fact table (keys in [0, 2 * dim_rows), measures as int32) is
    generated on `device` (None = "cuda"); the dimension holds the even
    keys. The banded join emits the probe rows in key order with the
    measure and the key riding its probe sort (sorted_output, probe_cols),
    and the aggregate takes them with keys_sorted=True: one sort in all.
    The join runs its serving form (defer_overflow=True), so a call reads
    the band overflow flag on the host once, and re-runs through the merge
    probe when it fired (extreme skew).

    Returns (group_keys, sums, count) per distinct fact key, in ascending
    order: the sum of its measures where the key is in dim (even keys),
    zero otherwise. defer=True skips the host read and appends the flag
    (False means the answer is exact; see defer.verify_deferred).
    """
    keys, measures = generate_table(n, seed, key_space=2 * dim_rows,
                                    device=device)
    measures = measures.view(torch.int32)  # values < 2^10: same numbers
    ids = torch.arange(dim_rows, dtype=torch.int32, device=keys.device)
    dim_keys = (ids * 2).view(torch.uint32)

    def run(impl: str):
        found, _, _, (m_s, k_s), ovf = hash_join(
            dim_keys, ids, keys, build_sorted=True, sorted_output=True,
            probe_impl=impl, probe_cols=(measures, keys),
            defer_overflow=True)
        contrib = torch.where(found, m_s, 0)
        return group_aggregate_sorted(k_s, contrib, num_groups=2 * dim_rows,
                                      agg="sum", keys_sorted=True), ovf

    out, ovf = run("banded")
    if defer:
        return out + (ovf,)
    if bool(ovf):  # extreme skew overflowed a band window: exact fallback
        out, _ = run("merge")
    return out
