"""numpy oracles for the query bench CLIs (exec_bench, pipeline_probe,
bench_all).

Each check takes the host inputs and the operator's outputs (tensors on any
device) and returns a list of what failed, empty when the outputs equal what
numpy computes from the inputs. The JAX CLIs compared `use_pallas=True` with
`use_pallas=False`, sampled a few rows or checked nothing; the port has no
`use_pallas`, so every row is held to numpy instead.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.defer import DeferredOverflowError, verify_deferred
from cl_ops_tpu_torch.ops.rng import threefry


def q1_columns(n: int, num_groups: int, seed: int, device):
    """Host copies of q1_query's (keys, qty, price), generated as it
    generates them."""
    ids = torch.arange(n, dtype=torch.int32, device=device)
    return tuple(
        interop.to_numpy((interop.widen_u32(threefry.random_bits(
            seed, ids, c)) % mod).to(torch.int32))
        for c, mod in ((0, num_groups), (1, 1024), (2, 10000)))


def _np(t) -> np.ndarray:
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _expect(fails: list, what: str, ok) -> None:
    if not bool(ok):
        fails.append(what)


def deferred(dropped, op_name: str) -> list[str]:
    """A check="defer" result's dropped counters (Shardeds), this process's
    positions through defer.verify_deferred: what fired, or nothing."""
    try:
        verify_deferred([d.shards for d in dropped], op_name=op_name)
    except DeferredOverflowError as e:
        return [str(e)]
    return []


def filter_rows(data, mask, count, packed, *extra) -> list[str]:
    """filter_compact: the count, then data[mask] and each carried column's
    kept rows, in input order, at the front. `extra` alternates host column
    and packed output."""
    fails = []
    c = int(count)
    _expect(fails, f"filter count {c} != {int(mask.sum())}",
            c == int(mask.sum()))
    _expect(fails, "filter rows differ from data[mask]",
            np.array_equal(_np(packed)[:c], data[mask]))
    for i, (col, out) in enumerate(zip(extra[::2], extra[1::2])):
        _expect(fails, f"filter column {i} differs from col[mask]",
                np.array_equal(_np(out)[:c], col[mask]))
    return fails


def group_sums(keys, vals, num_groups: int, gk, table, count) -> list[str]:
    """group_aggregate_sorted(agg="sum"): every present key ascending, its
    sum (np.bincount, exact below 2^53) and zeros past the count."""
    fails = []
    hist = np.bincount(keys, minlength=num_groups)
    present = np.flatnonzero(hist)
    sums = np.bincount(keys, weights=vals, minlength=num_groups)[present]
    c = int(count)
    _expect(fails, f"group count {c} != {len(present)}", c == len(present))
    if c != len(present):
        return fails
    t = _np(table)
    _expect(fails, "group keys", np.array_equal(_np(gk)[:c], present))
    _expect(fails, "group sums", np.array_equal(
        t[:c].astype(np.float64), sums))
    _expect(fails, "group padding sums are not 0", (t[c:] == 0).all())
    return fails


def join_probe(probe, found, vals, rows=None, *, mul=7, add=1) -> list[str]:
    """hash_join against a dimension of every key < its size with values
    key * mul + add: every probe found and its value exact. With `rows`
    (sorted_output) the output rows are a permutation of the probes in
    ascending key order."""
    fails = []
    keys = probe
    if rows is not None:
        r = _np(rows).astype(np.int64)
        _expect(fails, "join rows are not a permutation of the probes",
                r.size == probe.size and (np.bincount(
                    r, minlength=probe.size) == 1).all())
        if fails:
            return fails
        keys = probe[r]
        _expect(fails, "join rows are not in key order",
                (keys[1:] >= keys[:-1]).all())
    _expect(fails, "join: a probe not found", _np(found).all())
    want = (keys.astype(np.uint64) * mul + add).astype(np.uint32)
    _expect(fails, f"join values differ from key * {mul} + {add}",
            np.array_equal(_np(vals).view(np.uint32), want))
    return fails


def expansion(probe, build_keys, build_vals, capacity: int, total, pidx,
              vals) -> list[str]:
    """hash_join_expand against a sorted build side: the match total, then
    every pair in (probe key, probe position) order, each probe's matches
    in build order, and -1 past the total."""
    fails = []
    order = np.argsort(probe, kind="stable")
    sp = probe[order]
    lb = np.searchsorted(build_keys, sp, "left")
    counts = np.searchsorted(build_keys, sp, "right") - lb
    want_total = int(counts.sum())
    _expect(fails, f"expand total {int(total)} != {want_total}",
            int(total) == want_total)
    k = min(want_total, capacity)
    starts = np.cumsum(counts) - counts
    brow = np.repeat(lb - starts, counts)[:k] + np.arange(k)
    p, v = _np(pidx), _np(vals)
    _expect(fails, "expand probe rows", np.array_equal(
        p[:k], np.repeat(order, counts)[:k]))
    _expect(fails, "expand rows past the total are not -1",
            (p[k:] == -1).all())
    _expect(fails, "expand values", np.array_equal(
        v[:k], build_vals[brow]))
    return fails


def _lex_order(keys, order) -> np.ndarray:
    """np.lexsort((arange(n), order, keys)). Where the ranges of keys,
    order and position fit 64 bits together, one unstable sort of the three
    packed into a uint64 instead of lexsort's three stable passes: the
    position makes every packed value distinct, so the order is the same."""
    n = keys.size
    cols = [c.astype(np.int64) - int(c.min()) for c in (keys, order)
            if n and c.dtype.kind in "iub" and c.dtype.itemsize <= 4]
    if len(cols) == 2:
        bits = [int(c.max()).bit_length() for c in cols]
        bits.append((n - 1).bit_length())
        if sum(bits) <= 64:
            packed = np.zeros(n, np.uint64)
            for c, b in zip(cols + [np.arange(n)], bits):
                packed = (packed << np.uint64(b)) | c.astype(np.uint64)
            low = np.uint64((1 << bits[-1]) - 1)
            return (np.sort(packed) & low).astype(np.int64)
    return np.lexsort((np.arange(n), order, keys))


def window_oracle(keys, order, vals):
    """(idx, run sum, row number) of sum + row_number over (key, order,
    position): idx is the window order, the rest in that order."""
    n = keys.size
    idx = _lex_order(keys, order)
    sk = keys[idx]
    start = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    run_len = np.diff(np.r_[start, n])
    csum = np.cumsum(vals[idx], dtype=np.int64)
    run_sum = csum - np.repeat(np.r_[0, csum[start[1:] - 1]], run_len)
    row_num = np.arange(n) - np.repeat(start, run_len) + 1
    return idx, run_sum, row_num


def window(oracle, wsum, wrow, row_src=None) -> list[str]:
    """window_cols(("sum", "row_number")) in input order, or with row_src
    (sorted_output) in the window order."""
    idx, run_sum, row_num = oracle
    fails = []
    s, r = _np(wsum).astype(np.int64), _np(wrow).astype(np.int64)
    if row_src is None:
        s, r = s[idx], r[idx]
    else:
        _expect(fails, "window row_src differs from the window order",
                np.array_equal(_np(row_src), idx))
    _expect(fails, "window sums", np.array_equal(s, run_sum))
    _expect(fails, "window row numbers", np.array_equal(r, row_num))
    return fails


def top_k(vals, pay, k: int, tv, tp) -> list[str]:
    """top_k: the k smallest values in numpy's stable order, and their
    payloads."""
    kth = np.partition(vals, k - 1)[k - 1]
    cand = np.flatnonzero(vals <= kth)
    want = cand[np.argsort(vals[cand], kind="stable")][:k]
    fails = []
    _expect(fails, "topk values", np.array_equal(_np(tv), vals[want]))
    _expect(fails, "topk payload", np.array_equal(_np(tp), pay[want]))
    return fails


def distinct(keys, uv, count) -> list[str]:
    """distinct: np.unique in the first `count` slots."""
    uniq = np.unique(keys)
    c = int(count)
    fails = []
    _expect(fails, f"distinct count {c} != {len(uniq)}", c == len(uniq))
    _expect(fails, "distinct values", c == len(uniq)
            and np.array_equal(_np(uv)[:c], uniq))
    return fails


def q1(keys, qty, price, num_groups: int, threshold: int, count, gk, tables,
       gcount) -> list[str]:
    """q1_query: the kept count, the group keys, sum(qty), sum(price),
    min(qty), max(price), count and the float32 mean of price (JAX's
    int32 / int32 division)."""
    m = qty < threshold
    k, q, p = keys[m], qty[m], price[m]
    uniq = np.unique(k)
    g = len(uniq)
    fails = []
    _expect(fails, "q1 counts", int(count) == int(m.sum())
            and int(gcount) == g)
    if fails:
        return fails
    cnt = np.bincount(k, minlength=num_groups)[uniq]
    mn = np.full(num_groups, 2 ** 31 - 1, np.int64)
    mx = np.full(num_groups, -2 ** 31, np.int64)
    np.minimum.at(mn, k, q)
    np.maximum.at(mx, k, p)
    sq = np.bincount(k, weights=q, minlength=num_groups)[uniq]
    sp = np.bincount(k, weights=p, minlength=num_groups)[uniq]
    tabs = [_np(t)[:g] for t in tables]
    _expect(fails, "q1 keys", np.array_equal(_np(gk)[:g], uniq))
    for name, got, want in (("sum qty", tabs[0], sq),
                            ("sum price", tabs[1], sp),
                            ("min qty", tabs[2], mn[uniq]),
                            ("max price", tabs[3], mx[uniq]),
                            ("count", tabs[4], cnt)):
        _expect(fails, f"q1 {name}", np.array_equal(got, want))
    _expect(fails, "q1 mean", np.array_equal(
        tabs[5], sp.astype(np.float32) / cnt.astype(np.float32))
        and (np.abs(tabs[5] - sp / cnt) <= 2 ** -23 * sp / cnt).all())
    return fails


def rollup(keys, measures, gk, table, count) -> list[str]:
    """rollup_query: per distinct fact key ascending, the sum of its
    measures where the key is even (in the dimension), else 0."""
    uniq = np.unique(keys)
    contrib = np.where(keys % 2 == 0, measures.astype(np.int64), 0)
    sums = np.bincount(keys, weights=contrib)[uniq]
    c = int(count)
    fails = []
    _expect(fails, f"rollup count {c} != {len(uniq)}", c == len(uniq))
    if not fails:
        _expect(fails, "rollup keys", np.array_equal(_np(gk)[:c], uniq))
        _expect(fails, "rollup sums", np.array_equal(
            _np(table)[:c].astype(np.float64), sums))
    return fails
