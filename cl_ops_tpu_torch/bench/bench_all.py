"""All of the JAX package's benchmark configs at size, one JSON line each.

Counterpart of the repository's `bench_all.py`, with its twelve configs,
fifteen metrics (names and units), data and flags (`--scale`, `--runs`,
`--configs`, `--tune`):
   1. sort_u32_1M                abitonic autotune=1, 1M u32      Mkeys/s
   2. sort_u64kv_16M             abitonic autotune=1, 16M u64+i32 Mpairs/s
   3. filter_64M_sel10           filter_compact, 64M u32, 10%     Mrows/s
   4. aggregate_256M_1Mgroups    GROUP BY sum, 256M rows, 1M keys Mrows/s
   5. join_probe_16Mx1M          hash_join 16M x 1M; _sorted      Mrows/s
      (sorted_output) and _deferred (sorted_output, defer_overflow)
  12. join_probe_256Mx16M        hash_join 256M x 16M, deferred   Mrows/s
   6. join_expand_16Mx4          hash_join_expand, 4M build       Mpairs/s
   7. rollup_16Mx1M              rollup_query(defer=True)         Mrows/s
   8. q1_16Mx64K                 q1_query                         Mrows/s
   9. window_16Mx64K; _sorted    sum + row_number, both forms     Mrows/s
  10. topk_1K_of_64M             top_k with a payload             Mrows/s
  11. distinct_64M_1M            distinct                         Mrows/s
The inputs are the JAX CLI's: `common.rand_array` seeds 1-2,
`np.random.RandomState` seeds 3-16, the pipelines' Threefry tables. Each
rate is rows per second of one call, timed by `time_adaptive` (a batch of
at least `--runs` calls, deepened to fill `--target-s`). Each row's
`gb_s` and `roofline_frac` come from the JAX CLI's bytes models, on the
port's functions (`sort_traffic_bytes`, `band_pass_traffic_bytes`,
`abitonic_traffic_bytes`; q1 sorts 3 columns here, 4 in JAX; the filter
partitions, `partition_traffic_bytes`, where JAX sorts), and need the
card's measured stream ceiling or `$CL_OPS_ROOFLINE_GBS`.

Every config's output is checked against numpy first (where the JAX CLI
checked nothing, spot-checked, or compared totals with its use_pallas=False
path). A config whose check fails, or that raises, prints a row with an
`error` field; the others still run, and the CLI exits 1. Rows go to
stdout, and as JSON lines to `--out PATH` when given; this CLI never reads
or writes the JAX CLI's BENCH_ALL.json. Each config is a module-level
function `config_<k>(ctx)` returning (rows, outputs) and its numpy inputs
come from `data_<k>(scale)`, so tests can reach both.

    python -m cl_ops_tpu_torch.bench.bench_all              # on the card
    python -m cl_ops_tpu_torch.bench.bench_all --scale 4096 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import checks, common
from cl_ops_tpu_torch.bench.roofline import GBS_ENV, roofline_row
from cl_ops_tpu_torch.models import pipeline as pl
from cl_ops_tpu_torch.ops import exec as ex
from cl_ops_tpu_torch.ops.exec import bandprobe, psort
from cl_ops_tpu_torch.ops.exec import join as jn
from cl_ops_tpu_torch.ops.scan import kernels as sk
from cl_ops_tpu_torch.ops.sort import sort_new
from cl_ops_tpu_torch.ops.sort.bitonic import abitonic_traffic_bytes
from cl_ops_tpu_torch.utils.platform import default_device

# The metrics of each config, in the JAX CLI's order of running.
METRICS = {
    1: (("sort_u32_1M", "Mkeys/s"),),
    2: (("sort_u64kv_16M", "Mpairs/s"),),
    3: (("filter_64M_sel10", "Mrows/s"),),
    4: (("aggregate_256M_1Mgroups", "Mrows/s"),),
    5: (("join_probe_16Mx1M", "Mrows/s"),
        ("join_probe_16Mx1M_sorted", "Mrows/s"),
        ("join_probe_16Mx1M_deferred", "Mrows/s")),
    12: (("join_probe_256Mx16M", "Mrows/s"),),
    6: (("join_expand_16Mx4", "Mpairs/s"),),
    7: (("rollup_16Mx1M", "Mrows/s"),),
    8: (("q1_16Mx64K", "Mrows/s"),),
    9: (("window_16Mx64K", "Mrows/s"), ("window_16Mx64K_sorted", "Mrows/s")),
    10: (("topk_1K_of_64M", "Mrows/s"),),
    11: (("distinct_64M_1M", "Mrows/s"),),
}
FILTER_THRESHOLD = int(0.10 * (1 << 20))


@dataclass
class Ctx:
    """What every config needs: the device, the scale divisor of its row
    counts and the timing depth."""
    device: torch.device
    scale: int = 1
    runs: int = 5
    target_s: float = 2.0

    def put(self, array) -> torch.Tensor:
        return interop.to_torch(array, self.device)

    def row(self, metric, unit, count, fn, fargs, bytes_moved, fails):
        """A metric's row: the failed checks as `error`, else `count`
        rows per second of one call (value, rounded as the JAX CLI does;
        ms unrounded) with the roofline columns."""
        row = {"metric": metric, "unit": unit}
        if fails:
            row.update(value=None, error="; ".join(fails))
            return row
        sync = common.default_sync(self.device)
        dt = common.time_adaptive(fn, fargs, sync, min_runs=self.runs,
                                  target_s=self.target_s)
        row.update(value=round(count / dt / 1e6, 1), ms=dt * 1e3)
        if self.device.type == "cuda" or os.environ.get(GBS_ENV):
            row.update(roofline_row(bytes_moved, dt))
        return row


def _sort_check(name, got, want) -> list[str]:
    return [] if np.array_equal(interop.to_numpy(got), want) else \
        [f"{name} differ from np.sort"]


# --- 1-2: the sorts -----------------------------------------------------------

def data_1(scale):
    return common.rand_array(np.uint32, (1 << 20) // scale, 1)


def config_1(ctx):
    # the tuner collapses the launch-bound two-tier schedule at this size
    x = data_1(ctx.scale)
    s = sort_new("abitonic", "autotune=1")
    dx = ctx.put(x)
    out = s.sort_with_device_data(dx)
    fails = _sort_check("sorted keys", out, np.sort(x))
    return [ctx.row("sort_u32_1M", "Mkeys/s", x.size, s.sort_with_device_data,
                    (dx,), abitonic_traffic_bytes(x.size, 1), fails)], \
        {"sorted": out}


def data_2(scale):
    n = (1 << 24) // scale
    return common.rand_array(np.uint64, n, 2), np.arange(n, dtype=np.int32)


def config_2(ctx):
    k64, v32 = data_2(ctx.scale)
    s = sort_new("abitonic", "autotune=1", elem_dtype="ulong")
    dk, dv = ctx.put(k64), ctx.put(v32)
    ok, ov = s.sort_with_device_data(dk, dv)
    fails = _sort_check("sorted keys", ok, np.sort(k64))
    perm = interop.to_numpy(ov).astype(np.int64)
    if not (np.array_equal(np.sort(perm), v32)
            and np.array_equal(k64[perm], np.sort(k64))):
        fails.append("values are not the keys' permutation")
    return [ctx.row("sort_u64kv_16M", "Mpairs/s", k64.size,
                    s.sort_with_device_data, (dk, dv),
                    abitonic_traffic_bytes(k64.size, 3), fails)], \
        {"sorted": (ok, ov)}


# --- 3-4: filter and GROUP BY -------------------------------------------------

def data_3(scale):
    return np.random.RandomState(3).randint(
        0, 1 << 20, size=(1 << 26) // scale).astype(np.uint32)


def config_3(ctx):
    x = data_3(ctx.scale)
    n = x.size

    def fn(v):
        return ex.filter_compact(
            v, lambda d: interop.widen_u32(d) < FILTER_THRESHOLD)
    dx = ctx.put(x)
    out = fn(dx)
    fails = checks.filter_rows(x, x < FILTER_THRESHOLD, *out)
    return [ctx.row("filter_64M_sel10", "Mrows/s", n, fn, (dx,),
                    sk.partition_traffic_bytes(n, (4,)), fails)], \
        {"filter": out}


def data_4(scale):
    n = (1 << 28) // scale
    groups = (1 << 20) // max(scale // 16, 1)
    keys = np.random.RandomState(4).randint(0, groups, size=n) \
        .astype(np.uint32)
    vals = np.random.RandomState(5).randint(0, 100, size=n).astype(np.int32)
    return keys, vals, groups


def config_4(ctx):
    keys, vals, groups = data_4(ctx.scale)
    n = keys.size

    def fn(k, v):
        return ex.group_aggregate_sorted(k, v, num_groups=groups)
    dk, dv = ctx.put(keys), ctx.put(vals)
    out = fn(dk, dv)
    fails = checks.group_sums(keys, vals, groups, *out)
    # the (key, value) sort + the boundary passes
    return [ctx.row("aggregate_256M_1Mgroups", "Mrows/s", n, fn, (dk, dv),
                    psort.sort_traffic_bytes(n, 2) + 6 * 4 * n, fails)], \
        {"aggregate": out}


# --- 5, 12: the join probe ----------------------------------------------------

def _dim_and_probe(m, nd, seed_dim, seed_probe):
    """A shuffled arange dimension with values key * 7 + 1, and probes
    uniform over its keys."""
    dim = np.arange(nd, dtype=np.uint32)
    np.random.RandomState(seed_dim).shuffle(dim)
    dimv = (dim * 7 + 1).astype(np.uint32)
    probe = np.random.RandomState(seed_probe).randint(0, nd, size=m) \
        .astype(np.uint32)
    return dim, dimv, probe


def data_5(scale):
    return _dim_and_probe((1 << 24) // scale, (1 << 20) // scale, 6, 7)


def data_12(scale):
    return _dim_and_probe((1 << 28) // scale, (1 << 24) // scale, 15, 16)


def _join_check(probe, out, sorted_output, deferred):
    fails = []
    if deferred:
        out, ovf = out[:-1], out[-1]
        if bool(ovf):
            fails.append("band overflow flag set")
    return fails + checks.join_probe(probe, *out[:2],
                                     out[2] if sorted_output else None)


def config_5(ctx):
    dim, dimv, probe = data_5(ctx.scale)
    m, nd = probe.size, dim.size
    sdk, sdv = sort_new("abitonic").sort_with_device_data(ctx.put(dim),
                                                          ctx.put(dimv))
    dp = ctx.put(probe)
    sort2 = psort.sort_traffic_bytes(m, 2)
    band = bandprobe.band_pass_traffic_bytes(m, 1, nd,
                                             jn._band_probe_rows(m, nd))
    rows, outs = [], {"build": (sdk, sdv)}
    # the restore form; sorted_output drops the restore sort; the serving
    # form also keeps the overflow check off the call (deferred flag)
    for (metric, unit), kw, nbytes in zip(
            METRICS[5],
            ({}, {"sorted_output": True},
             {"sorted_output": True, "defer_overflow": True}),
            (2 * sort2 + band, sort2 + band, sort2 + band)):
        def fn(p, kw=kw):
            return ex.hash_join(sdk, sdv, p, build_sorted=True, **kw)
        out = fn(dp)
        fails = _join_check(probe, out, bool(kw), "defer_overflow" in kw)
        rows.append(ctx.row(metric, unit, m, fn, (dp,), nbytes, fails))
        outs[metric] = out
    return rows, outs


def config_12(ctx):
    # the largest slice of BASELINE config 5 ("1B fact x 100M dim") that
    # the JAX CLI took to one chip, in the join's serving form
    dim, dimv, probe = data_12(ctx.scale)
    m, nd = probe.size, dim.size
    sdk, sdv = sort_new("abitonic").sort_with_device_data(ctx.put(dim),
                                                          ctx.put(dimv))
    dp = ctx.put(probe)

    def fn(p):
        return ex.hash_join(sdk, sdv, p, build_sorted=True,
                            sorted_output=True, defer_overflow=True)
    out = fn(dp)
    fails = _join_check(probe, out, True, True)
    return [ctx.row("join_probe_256Mx16M", "Mrows/s", m, fn, (dp,),
                    psort.sort_traffic_bytes(m, 2)
                    + bandprobe.band_pass_traffic_bytes(
                        m, 1, nd, jn._band_probe_rows(m, nd)), fails)], \
        {"build": (sdk, sdv), "join": out}


# --- 6: the join expansion ----------------------------------------------------

def data_6(scale):
    m = (1 << 24) // scale
    nd = (1 << 22) // scale
    nkeys = max(nd // 4, 1)
    dk = np.arange(nd, dtype=np.uint32) % nkeys
    np.random.RandomState(8).shuffle(dk)
    dv = np.arange(nd, dtype=np.int32)
    pk = np.random.RandomState(9).randint(0, nkeys, size=m).astype(np.uint32)
    return dk, dv, pk, 4 * m


def config_6(ctx):
    dk, dv, pk, cap = data_6(ctx.scale)
    m, nd = pk.size, dk.size
    sdk, sdv = sort_new("xla", elem_dtype="uint").sort_with_device_data(
        ctx.put(dk), ctx.put(dv))
    dp = ctx.put(pk)

    def fn(p):
        return ex.hash_join_expand(sdk, sdv, p, capacity=cap,
                                   build_sorted=True)
    out = fn(dp)
    fails = checks.expansion(pk, interop.to_numpy(sdk), interop.to_numpy(sdv),
                             cap, *out)
    # the probe sort, two range band passes, the cumsum, pass 1's 3-value
    # band pass, pass 2's value pull (128-row probe blocks), glue writes
    nbytes = (psort.sort_traffic_bytes(m, 2)
              + 2 * bandprobe.band_pass_traffic_bytes(
                  m, 1, nd, jn._band_probe_rows(m, nd))
              + 2 * 4 * m
              + bandprobe.band_pass_traffic_bytes(cap, 1, m, 128, n_vals=3)
              + bandprobe.band_pass_traffic_bytes(cap, 1, nd, 128)
              + 3 * 4 * cap)
    return [ctx.row("join_expand_16Mx4", "Mpairs/s", cap, fn, (dp,), nbytes,
                    fails)], {"build": (sdk, sdv), "expand": out}


# --- 7-8: the pipelines -------------------------------------------------------

def config_7(ctx):
    # the rollup's restore-free fusion: one probe sort for the pipeline,
    # in the serving form (the overflow flag returned, checked clear)
    n = (1 << 24) // ctx.scale
    nd = max((1 << 20) // ctx.scale, 64)

    def fn():
        return pl.rollup_query(n, dim_rows=nd, defer=True, device=ctx.device)
    gk, table, cnt, ovf = fn()
    keys, meas = pl.generate_table(n, 0, key_space=2 * nd, device=ctx.device)
    fails = ["band overflow flag set"] if bool(ovf) else []
    fails += checks.rollup(interop.to_numpy(keys), interop.to_numpy(meas),
                           gk, table, cnt)
    del keys, meas
    # the probe sort (key, position, 2 payload columns), the band pass and
    # the aggregate's boundary passes
    nbytes = (psort.sort_traffic_bytes(n, 4)
              + bandprobe.band_pass_traffic_bytes(
                  n, 1, nd, jn._band_probe_rows(n, nd)) + 8 * 4 * n)
    return [ctx.row("rollup_16Mx1M", "Mrows/s", n, fn, (), nbytes, fails)], \
        {"rollup": (gk, table, cnt, ovf)}


def config_8(ctx):
    # TPC-H Q1's shape: WHERE, then six aggregates over 64K groups
    n = (1 << 24) // ctx.scale
    g = max((1 << 16) // ctx.scale, 16)

    def fn():
        return pl.q1_query(n, num_groups=g, device=ctx.device)
    out = fn()
    fails = checks.q1(*checks.q1_columns(n, g, 0, ctx.device), g, 768, *out)
    # one fused (validity | key, qty, price) sort + the boundary passes
    return [ctx.row("q1_16Mx64K", "Mrows/s", n, fn, (),
                    psort.sort_traffic_bytes(n, 3) + 12 * 4 * n, fails)], \
        {"q1": out}


# --- 9-11: window, top-k, DISTINCT --------------------------------------------

def data_9(scale):
    n = (1 << 24) // scale
    g = max((1 << 16) // scale, 16)
    wk = np.random.RandomState(9).randint(0, g, size=n).astype(np.uint32)
    wo = np.random.RandomState(10).randint(0, 1 << 30, size=n) \
        .astype(np.uint32)
    wv = np.random.RandomState(11).randint(0, 100, size=n).astype(np.int32)
    return wk, wo, wv


def config_9(ctx):
    wk, wo, wv = data_9(ctx.scale)
    n = wk.size
    oracle = checks.window_oracle(wk, wo, wv)
    dargs = tuple(ctx.put(a) for a in (wk, wo, wv))
    # two segmented scans and the flags; the restore form adds a 3-column
    # restore sort
    seg = 2 * 3 * 4 * n + 4 * n
    rows, outs = [], {}
    for (metric, unit), so, nbytes in zip(
            METRICS[9], (False, True),
            (psort.sort_traffic_bytes(n, 4) + seg
             + psort.sort_traffic_bytes(n, 3),
             psort.sort_traffic_bytes(n, 4) + seg)):
        def fn(k, o, v, so=so):
            return ex.window_cols(k, o, (v, None), ("sum", "row_number"),
                                  sorted_output=so)
        out = fn(*dargs)
        fails = checks.window(oracle, *out[0], out[1]) if so \
            else checks.window(oracle, *out)
        rows.append(ctx.row(metric, unit, n, fn, dargs, nbytes, fails))
        outs[metric] = out
    return rows, outs


def data_10(scale):
    n = (1 << 26) // scale
    tv = np.random.RandomState(12).randint(0, 1 << 30, size=n) \
        .astype(np.uint32)
    tp = np.random.RandomState(13).randint(0, 1 << 30, size=n) \
        .astype(np.int32)
    return tv, tp, min(1024, n // 16)


def config_10(ctx):
    tv, tp, k = data_10(ctx.scale)
    n = tv.size

    def fn(v, p):
        return ex.top_k(v, k, p)
    dargs = (ctx.put(tv), ctx.put(tp))
    out = fn(*dargs)
    fails = checks.top_k(tv, tp, k, *out)
    # the block-extraction form: mask build, four int8 sweeps; no n-row sort
    return [ctx.row("topk_1K_of_64M", "Mrows/s", n, fn, dargs,
                    4 * n + n + 4 * 2 * n, fails)], {"topk": out}


def data_11(scale):
    n = (1 << 26) // scale
    du = max((1 << 20) // scale, 16)
    return np.random.RandomState(14).randint(0, du, size=n) \
        .astype(np.uint32), du


def config_11(ctx):
    keys, du = data_11(ctx.scale)
    n = keys.size

    def fn(k):
        return ex.distinct(k, capacity=du)
    dk = ctx.put(keys)
    out = fn(dk)
    fails = checks.distinct(keys, *out)
    # the key-only sort + the boundary passes
    return [ctx.row("distinct_64M_1M", "Mrows/s", n, fn, (dk,),
                    psort.sort_traffic_bytes(n, 1) + 4 * 4 * n, fails)], \
        {"distinct": out}


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5,
           12: config_12, 6: config_6, 7: config_7, 8: config_8, 9: config_9,
           10: config_10, 11: config_11}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=int, default=1,
                    help="divide all row counts by this (smoke testing)")
    ap.add_argument("--runs", type=int, default=5,
                    help="the least batch depth of a timing")
    ap.add_argument("--target-s", type=float, default=2.0,
                    help="seconds a timing batch is deepened to fill")
    ap.add_argument("--configs", default="1,2,3,4,5,6,7,8,9,10,11,12",
                    help="comma list of config numbers to run")
    ap.add_argument("--tune", action="store_true",
                    help="autotune the operators' internal sorts too "
                         "(CL_OPS_PSORT_AUTOTUNE=1 while the CLI runs)")
    ap.add_argument("--out", default=None,
                    help="also write the rows to this file, JSON lines")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    wanted = {int(c) for c in args.configs.split(",")}
    unknown = wanted - CONFIGS.keys()
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")
    ctx = Ctx(default_device(args.device), args.scale, args.runs,
              args.target_s)
    kind = torch.cuda.get_device_name(ctx.device) \
        if ctx.device.type == "cuda" else "cpu"
    saved = os.environ.get("CL_OPS_PSORT_AUTOTUNE")
    if args.tune:
        os.environ["CL_OPS_PSORT_AUTOTUNE"] = "1"
    rows = []
    try:
        for num, config in CONFIGS.items():
            if num not in wanted:
                continue
            try:
                got, _ = config(ctx)
            except Exception as e:  # one config's fault: the rest still run
                traceback.print_exc()
                got = [{"metric": m, "unit": u, "value": None,
                        "error": f"{type(e).__name__}: {e}"}
                       for m, u in METRICS[num]]
            for row in got:
                row["device"] = kind
                print(json.dumps(row), flush=True)
            rows += got
    finally:
        if args.tune:
            if saved is None:
                del os.environ["CL_OPS_PSORT_AUTOTUNE"]
            else:
                os.environ["CL_OPS_PSORT_AUTOTUNE"] = saved
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 1 if any("error" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
