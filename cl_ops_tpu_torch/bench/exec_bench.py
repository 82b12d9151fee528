"""Query-operator benchmark CLI: the north-star operator configs.

Counterpart of `cl_ops_tpu/bench/exec_bench.py`, with its ops, flags,
defaults and data: the same `np.random.RandomState(--rng-seed)` draws in the
same order, so a seed gives the JAX CLI's inputs.
  filter     prefix-sum filter + compaction, 10% selectivity
  aggregate  GROUP BY sum over 2^20 groups
  join       dimension build + fact probe (Zipf-skewed keys with --zipf)
  expand     the full inner-join expansion (--dup matches per probe)
  window     sum + row_number over (key, order) partitions
  topk       LIMIT k with a payload column
  distinct   SELECT DISTINCT
Every output row is checked against numpy (the JAX CLI sampled a few rows or
compared with its use_pallas=False path, which the port does not have); a
failed check prints what failed and exits 1. Runs on the card unless given
`--device cpu`; the GB/s and roofline columns need the card's measured
stream ceiling, or `$CL_OPS_ROOFLINE_GBS`.

Usage:
  python -m cl_ops_tpu_torch.bench.exec_bench --op filter -n 26 -r 5
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import checks, common
from cl_ops_tpu_torch.bench.roofline import GBS_ENV, roofline_row
from cl_ops_tpu_torch.ops import exec as ex
from cl_ops_tpu_torch.ops.exec import bandprobe, psort
from cl_ops_tpu_torch.ops.exec import join as jn
from cl_ops_tpu_torch.ops.scan import kernels as sk
from cl_ops_tpu_torch.ops.sort import sort_new
from cl_ops_tpu_torch.utils.platform import default_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--op", default="filter",
                   choices=["filter", "aggregate", "join", "expand",
                            "window", "topk", "distinct"])
    p.add_argument("--k", type=int, default=1024,
                   help="topk: LIMIT k")
    p.add_argument("--sorted-output", action="store_true",
                   help="window: skip the restore sort (the consumer-"
                        "re-sorts-anyway fusion form)")
    p.add_argument("--dup", type=int, default=4,
                   help="expand: matches per probe (build dups)")
    p.add_argument("--sparse", action="store_true",
                   help="expand: stride probes across the whole build; "
                        "where there are fewer probes than build keys, one "
                        "output block spans more build rows than the band "
                        "window, which takes the direct-gather fallback "
                        "for pass 2")
    p.add_argument("-n", "--log2n", type=int, default=24,
                   help="rows = 2^log2n (default 24)")
    p.add_argument("-r", "--runs", type=int, default=5)
    p.add_argument("--selectivity", type=float, default=0.10)
    p.add_argument("--groups", type=int, default=1 << 20)
    p.add_argument("--dim-log2", type=int, default=20,
                   help="join build side = 2^dim_log2 rows")
    p.add_argument("--zipf", type=float, default=0.0,
                   help="Zipf exponent for join probe keys (0 = uniform)")
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


# Each op: (args, n, rng, device) -> (fn, fn's arguments, check, bytes
# moved). check(fn's output) returns what failed; bytes moved is the op's
# device-memory model (bench/roofline.py), as in the JAX CLI.

def _filter(args, n, rng, dev):
    thresh = int(args.selectivity * (1 << 20))
    host = rng.randint(0, 1 << 20, size=n).astype(np.uint32)

    def pred(d):
        return interop.widen_u32(d) < thresh

    def check(out):
        return checks.filter_rows(host, host < thresh, *out)
    return (lambda v: ex.filter_compact(v, pred),
            (interop.to_torch(host, dev),), check,
            sk.partition_traffic_bytes(n, (4,)))  # JAX: a 2-column sort


def _aggregate(args, n, rng, dev):
    keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
    vals = rng.randint(0, 100, size=n).astype(np.int32)

    def fn(k, v):
        return ex.group_aggregate_sorted(k, v, num_groups=args.groups)

    def check(out):
        # every group, where the JAX CLI sampled 16
        return checks.group_sums(keys, vals, args.groups, *out)
    # the (key, value) sort + the boundary passes
    return (fn, (interop.to_torch(keys, dev), interop.to_torch(vals, dev)),
            check, psort.sort_traffic_bytes(n, 2) + 6 * 4 * n)


def _sorted_build(keys, vals, dev):
    """The build side sorted by the vendor sorter, as the JAX CLI's
    sort_new("xla")."""
    return sort_new("xla", elem_dtype="uint").sort_with_device_data(
        interop.to_torch(keys, dev), interop.to_torch(vals, dev))


def _expand(args, n, rng, dev):
    nd = 1 << args.dim_log2
    nkeys = max(nd // args.dup, 1)
    dim_keys = np.arange(nd, dtype=np.uint32) % nkeys
    rng.shuffle(dim_keys)
    dim_vals = np.arange(nd, dtype=np.int32)
    if args.sparse:
        # every probe hits, its matches striding the whole build
        stride = max(nkeys // n, 1)
        probe = ((np.arange(n, dtype=np.int64) * stride) % nkeys
                 ).astype(np.uint32)
    else:
        probe = rng.randint(0, nkeys, size=n).astype(np.uint32)
    cap = args.dup * n
    sdk, sdv = _sorted_build(dim_keys, dim_vals, dev)

    def fn(p):
        return ex.hash_join_expand(sdk, sdv, p, capacity=cap,
                                   build_sorted=True)

    def check(out):
        # every pair, as the JAX CLI's full oracle
        return checks.expansion(probe, interop.to_numpy(sdk),
                                interop.to_numpy(sdv), cap, *out)
    # the probe sort, 2 range band passes, the cumsum, pass 1's 3-value
    # band pass, pass 2's value pull (128-row probe blocks), glue writes
    pr = jn._band_probe_rows(n, nd)
    nbytes = (psort.sort_traffic_bytes(n, 2)
              + 2 * bandprobe.band_pass_traffic_bytes(n, 1, nd, pr)
              + 2 * 4 * n
              + bandprobe.band_pass_traffic_bytes(cap, 1, n, 128, n_vals=3)
              + bandprobe.band_pass_traffic_bytes(cap, 1, nd, 128)
              + 3 * 4 * cap)
    return fn, (interop.to_torch(probe, dev),), check, nbytes


def _window(args, n, rng, dev):
    keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
    order = rng.randint(0, 1 << 30, size=n).astype(np.uint32)
    vals = rng.randint(0, 100, size=n).astype(np.int32)
    so = args.sorted_output

    def fn(k, o, v):
        return ex.window_cols(k, o, (v, None), ("sum", "row_number"),
                              sorted_output=so)

    def check(out):
        # every row, where the JAX CLI sampled 8
        oracle = checks.window_oracle(keys, order, vals)
        if so:
            (wsum, wrow), src = out
            return checks.window(oracle, wsum, wrow, src)
        return checks.window(oracle, *out)
    # the 4-column partition sort, the flags, two segmented scans, and the
    # 3-column restore sort unless --sorted-output
    nbytes = psort.sort_traffic_bytes(n, 4) + 4 * n + 2 * 3 * 4 * n
    if not so:
        nbytes += psort.sort_traffic_bytes(n, 3)
    return (fn, tuple(interop.to_torch(a, dev) for a in (keys, order, vals)),
            check, nbytes)


def _topk(args, n, rng, dev):
    vals = rng.randint(0, 1 << 30, size=n).astype(np.uint32)
    pay = rng.randint(0, 1 << 30, size=n).astype(np.int32)

    def check(out):
        return checks.top_k(vals, pay, args.k, *out)
    # the block-extraction form: mask build, four first-survivor sweeps
    # over the int8 mask, the small candidate sort (not counted)
    return (lambda v, p: ex.top_k(v, args.k, p),
            (interop.to_torch(vals, dev), interop.to_torch(pay, dev)), check,
            4 * n + n + 4 * 2 * n)


def _distinct(args, n, rng, dev):
    keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
    cap = 1 << int(args.groups - 1).bit_length()

    def check(out):
        return checks.distinct(keys, *out)
    # the key-only sort + the boundary passes
    return (lambda k: ex.distinct(k, capacity=cap),
            (interop.to_torch(keys, dev),), check,
            psort.sort_traffic_bytes(n, 1) + 4 * 4 * n)


def _join(args, n, rng, dev):
    nd = 1 << args.dim_log2
    dim_keys = np.arange(nd, dtype=np.uint32)
    rng.shuffle(dim_keys)
    dim_vals = (dim_keys * 7 + 1).astype(np.uint32)
    if args.zipf > 0:
        probe = (np.random.default_rng(args.rng_seed)
                 .zipf(args.zipf, size=n) % nd).astype(np.uint32)
    else:
        probe = rng.randint(0, nd, size=n).astype(np.uint32)
    sdk, sdv = _sorted_build(dim_keys, dim_vals, dev)

    def check(out):
        # every probe, where the JAX CLI sampled 16 values
        return checks.join_probe(probe, *out)
    # the auto strategy: a small build side is one window (no probe sort);
    # else the probe sort, one band pass and the restore sort
    if nd <= bandprobe.DIRECT_MAX:
        nbytes = bandprobe.band_pass_traffic_bytes(n, 1, nd)
    else:
        nbytes = (2 * psort.sort_traffic_bytes(n, 2)
                  + bandprobe.band_pass_traffic_bytes(
                      n, 1, nd, jn._band_probe_rows(n, nd)))
    return (lambda p: ex.hash_join(sdk, sdv, p, build_sorted=True),
            (interop.to_torch(probe, dev),), check, nbytes)


OPS = {"filter": _filter, "aggregate": _aggregate, "join": _join,
       "expand": _expand, "window": _window, "topk": _topk,
       "distinct": _distinct}


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = default_device(args.device)
    n = 1 << args.log2n
    rng = np.random.RandomState(args.rng_seed)
    sync = common.default_sync(dev)
    fn, fargs, check, bytes_moved = OPS[args.op](args, n, rng, dev)
    secs = common.time_async(fn, fargs, args.runs, sync)
    if not args.no_check:
        fails = check(fn(*fargs))
        if fails:
            for f in fails:
                print(f"{args.op}: check FAILED: {f}", file=sys.stderr)
            return 1
    mrows = common.throughput_m(n, args.runs, secs)
    extra = ""
    # the roofline needs the card's stream ceiling (or one given)
    if dev.type == "cuda" or os.environ.get(GBS_ENV):
        rr = roofline_row(bytes_moved, secs / args.runs)
        extra = (f"  [{rr['gb_s']:.1f} GB/s, "
                 f"{rr['roofline_frac']:.2f} of ceiling]")
    print(f"{args.op}: {n} rows x {args.runs} runs -> {mrows:.1f} Mrows/s "
          f"({secs / args.runs * 1e3:.2f} ms/run){extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
