"""Sort benchmark CLI — parity with clo_sort_bench.

Counterpart of `cl_ops_tpu/bench/sort_bench.py`, after the reference CLI
(`src/benchmarks/clo_sort_bench.c:49-80`): algorithm, algorithm options,
runs, element type, size sweep 2^minpo2..2^maxpo2, RNG seed, TSV output,
and a per-run host verification pass (`clo_sort_bench.c:216-227`) that
holds the output to np.sort of the input exactly (NaN-aware for floats).
Block options ride --alg-options; --device picks the device (default cuda).

Usage:
  python -m cl_ops_tpu_torch.bench.sort_bench -a abitonic -r 5 --maxpo2 20
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import common
from cl_ops_tpu_torch.bench.roofline import roofline_row
from cl_ops_tpu_torch.core.dtypes import type_info
from cl_ops_tpu_torch.core.registry import parse_options
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.ops.sort import sort_new
from cl_ops_tpu_torch.ops.sort.bitonic import abitonic_traffic_bytes
from cl_ops_tpu_torch.utils.platform import default_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--algorithm", default="abitonic",
                   help="sort impl name (default abitonic)")
    p.add_argument("-o", "--alg-options", default=None,
                   help='impl options "k1=v1,k2=v2" (ref option strings)')
    p.add_argument("-r", "--runs", type=int, default=1)
    p.add_argument("-t", "--type", dest="elem_type", default="uint",
                   help="element type name (default uint)")
    p.add_argument("--minpo2", type=int, default=4)
    p.add_argument("-n", "--maxpo2", type=int, default=24,
                   help="max size = 2^maxpo2 (ref default 24)")
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--out", default=None, help="TSV output file")
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--kv", action="store_true",
                   help="key-value sort (carries an i32 payload)")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = default_device(args.device)
    sorter = sort_new(args.algorithm, args.alg_options,
                      elem_dtype=args.elem_type)
    np_dtype = type_info(sorter.elem_dtype).np_dtype
    sync = common.default_sync()
    # roofline accounting only for the modeled flagship schedule
    traffic = None
    if args.algorithm == "abitonic":
        opts = parse_options(args.alg_options)
        ncols = keymod.num_limbs(sorter.elem_dtype) + (1 if args.kv else 0)
        traffic = lambda nn: abitonic_traffic_bytes(nn, ncols, opts)  # noqa
    rows = []
    print(f"# algorithm: {args.algorithm}  type: {args.elem_type}  "
          f"runs: {args.runs}")
    print(f"{'N':>12} {'Mkeys/s':>12} {'ms/run':>10} {'GB/s':>8} "
          f"{'roof':>6}  check")
    for po2 in range(args.minpo2, args.maxpo2 + 1):
        n = 1 << po2
        host = common.rand_array(np_dtype, n, args.rng_seed + po2)
        data = interop.to_torch(host, dev)
        fargs = (data,)
        if args.kv:
            fargs = (data, torch.arange(n, dtype=torch.int32, device=dev))
        fn = sorter.sort_with_device_data
        secs = common.time_async(fn, fargs, args.runs, sync)
        mkeys = common.throughput_m(n, args.runs, secs)
        if args.no_check:
            check = "skipped"
        else:
            out = fn(*fargs)
            out = out[0] if isinstance(out, tuple) else out
            outh = interop.to_numpy(out)
            # Exact for every type: a check by np.diff(out) >= 0 would pass
            # any order of unsigned keys (the difference wraps).
            ok = bool(np.array_equal(outh, np.sort(host),
                                     equal_nan=np_dtype.kind == "f"))
            check = "ok" if ok else "FAILED"
        row = {"n": n, "mkeys_s": round(mkeys, 2),
               "ms_per_run": round(secs / args.runs * 1e3, 3)}
        if traffic is not None:
            row.update(roofline_row(traffic(n), secs / args.runs))
        row["check"] = check
        print(f"{n:>12} {mkeys:>12.1f} {secs / args.runs * 1e3:>10.2f} "
              f"{row.get('gb_s', 0):>8.1f} {row.get('roofline_frac', 0):>6.2f}"
              f"  {check}")
        rows.append(row)
        if check == "FAILED":
            print("verification FAILED", file=sys.stderr)
            return 1
    if args.out:
        common.write_tsv(args.out, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
