"""Scan benchmark CLI — parity with clo_scan_bench.

Counterpart of `cl_ops_tpu/bench/scan_bench.py`, after the reference CLI
(`src/benchmarks/clo_scan_bench.c:53-92`): impl name + options, runs,
element/sum types, size sweep init_elems * 2^min_doub .. init_elems *
2^num_doub (defaults 4 x 2^24), serial-CPU verification with overflow
detection against the sum type's max (`clo_scan_bench.c:246-271`),
--no-check, MValues/s reporting, TSV output. Input values are kept < 128 to
delay overflow exactly like the reference (`clo_scan_bench.c:219-224`).
--device picks the device (default cuda).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import common
from cl_ops_tpu_torch.bench.roofline import roofline_row
from cl_ops_tpu_torch.core.dtypes import type_info
from cl_ops_tpu_torch.ops.scan import scan_new
from cl_ops_tpu_torch.ops.scan.kernels import scan_traffic_bytes
from cl_ops_tpu_torch.utils.platform import default_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-a", "--algorithm", default="blelloch")
    p.add_argument("-o", "--alg-options", default=None)
    p.add_argument("-r", "--runs", type=int, default=1)
    p.add_argument("-t", "--type", dest="elem_type", default="uint")
    p.add_argument("--sum-type", default=None,
                   help="accumulator type (default: widening rule)")
    p.add_argument("-i", "--init-elems", type=int, default=4)
    p.add_argument("-n", "--num-doub", type=int, default=24)
    p.add_argument("--min-doub", type=int, default=1)
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = default_device(args.device)
    s = scan_new(args.algorithm, args.alg_options,
                 elem_dtype=args.elem_type, sum_dtype=args.sum_type)
    elem_np = type_info(s.elem_dtype).np_dtype
    sum_np = type_info(s.sum_dtype).np_dtype
    sync = common.default_sync()
    traffic = None
    if args.algorithm in ("blelloch", "lookback"):
        traffic = lambda nn: scan_traffic_bytes(  # noqa: E731
            nn, s.sum_dtype, single_pass=args.algorithm == "lookback",
            elem_dtype=s.elem_dtype)
    rows = []
    print(f"# algorithm: {args.algorithm}  type: {args.elem_type} -> "
          f"{sum_np}  runs: {args.runs}")
    print(f"{'N':>12} {'MValues/s':>12} {'ms/run':>10} {'GB/s':>8} "
          f"{'roof':>6}  check")
    rng = np.random.RandomState(args.rng_seed)
    for d in range(args.min_doub, args.num_doub + 1):
        n = args.init_elems * (1 << d)
        # values < 128 to delay overflow (clo_scan_bench.c:219-224)
        if elem_np.kind in "iu":
            host = rng.randint(0, 128, size=n).astype(elem_np)
        else:
            host = rng.rand(n).astype(elem_np)
        data = interop.to_torch(host, dev)
        secs = common.time_async(s.scan_with_device_data, (data,),
                                 args.runs, sync)
        mvals = common.throughput_m(n, args.runs, secs)
        if args.no_check:
            check = "skipped"
        else:
            out = interop.to_numpy(s.scan_with_device_data(data))
            acc = np.cumsum(host.astype(sum_np))
            expect = acc - host.astype(sum_np)
            if sum_np.kind in "iu":
                # overflow detection parity (clo_scan_bench.c:246-271)
                true_sum = np.cumsum(host.astype(np.float64))
                if true_sum[-1] > np.iinfo(sum_np).max:
                    check = "overflow"
                else:
                    check = "ok" if np.array_equal(out, expect) else "FAILED"
            else:
                check = ("ok" if np.allclose(out, expect, rtol=1e-5)
                         else "FAILED")
        row = {"n": n, "mvalues_s": round(mvals, 2),
               "ms_per_run": round(secs / args.runs * 1e3, 3)}
        if traffic is not None:
            row.update(roofline_row(traffic(n), secs / args.runs))
        row["check"] = check
        print(f"{n:>12} {mvals:>12.1f} {secs / args.runs * 1e3:>10.2f} "
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
