"""RNG benchmark CLI — parity with clo_rng_bench.

Counterpart of `cl_ops_tpu/bench/rng_bench.py`, after the reference CLI
(`src/benchmarks/clo_rng_bench.c:51-83`): generator name, gws (streams),
runs (draws per stream; 0 = continuous stream for stdout-bin), bits /
max-int range control (`clo_rng_bench.c:296-299`), seed + seeding mode
(host MT vs device GID+hash, `clo_rng_bench.c:139-144`), and the four
output sinks (`clo_rng_bench.c:56`), whose bytes equal the JAX CLI's for
the same arguments:

  file-tsv    — matrix TSV for the visual plot script
  file-dh     — dieharder input format with type/count/numbit header
                (`clo_rng_bench.c:266-270`)
  stdout-bin  — raw binary stream (pipe into dieharder/PractRand;
                runs=0 streams forever like `clo_rng_bench.c:154-157`)
  stdout-uint — decimal text

The reported time is the generation's, with the device synchronised before
and after; the copy to the host is not in it. --device picks the device
(default cuda).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import common
from cl_ops_tpu_torch.ops.rng import rng_new
from cl_ops_tpu_torch.utils.platform import default_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-g", "--rng", default="threefry",
                   help="generator name (default threefry)")
    p.add_argument("--gws", type=int, default=262144,
                   help="number of streams (ref default 262144)")
    p.add_argument("-r", "--runs", type=int, default=10,
                   help="draws per stream; 0 = stream forever (stdout-bin)")
    p.add_argument("--bits", type=int, default=32)
    p.add_argument("--max-int", type=int, default=None,
                   help="draw in [0, max-int] instead of full bit range")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--seed-type", default="dev_gid",
                   choices=["dev_gid", "host_mt"])
    p.add_argument("--hash", dest="hash_name", default="knuth")
    p.add_argument("--output", default="stdout-uint",
                   choices=["file-tsv", "file-dh", "stdout-bin",
                            "stdout-uint", "none"])
    p.add_argument("--out-file", default="out.tsv")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = default_device(args.device)
    r = rng_new(args.rng, args.seed_type, num_streams=args.gws,
                main_seed=args.seed,
                hash_name=args.hash_name
                if args.seed_type == "dev_gid" else None, device=dev)

    if args.max_int is not None and not 0 <= args.max_int < 2**32 - 1:
        # 2**32-1 would wrap the u32 modulus to 0 (clo_rng_bench draws are
        # 32-bit); reject instead of silently wrapping.
        print("--max-int must be in [0, 2**32-2]", file=sys.stderr)
        return 1

    def post(vals):
        if args.max_int is not None:
            return vals % np.uint32(args.max_int + 1)
        if args.bits < 32:
            return vals >> np.uint32(32 - args.bits)
        return vals

    sync = common.default_sync(dev)

    if args.runs == 0:
        # continuous raw stream (clo_rng_bench.c:154-157,302)
        if args.output != "stdout-bin":
            print("runs=0 requires --output stdout-bin", file=sys.stderr)
            return 1
        while True:
            vals = post(interop.to_numpy(r.generate(64)))
            sys.stdout.buffer.write(vals.astype("<u4").tobytes())

    sync(None)
    t0 = time.perf_counter()
    gen = r.generate(args.runs)  # (runs, gws)
    sync(gen)
    dt = time.perf_counter() - t0
    vals = post(interop.to_numpy(gen))
    total = args.runs * args.gws
    print(f"# {args.rng}: {total} numbers in {dt:.4f} s "
          f"({total / dt / 1e6:.1f} M/s)", file=sys.stderr)

    if args.output == "file-tsv":
        np.savetxt(args.out_file, vals, fmt="%d", delimiter="\t")
    elif args.output == "file-dh":
        with open(args.out_file, "w") as f:
            # dieharder ASCII input header (clo_rng_bench.c:266-270)
            f.write("type: d\n")
            f.write(f"count: {total}\n")
            f.write(f"numbit: {args.bits}\n")
            np.savetxt(f, vals.reshape(-1), fmt="%d")
    elif args.output == "stdout-bin":
        sys.stdout.buffer.write(vals.astype("<u4").tobytes())
    elif args.output == "stdout-uint":
        for v in vals.reshape(-1)[:1024]:
            print(int(v))
        if total > 1024:
            print(f"... ({total - 1024} more)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
