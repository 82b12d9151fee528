"""Scaling benchmark: the distributed operators at 1..N mesh positions.

Counterpart of `cl_ops_tpu/bench/scaling_bench.py` (the north star's
"rows/s scaling efficiency, measured at 1 chip, 1 host, N >= 2 hosts").
Each operator runs at every requested mesh size over the first k positions
of the mesh. Weak scaling (default) fixes ROWS PER POSITION and grows the
problem with the mesh; strong scaling fixes TOTAL rows. Efficiency is
rows/s per position relative to the smallest measured mesh:

    weak:   eff(k) = (rate_k / k) / (rate_b / b)      (b = smallest size)
    strong: eff(k) = (rate_k / rate_b) / (k / b)

Join and aggregate are timed in their `check="defer"` form (no host read
per call); their dropped counters are read after the timing through
`defer.verify_deferred`. Unless --no-check is given, every op's output is
then held to numpy exactly: a failed check prints what failed and exits 1.

Positions: `--virtual N` puts N positions on the one device `--device`
(default "cuda"); with `--virtual 0` there is one position per CUDA card.
Positions that share one card share its memory, so the rows of mesh sizes
above 1 measure the mesh layer's overhead, not scaling (a `#` line above
the table says so). `--device cpu` is the only way onto the CPU:

  python -m cl_ops_tpu_torch.bench.scaling_bench --device cpu --virtual 8 \\
      --op scan,sort,join,aggregate -n 12 -r 3
  python -m cl_ops_tpu_torch.bench.scaling_bench --virtual 4 -n 24 -r 3

`--multiproc P` is the N-host leg: the CLI starts P worker processes of
itself (--virtual positions each, default 4), joined over gloo
(`parallel/multiproc.py`; shards on the card are staged through host
memory), measures every op over the mesh across them at 1 and at P
processes, and reports rows/s and efficiency per process:

  python -m cl_ops_tpu_torch.bench.scaling_bench --multiproc 2 --virtual 2 \\
      --op scan,join -n 22 -r 3
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from cl_ops_tpu_torch import interop, parallel
from cl_ops_tpu_torch.bench import checks, common
from cl_ops_tpu_torch.parallel import multiproc
from cl_ops_tpu_torch.parallel.mesh import make_mesh
from cl_ops_tpu_torch.utils.platform import default_device

MP_WAIT_S = 1200  # the multiproc leg's cap on each worker's wait
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--op", default="scan,sort,join,aggregate",
                   help="comma list of scan,sort,join,aggregate,"
                        "window,topk")
    p.add_argument("--devices", default="",
                   help="comma list of mesh sizes (default: powers of 2 "
                        "up to the available positions)")
    p.add_argument("-n", "--log2-rows", type=int, default=20,
                   help="rows per position = 2^n (weak) or total rows = "
                        "2^n (strong); default 20")
    p.add_argument("--scaling", default="weak", choices=["weak", "strong"])
    p.add_argument("-r", "--runs", type=int, default=10)
    p.add_argument("--groups", type=int, default=1 << 16,
                   help="aggregate: total distinct keys (default 65536)")
    p.add_argument("--build-frac", type=int, default=16,
                   help="join: build side = probe rows / build_frac")
    p.add_argument("--device", default="cuda",
                   help="the device of the positions (default cuda; cpu "
                        "only when asked for)")
    p.add_argument("--virtual", type=int, default=0,
                   help="N mesh positions on the one device --device "
                        "(default 0: one position per CUDA card)")
    p.add_argument("--multiproc", type=int, default=0,
                   help="N-host leg: start P worker processes (--virtual "
                        "positions each, default 4) and measure 1 vs P "
                        "processes over the mesh across them")
    p.add_argument("--mp-worker", type=int, default=None,
                   help=argparse.SUPPRESS)  # internal: worker process id
    p.add_argument("--mp-port", type=int, default=0,
                   help=argparse.SUPPRESS)  # internal: rendezvous port
    p.add_argument("-s", "--rng-seed", type=int, default=0)
    p.add_argument("--no-check", action="store_true")
    p.add_argument("-o", "--out", default=None, help="TSV output path")
    return p


def positions(device: str, virtual: int) -> list[torch.device]:
    """The mesh positions' devices: `virtual` of `device`, or with
    virtual 0 each CUDA card (the CPU once). Raises when CUDA is asked for
    and absent."""
    dev = default_device(device)
    if virtual:
        return [dev] * virtual
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def _device_counts(arg: str, available: int) -> list[int]:
    if arg:
        return [int(x) for x in arg.split(",") if x]
    counts, k = [], 1
    while k <= available:
        counts.append(k)
        k *= 2
    return counts


def _block(a, mesh):
    """This process's block of the global rows `a` (all of them on a mesh
    held by one process)."""
    per = len(mesh.devices)
    rank, world = mesh.positions[0] // per, mesh.size // per
    m = len(a) // world
    return a[rank * m:(rank + 1) * m]


def _place(a, mesh):
    """The global rows `a` as a row-sharded Sharded, this process
    contributing its block."""
    return multiproc.from_process_local(_block(a, mesh), mesh)


def _differ(what: str, got, want) -> list[str]:
    """[what] unless got equals want."""
    return [] if np.array_equal(got, want) else [what]


def _all_groups(mesh, gk, table, cnt):
    """Every position's (key, aggregate) rows, gathered from every
    process, in ascending key order."""
    c = [int(t) for t in cnt.shards]
    keys = mesh.all_gather([g[:ci] for g, ci in zip(gk.shards, c)])[0]
    vals = mesh.all_gather([t[:ci] for t, ci in zip(table.shards, c)])[0]
    keys, vals = interop.to_numpy(keys), interop.to_numpy(vals)
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def _window_sums(keys, order, vals):
    """Each row's running sum over its partition in (order, position)
    order, in input row order."""
    idx, run_sum, _ = checks.window_oracle(keys, order, vals)
    out = np.empty(keys.size, np.int64)
    out[idx] = run_sum
    return out


def make_case(op: str, k: int, mesh, args, rng):
    """(fn, args, rows, check) of one op at mesh size k: the JAX CLI's
    draws from `rng` in its order, placed on `mesh` (on a mesh across
    processes each process places its block). check(out) returns what
    failed, comparing this process's rows with numpy."""
    rows_base = 1 << args.log2_rows
    n = rows_base * k if args.scaling == "weak" else rows_base
    if n % k:
        raise SystemExit(f"rows {n} not divisible by {k} positions")
    shard = n // k

    def cap_for(rows_shard: int) -> int:
        # uniform-key expected bucket load = shard / k; 2x headroom + slack
        return max(2 * rows_shard // k + 64, 128)

    local = multiproc.local_rows

    if op == "scan":
        # u32 sums, values kept small as the reference's scan bench does
        # (clo_scan_bench.c:219-224); the check wraps mod 2^32
        x = rng.randint(0, 128, size=n, dtype=np.uint32)

        def fn(a):
            return parallel.dist_scan(a, mesh, sum_dtype=np.uint32)

        def check(out):
            xs = x.astype(np.uint64)
            ref = ((np.cumsum(xs) - xs) & 0xFFFFFFFF).astype(np.uint32)
            return _differ("scan rows differ from np.cumsum", local(out),
                           _block(ref, mesh))
        return fn, (_place(x, mesh),), n, check
    if op == "sort":
        x = common.rand_array(np.uint32, n, args.rng_seed)

        def fn(a):
            return parallel.dist_sort(a, mesh)

        def check(out):
            return _differ("sort rows differ from np.sort", local(out),
                           _block(np.sort(x), mesh))
        return fn, (_place(x, mesh),), n, check
    if op == "aggregate":
        keys = rng.randint(0, args.groups, size=n).astype(np.int32)
        vals = np.ones(n, np.int32)
        # hash-balanced distinct keys a position, 2x margin
        per_chip_groups = min(args.groups, 2 * args.groups // k + 256)

        def fn(a, b):
            return parallel.dist_group_aggregate(
                a, b, mesh, num_groups=per_chip_groups,
                capacity=cap_for(shard), check="defer")

        def check(out):
            gk, table, cnt, dropped = out
            hist = np.bincount(keys, minlength=args.groups)
            present = np.flatnonzero(hist)
            got_k, got_v = _all_groups(mesh, gk, table, cnt)
            return checks.deferred((dropped,), "dist_group_aggregate") + (
                _differ("aggregate keys differ from np.unique", got_k,
                        present)
                or _differ("aggregate counts differ from np.unique", got_v,
                           hist[present]))
        return fn, (_place(keys, mesh), _place(vals, mesh)), n, check
    if op == "join":
        nb = max(n // args.build_frac, k)
        nb -= nb % k  # the build side splits evenly over the positions
        bk = rng.permutation(nb).astype(np.int32)
        pk = rng.randint(0, nb, size=n).astype(np.int32)

        def fn(b, v, p):
            return parallel.dist_hash_join(
                b, v, p, mesh, capacity_build=cap_for(nb // k),
                capacity_probe=cap_for(shard), check="defer")

        def check(out):
            found, vals_o, dropped = out
            return checks.deferred(dropped, "dist_hash_join") + \
                checks.join_probe(_block(pk, mesh), local(found),
                                  local(vals_o), mul=2, add=1)
        return fn, (_place(bk, mesh), _place(bk * 2 + 1, mesh),
                    _place(pk, mesh)), n, check
    if op == "window":
        keys = rng.randint(0, args.groups, size=n).astype(np.uint32)
        order = rng.randint(0, 1 << 20, size=n).astype(np.int32)
        vals = np.ones(n, np.int32)

        def fn(a, o, v):
            return parallel.dist_window_cols(a, o, (v,), ("sum",), mesh)

        def check(out):
            (sums,) = out
            return _differ("window running sums differ from numpy",
                           local(sums).astype(np.int64),
                           _block(_window_sums(keys, order, vals), mesh))
        return fn, tuple(_place(a, mesh) for a in (keys, order, vals)), \
            n, check
    if op == "topk":
        x = common.rand_array(np.uint32, n, args.rng_seed)
        kk = min(128, shard)

        def fn(a):
            return parallel.dist_top_k(a, kk, mesh)

        def check(out):
            (tv,) = out
            return _differ("top-k values differ from np.sort", local(tv),
                           np.sort(np.partition(x, kk - 1)[:kk]))
        return fn, (_place(x, mesh),), n, check
    raise SystemExit(f"unknown op {op!r}")


def _ops(args) -> list[str]:
    return [o.strip() for o in args.op.split(",") if o.strip()]


def _shared_note(devs, label: str) -> None:
    """The `#` line above a table whose positions share a device."""
    if len(set(devs)) < len(devs):
        what = "card" if devs[0].type == "cuda" else "device"
        print(f"# {label} share one {what}'s memory ({devs[0]}): those "
              "rows measure the mesh layer's overhead, not scaling",
              flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mp_parent(args) -> int:
    """Run the 1-process and P-process legs; report efficiency per process.

    Each leg runs `nproc` worker processes of this same CLI, joined over
    gloo on a localhost port; worker 0 prints one MPROW line per op with
    the measured seconds over the mesh across them."""
    per = args.virtual or 4
    dev = default_device(args.device)
    _shared_note([dev] * per * args.multiproc,
                 f"{args.multiproc} processes x {per} positions (gloo, "
                 "through host memory)")
    rows, base = [], {}  # base: op -> (rate, nproc)
    for nproc in sorted({1, args.multiproc}):
        cmd = [sys.executable, "-m", "cl_ops_tpu_torch.bench.scaling_bench",
               "--multiproc", str(nproc), "--mp-port", str(_free_port()),
               "--virtual", str(per), "--device", args.device,
               "--op", args.op, "-n", str(args.log2_rows),
               "-r", str(args.runs), "-s", str(args.rng_seed),
               "--scaling", args.scaling, "--groups", str(args.groups),
               "--build-frac", str(args.build_frac)]
        if args.no_check:
            cmd.append("--no-check")
        procs = [subprocess.Popen(cmd + ["--mp-worker", str(pid)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  cwd=_ROOT) for pid in range(nproc)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MP_WAIT_S)[0])
        except subprocess.TimeoutExpired:
            print(f"a worker of {nproc} ran past {MP_WAIT_S} s; killed",
                  file=sys.stderr)
            return 1
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for pid, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                print(f"worker {pid}/{nproc} failed:\n{out[-4000:]}",
                      file=sys.stderr)
                return 1
        for line in outs[0].splitlines():
            if not line.startswith("MPROW\t"):
                continue
            _, op, n_s, secs_s = line.split("\t")
            n, secs = int(n_s), float(secs_s)
            rate = common.throughput_m(n, args.runs, secs)
            b_rate, b_np = base.setdefault(op, (rate, nproc))
            per_host = (rate / nproc) / (b_rate / b_np)
            eff = per_host if args.scaling == "weak" else \
                (rate / b_rate) / (nproc / b_np)
            row = dict(op=op, hosts=nproc, devices=nproc * per, rows=n,
                       mrows_s=round(rate, 1),
                       speedup=round(rate / b_rate, 3),
                       efficiency=round(eff, 3))
            rows.append(row)
            print("\t".join(f"{c}={v}" for c, v in row.items()),
                  flush=True)
    if args.out:
        common.write_tsv(args.out, rows)
    return 0


def _mp_worker(args) -> int:
    """One process of the mesh across processes: join the group, run the
    ops over the global mesh, check this process's rows, print timings
    from worker 0. Every process learns whether any failed, so all exit
    alike instead of waiting on a collective."""
    pid = args.mp_worker
    multiproc.init_process(pid, args.multiproc,
                           coordinator=f"localhost:{args.mp_port}")
    try:
        mesh = multiproc.global_mesh(
            devices=positions(args.device, args.virtual or 4))
        sync = common.default_sync()
        rng = np.random.RandomState(args.rng_seed)
        for op in _ops(args):
            fn, fargs, n, check = make_case(op, mesh.size, mesh, args, rng)
            secs = common.time_async(fn, fargs, args.runs, sync)
            fails = [] if args.no_check else check(fn(*fargs))
            for f in fails:
                print(f"{op}: {f}", flush=True)
            if mesh.sum_to_host([torch.tensor([len(fails)])]):
                return 1
            if pid == 0:
                print(f"MPROW\t{op}\t{n}\t{secs}", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mp_worker is not None:
        return _mp_worker(args)
    if args.multiproc:
        return _mp_parent(args)
    devs = positions(args.device, args.virtual)
    avail = len(devs)
    counts = _device_counts(args.devices, avail)
    if not counts or max(counts) > avail:
        # make_mesh(k, devices=...) would silently cut the list,
        # mislabelling every row and the efficiency column
        need = max(counts) if counts else "a mesh size"
        print(f"only {avail} positions available; need {need}",
              file=sys.stderr)
        return 1
    _shared_note(devs[:max(counts)], "mesh sizes above 1")
    sync = common.default_sync()
    rng = np.random.RandomState(args.rng_seed)
    results = []
    for op in _ops(args):
        base_rate = base_k = None
        for k in counts:
            mesh = make_mesh(k, devices=devs)
            fn, fargs, n, check = make_case(op, k, mesh, args, rng)
            secs = common.time_async(fn, fargs, args.runs, sync)
            if not args.no_check:
                fails = check(fn(*fargs))
                if fails:
                    print(f"{op} at {k} positions: " + "; ".join(fails),
                          file=sys.stderr)
                    return 1
            rate = common.throughput_m(n, args.runs, secs)  # Mrows/s
            if base_rate is None:
                base_rate, base_k = rate, k
            speedup = rate / base_rate
            per_dev = (rate / k) / (base_rate / base_k)
            eff = per_dev if args.scaling == "weak" else \
                speedup / (k / base_k)
            row = dict(op=op, devices=k, rows=n, mrows_s=round(rate, 1),
                       speedup=round(speedup, 3),
                       efficiency=round(eff, 3))
            results.append(row)
            print("\t".join(f"{c}={v}" for c, v in row.items()), flush=True)
    if args.out:
        common.write_tsv(args.out, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
