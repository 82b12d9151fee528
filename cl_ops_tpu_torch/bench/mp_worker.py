"""One process of a mesh across processes, checked against numpy.

The port's counterpart of `tests/mp_worker.py`: start WORLD copies, one per
rank, with the same rendezvous port:

    python -m cl_ops_tpu_torch.bench.mp_worker RANK WORLD PORT \\
        --devices cuda:0,cuda:0 --rows 16777216

Each joins the gloo group (`multiproc.init_process`), builds the mesh over
every process's positions (`global_mesh(devices=...)`), makes the same
global inputs from fixed seeds, contributes its block of rows
(`from_process_local`), and runs the list of `tests/mp_worker.py`: the
mesh's collectives across the process boundary (an all_to_all with uneven
buckets, an all_gather of unsigned values, a ppermute between processes),
dist_scan, dist_sort, dist_group_aggregate, the zipf(1.2) dist_hash_join
with its re-plan, dist_hash_join_expand, dist_window_cols, dist_top_k and
dist_distinct. It checks its own rows against numpy, and prints one JSON
line: every check ("ok" or what failed), the kernel launches and the
seconds of each step. Exits 1 when a check failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from cl_ops_tpu_torch import interop, parallel
from cl_ops_tpu_torch.bench import checks
from cl_ops_tpu_torch.ops.exec import bandprobe
from cl_ops_tpu_torch.ops.scan import kernels as scan_kernels
from cl_ops_tpu_torch.ops.scan import segmented
from cl_ops_tpu_torch.ops.sort import bitonic_kernels
from cl_ops_tpu_torch.parallel import multiproc
from cl_ops_tpu_torch.parallel.mesh import Sharded, iota_sharded
from cl_ops_tpu_torch.parallel.splitters import hash_partition_ids

KERNEL_MODULES = (bitonic_kernels, scan_kernels, segmented, bandprobe)


def _launches() -> dict:
    return {k: v for m in KERNEL_MODULES for k, v in m.launches.items()}


def _collectives(mesh) -> dict:
    """The three collectives across the process boundary, at tiny sizes.
    Returns {check: failure or None}."""
    size, per = mesh.size, len(mesh.devices)
    out = {}

    def bucket(s, d):  # (s + d) % 3 rows: ragged, some empty
        return torch.full(((s + d) % 3,), 100 * s + d, dtype=torch.int32)

    got = mesh.all_to_all([[bucket(s, d).to(dev) for d in range(size)]
                           for s, dev in zip(mesh.positions, mesh.devices)])
    want = [torch.cat([bucket(s, d) for s in range(size)])
            for d in mesh.positions]
    out["all_to_all uneven buckets"] = None if all(
        torch.equal(g.cpu(), w) for g, w in zip(got, want)) \
        else "received buckets differ"
    vals = [torch.tensor([2 ** 32 - 1 - p, p], dtype=torch.int64).to(
        torch.int32).view(torch.uint32).to(dev)
        for p, dev in zip(mesh.positions, mesh.devices)]
    got = mesh.all_gather(vals)
    want = np.array([[2 ** 32 - 1 - p, p] for p in range(size)],
                    np.uint32).reshape(-1)
    out["all_gather uint32"] = None if all(
        g.dtype == torch.uint32 and np.array_equal(interop.to_numpy(g), want)
        for g in got) else "gathered values differ"
    # each position to the same slot on the next process
    perm = [(p, (p + per) % size) for p in range(size)]
    got = mesh.ppermute([torch.tensor([p, -p], dtype=torch.int32).to(dev)
                         for p, dev in zip(mesh.positions, mesh.devices)],
                        perm)
    out["ppermute across processes"] = None if all(
        g.tolist() == [(d - per) % size, -((d - per) % size)]
        for g, d in zip(got, mesh.positions)) else "received values differ"
    return out


def run(rank: int, world: int, port: int, devices, n: int) -> dict:
    multiproc.init_process(rank, world, coordinator=f"localhost:{port}")
    mesh = multiproc.global_mesh(devices=devices)
    p = mesh.size
    lo, hi = rank * (n // world), (rank + 1) * (n // world)
    checks_out, seconds = {}, {}

    def local(x, rows=None):
        r = slice(lo, hi) if rows is None else rows
        return multiproc.from_process_local(x[r], mesh)

    def step(name, fn):
        t = time.perf_counter()
        fails = fn()
        seconds[name] = time.perf_counter() - t
        checks_out[name] = "; ".join(fails) if fails else "ok"

    for name, fail in _collectives(mesh).items():
        checks_out[name] = fail or "ok"
    for m in KERNEL_MODULES:
        m.reset_launches()

    x = np.random.RandomState(1).randint(0, 1000, size=n).astype(np.uint32)
    k = np.random.RandomState(2).randint(0, 1 << 31, size=n,
                                         dtype=np.int64).astype(np.uint32)
    keys = np.random.RandomState(3).randint(0, 97, size=n).astype(np.uint32)
    vals = np.random.RandomState(4).randint(0, 50, size=n).astype(np.int32)

    def scan():
        out = parallel.dist_scan(local(x), mesh, sum_dtype=np.uint64)
        want = (np.cumsum(x.astype(np.uint64)) - x)[lo:hi]
        return [] if np.array_equal(multiproc.local_rows(out), want) \
            else ["dist_scan rows differ"]

    def sort():
        out = parallel.dist_sort(local(k), mesh)
        return [] if np.array_equal(multiproc.local_rows(out),
                                    np.sort(k)[lo:hi]) \
            else ["dist_sort rows differ"]

    def group_by():
        gk, table, cnt = parallel.dist_group_aggregate(
            local(keys), local(vals), mesh, num_groups=128,
            capacity=2 * n // (p * p), agg="sum")
        uniq = np.unique(keys)
        sums = np.bincount(keys, weights=vals)
        g = multiproc.local_rows(gk).reshape(len(mesh.devices), -1)
        t = multiproc.local_rows(table).reshape(len(mesh.devices), -1)
        c = multiproc.local_rows(cnt)
        fails = []
        if mesh.sum_to_host(cnt.shards) != len(uniq):
            fails.append("group count")
        for i in range(len(c)):
            if not np.array_equal(t[i, :c[i]], sums[g[i, :c[i]]]):
                fails.append(f"group sums of position {mesh.positions[i]}")
        return fails

    def join():
        # zipf(1.2) probes: the hash plan's buckets overflow at 1.25x the
        # even share, so the plan escalates
        nb = max(p * 32, n // 16)
        dim = np.arange(nb, dtype=np.uint32)
        probe = (np.random.default_rng(5).zipf(1.2, size=n)
                 % (4 * nb)).astype(np.uint32)
        b = slice(rank * nb // world, (rank + 1) * nb // world)
        cap_probe = int(1.25 * n / p / p)
        probes = local(probe)
        found, fv = parallel.dist_hash_join(
            local(dim, b), local((dim * 5 + 3).astype(np.int32), b),
            probes, mesh, capacity_build=int(1.25 * nb / p / p),
            capacity_probe=cap_probe, max_replan=8, samples_per_chip=64)
        want = probe[lo:hi] < nb
        f, v = multiproc.local_rows(found), multiproc.local_rows(fv)
        fails = [] if np.array_equal(f, want) else ["join found"]
        pid = Sharded(mesh, [hash_partition_ids(t, p)
                             for t in probes.shards])
        _, dropped, _ = parallel.partition_exchange(probes, pid, mesh,
                                                    capacity=cap_probe)
        if mesh.sum_to_host(dropped.shards) == 0:
            fails.append("the hash plan did not overflow: no re-plan")
        if not np.array_equal(v[want], (probe[lo:hi][want] * 5 + 3)
                              .astype(np.int32)):
            fails.append("join values")
        return fails

    def expand():
        nb2 = p * 16
        b2 = np.sort(np.random.RandomState(6).randint(
            0, 64, size=nb2).astype(np.uint32))
        bv2 = np.arange(nb2, dtype=np.int32) + 11
        p2 = np.random.RandomState(7).randint(0, 80, size=n).astype(
            np.uint32)
        b = slice(rank * nb2 // world, (rank + 1) * nb2 // world)
        cap_out = 4 * n // p
        totals, pidx, pv = parallel.dist_hash_join_expand(
            local(b2, b), local(bv2, b), local(p2), mesh,
            capacity_build=nb2, capacity_probe=2 * n // (p * p),
            capacity_out=cap_out)
        matches = np.bincount(b2, minlength=80)
        fails = []
        if mesh.sum_to_host(totals.shards) != int(matches[p2].sum()):
            fails.append("expand total")
        t = multiproc.local_rows(totals)
        rows = multiproc.local_rows(pidx).reshape(len(t), cap_out)
        bval = multiproc.local_rows(pv).reshape(len(t), cap_out)
        for i in range(len(t)):
            r, v = rows[i, :t[i]].astype(np.int64), bval[i, :t[i]]
            if t[i] > cap_out or (rows[i, t[i]:] != -1).any():
                fails.append(f"expand tail of position {mesh.positions[i]}")
                continue
            # every pair a match, no pair twice, every match of a probe row
            # held here
            ok = (b2[v - 11] == p2[r]).all() and len(
                np.unique(r * nb2 + (v - 11))) == len(r)
            ur, cnt = np.unique(r, return_counts=True)
            if not (ok and np.array_equal(cnt, matches[p2[ur]])):
                fails.append(f"expand pairs of position {mesh.positions[i]}")
        return fails

    wkeys = (keys % 5).astype(np.uint32)

    def window():
        wsum, wrow = parallel.dist_window_cols(
            local(wkeys), local(vals), (local(vals), None),
            ("sum", "row_number"), mesh)
        idx, run_sum, row_num = checks.window_oracle(wkeys, vals, vals)
        s, r = np.empty(n, np.int64), np.empty(n, np.int64)
        s[idx], r[idx] = run_sum, row_num
        fails = []
        if not np.array_equal(multiproc.local_rows(wsum), s[lo:hi]):
            fails.append("window sums")
        if not np.array_equal(multiproc.local_rows(wrow), r[lo:hi]):
            fails.append("window row numbers")
        return fails

    def top_k():
        tv, tpos = parallel.dist_top_k(
            local(k), 8, mesh, iota_sharded(n, mesh))
        order = np.argsort(k, kind="stable")[:8]
        return [] if np.array_equal(multiproc.local_rows(tv), k[order]) \
            and np.array_equal(multiproc.local_rows(tpos), order) \
            else ["top_k"]

    def distinct():
        uv, cnt = parallel.dist_distinct(local(wkeys), mesh, capacity=16)
        c = int(multiproc.local_rows(cnt))
        return [] if c == 5 and np.array_equal(
            multiproc.local_rows(uv)[:c], np.unique(wkeys)) else ["distinct"]

    for name, fn in (("dist_scan", scan), ("dist_sort", sort),
                     ("dist_group_aggregate", group_by),
                     ("dist_hash_join zipf", join),
                     ("dist_hash_join_expand", expand),
                     ("dist_window_cols", window), ("dist_top_k", top_k),
                     ("dist_distinct", distinct)):
        step(name, fn)
    return {"rank": rank, "positions": list(mesh.positions),
            "devices": [str(d) for d in mesh.devices], "rows": n,
            "checks": checks_out, "launches": _launches(),
            "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--devices", default="cuda:0",
                    help="this process's positions, comma-separated")
    ap.add_argument("--rows", type=int, default=1 << 24,
                    help="global rows of each input")
    a = ap.parse_args(argv)
    report = run(a.rank, a.world, a.port, a.devices.split(","), a.rows)
    torch.distributed.destroy_process_group()
    print(json.dumps(report), flush=True)
    return 0 if all(v == "ok" for v in report["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
