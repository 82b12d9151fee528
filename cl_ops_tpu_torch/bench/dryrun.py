"""The multichip dry run: every operator of the distributed layer, once.

Counterpart of `dryrun_multichip` in the JAX package's repo-root
`__graft_entry__.py`: one pass over every `parallel/` module at 1024 rows
a position, each result held to numpy or to the port's single-device
operator. The JAX version runs some checks twice (with and without Pallas,
and under jit); the port has neither, so each runs once:

  dist_scan (u64 sums); dist_segmented_scan with runs across shard edges;
  dist_sort; dist_group_aggregate and dist_group_aggregate_cols (sum,
  max); dist_hash_join with a quarter of the probes missing; a zipf(1.2)
  probe side whose uniform-capacity hash exchange must drop rows and whose
  join must re-plan to the exact answer; the check="defer" join;
  dist_sort_sample; dist_window_cols in input order, in sorted order
  scattered back by row_src, and lag/lead, against window_cols;
  dist_top_k with iota_sharded positions; dist_distinct;
  dist_hash_join_expand under check="defer".

`dryrun_multichip(n_positions)` takes the first n_positions CUDA cards
and raises without them; `devices=` names the positions (a device may
repeat). It returns {check: "ok" or what failed}. Run it as

  python -m cl_ops_tpu_torch.bench.dryrun --positions 4 --device cuda:0
  python -m cl_ops_tpu_torch.bench.dryrun --positions 8 --device cpu

which prints one JSON line of the checks and exits 1 when one failed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from cl_ops_tpu_torch import interop, parallel
from cl_ops_tpu_torch.bench.checks import deferred
from cl_ops_tpu_torch.ops.exec import window_cols
from cl_ops_tpu_torch.parallel.mesh import iota_sharded
from cl_ops_tpu_torch.parallel.splitters import hash_partition_ids

ROWS = 1024  # rows a position


def _valid(x, counts, p: int) -> np.ndarray:
    """Each position's first counts[c] rows, concatenated."""
    rows = x.numpy().reshape(p, -1)
    return np.concatenate([rows[c, :counts[c]] for c in range(p)])


def _groups(gk, tables, cnt, p: int):
    """Every position's groups in ascending key order: (keys, tables)."""
    c = cnt.numpy()
    keys = _valid(gk, c, p)
    order = np.argsort(keys, kind="stable")
    return keys[order], [_valid(t, c, p)[order] for t in tables]


def _expect(fails: list, what: str, ok) -> None:
    if not bool(ok):
        fails.append(what)


def _cases(mesh):
    """The checks over `mesh`, in the JAX dry run's order: (name, fn),
    each fn returning the list of what failed."""
    p = mesh.size
    n = p * ROWS
    dev = mesh.devices[0]
    x = np.random.RandomState(1).randint(0, 1000, size=n).astype(np.uint32)
    k = np.random.RandomState(2).randint(
        0, 1 << 31, size=n, dtype=np.int64).astype(np.uint32)
    vals = np.random.RandomState(3).randint(0, 50, size=n).astype(np.int32)
    wkeys = (k % 5).astype(np.uint32)

    def scan():
        out = parallel.dist_scan(x, mesh, sum_dtype=np.uint64)
        want = np.cumsum(x.astype(np.uint64)) - x
        return [] if np.array_equal(out.numpy(), want) \
            else ["dist_scan rows differ from np.cumsum"]

    def segmented_scan():
        # runs across shard edges: one inside position 1, one at the
        # start of position 3
        sf = np.zeros(n, np.int32)
        sf[[i for i in (0, ROWS + 7, 3 * ROWS) if i < n]] = 1
        out = parallel.dist_segmented_scan(x, sf, mesh, op="add",
                                           exclusive=False)
        csum = np.cumsum(x.astype(np.uint64))
        start = np.maximum.accumulate(np.where(sf != 0, np.arange(n), 0))
        want = (csum - np.r_[0, csum][start]).astype(np.uint32)
        return [] if np.array_equal(out.numpy(), want) \
            else ["dist_segmented_scan rows differ from numpy"]

    def sort():
        return [] if np.array_equal(parallel.dist_sort(k, mesh).numpy(),
                                    np.sort(k)) \
            else ["dist_sort rows differ from np.sort"]

    def group_by():
        gk, table, cnt = parallel.dist_group_aggregate(
            k, vals, mesh, num_groups=n, capacity=n)
        uniq, inv = np.unique(k, return_inverse=True)
        keys, (sums,) = _groups(gk, (table,), cnt, p)
        fails = []
        _expect(fails, "group keys differ from np.unique",
                np.array_equal(keys, uniq))
        if not fails:
            _expect(fails, "group sums differ from np.bincount",
                    np.array_equal(sums, np.bincount(inv, weights=vals)))
        return fails

    def group_by_cols():
        gk, (msum, mmax), cnt = parallel.dist_group_aggregate_cols(
            k, (vals, vals), ("sum", "max"), mesh, num_groups=n,
            capacity=n)
        uniq, inv = np.unique(k, return_inverse=True)
        keys, (sums, maxes) = _groups(gk, (msum, mmax), cnt, p)
        want_max = np.full(len(uniq), np.iinfo(np.int32).min, np.int64)
        np.maximum.at(want_max, inv, vals)
        fails = []
        _expect(fails, "group keys differ from np.unique",
                np.array_equal(keys, uniq))
        if not fails:
            _expect(fails, "group sums differ from np.bincount",
                    np.array_equal(sums, np.bincount(inv, weights=vals)))
            _expect(fails, "group maxima differ from numpy",
                    np.array_equal(maxes, want_max))
        return fails

    # a dimension of p * 64 keys; a quarter of the probes miss it
    rng = np.random.RandomState(4)
    nb = p * 64
    dim_keys = np.arange(nb, dtype=np.uint32) * 7 + 1
    dim_vals = (dim_keys * 3).astype(np.int32)
    fact = np.concatenate([
        dim_keys[rng.randint(0, nb, size=n - n // 4)],
        rng.randint(1 << 24, 1 << 25, size=n // 4).astype(np.uint32)])
    rng.shuffle(fact)
    hit = np.isin(fact, dim_keys)

    def join_answer(found, fvals):
        fails = []
        _expect(fails, "join found flags differ from np.isin",
                np.array_equal(found.numpy(), hit))
        want = (fact[hit] * 3).astype(np.int32)
        _expect(fails, "join values differ from key * 3",
                np.array_equal(fvals.numpy()[hit], want))
        return fails

    def join():
        return join_answer(*parallel.dist_hash_join(
            dim_keys, dim_vals, fact, mesh, capacity_build=nb,
            capacity_probe=len(fact)))

    # zipf(1.2) probes whose uniform-share hash buckets overflow
    zfact = (np.random.default_rng(6).zipf(1.2, size=n)
             % (1 << 16)).astype(np.uint32)
    zdim = np.arange(nb, dtype=np.uint32)  # covers the heavy low keys
    zvals = (zdim * 5 + 3).astype(np.int32)
    cap_probe = (n // p) // p  # the uniform share, no headroom

    def zipf_exchange_drops():
        zt = interop.to_torch(zfact, "cpu")
        _, dropped, _ = parallel.partition_exchange(
            zt, hash_partition_ids(zt, p), mesh, capacity=cap_probe)
        return [] if mesh.sum_to_host(dropped.shards) > 0 else [
            "the uniform-capacity hash exchange of the zipf keys dropped "
            "nothing"]

    def zipf_join():
        zfound, zv = parallel.dist_hash_join(
            zdim, zvals, zfact, mesh, capacity_build=nb,
            capacity_probe=cap_probe, samples_per_chip=64)
        want = zfact < nb
        fails = []
        _expect(fails, "zipf join found flags",
                np.array_equal(zfound.numpy(), want))
        _expect(fails, "zipf join values",
                np.array_equal(zv.numpy()[want],
                               (zfact[want] * 5 + 3).astype(np.int32)))
        return fails

    def join_defer():
        found, fvals, dropped = parallel.dist_hash_join(
            dim_keys, dim_vals, fact, mesh, capacity_build=nb,
            capacity_probe=len(fact), check="defer")
        return deferred(dropped, "dist_hash_join") + \
            join_answer(found, fvals)

    def sort_sample():
        zipfish = (np.random.default_rng(5).zipf(1.4, size=n)
                   % (1 << 20)).astype(np.uint32)
        totals, buf, dropped = parallel.dist_sort_sample(
            zipfish, mesh, capacity_factor=4.0, samples_per_chip=16,
            max_resample=2)
        fails = []
        _expect(fails, "dist_sort_sample dropped rows",
                mesh.sum_to_host(dropped.shards) == 0)
        _expect(fails, "dist_sort_sample rows differ from np.sort",
                np.array_equal(_valid(buf, totals.numpy(), p),
                               np.sort(zipfish)))
        return fails

    def on_dev(a):
        return interop.to_torch(a, dev)

    def single(order, values, aggs):
        """The single-device window_cols of the whole input, on the host."""
        out = window_cols(on_dev(wkeys), on_dev(order),
                          tuple(None if v is None else on_dev(v)
                                for v in values), aggs)
        return [interop.to_numpy(c) for c in out]

    def window():
        got = parallel.dist_window_cols(wkeys, vals, (vals, None),
                                        ("sum", "row_number"), mesh)
        want = single(vals, (vals, None), ("sum", "row_number"))
        fails = []
        for name, g, w in zip(("sums", "row numbers"), got, want):
            _expect(fails, f"window {name} differ from window_cols",
                    np.array_equal(g.numpy(), w))
        return fails

    def window_sorted():
        (ssum, srank), row_src = parallel.dist_window_cols(
            wkeys, vals, (vals, None), ("sum", "row_number"), mesh,
            sorted_output=True)
        src = row_src.numpy()
        want = single(vals, (vals, None), ("sum", "row_number"))
        fails = []
        for name, g, w in zip(("sums", "row numbers"), (ssum, srank), want):
            back = np.empty_like(w)
            back[src] = g.numpy()
            _expect(fails, f"sorted window {name} scattered back by row_src "
                    "differ from window_cols", np.array_equal(back, w))
        return fails

    def lag_lead():
        got = parallel.dist_window_cols(wkeys, vals, (vals, vals),
                                        ("lag", "lead"), mesh)
        want = single(vals, (vals, vals), ("lag", "lead"))
        fails = []
        for name, g, w in zip(("lag", "lead"), got, want):
            _expect(fails, f"window {name} differs from window_cols",
                    np.array_equal(g.numpy(), w))
        return fails

    def top_k():
        tv, tpos = parallel.dist_top_k(k, 16, mesh, iota_sharded(n, mesh))
        order = np.argsort(k, kind="stable")[:16]
        fails = []
        _expect(fails, "top-k values differ from np.sort",
                np.array_equal(tv.numpy(), k[order]))
        _expect(fails, "top-k positions differ from np.argsort",
                np.array_equal(tpos.numpy(), order))
        return fails

    def distinct():
        uq, ucnt = parallel.dist_distinct(wkeys, mesh, capacity=64)
        c = int(ucnt.numpy())
        want = np.unique(wkeys)
        fails = []
        _expect(fails, f"distinct count {c} != {len(want)}", c == len(want))
        if not fails:
            _expect(fails, "distinct values differ from np.unique",
                    np.array_equal(uq.numpy()[:c], want))
        return fails

    def expand():
        # duplicate build keys (2 rows a key); outputs stay
        # partition-sharded
        dup, enk = 2, p * 32
        ebk = np.repeat(np.arange(enk, dtype=np.uint32), dup)
        ebv = np.arange(enk * dup, dtype=np.int32)
        epk = np.random.RandomState(8).randint(0, enk, size=n).astype(
            np.uint32)
        ecap = 4 * (n // p) * dup
        etot, eprows, evals, dropped = parallel.dist_hash_join_expand(
            ebk, ebv, epk, mesh, capacity_build=len(ebk), capacity_probe=n,
            capacity_out=ecap, check="defer")
        fails = deferred(dropped, "dist_hash_join_expand")
        tots = etot.numpy()
        _expect(fails, "expansion total != probes x 2",
                int(tots.sum()) == n * dup)
        _expect(fails, "expansion cut short: totals past capacity_out",
                (tots <= ecap).all())
        if fails:
            return fails
        rows, got = _valid(eprows, tots, p), _valid(evals, tots, p)
        # each probe row exactly twice, with its key's two build values
        order = np.argsort(rows, kind="stable")
        _expect(fails, "expansion probe rows: not each row twice",
                np.array_equal(rows[order], np.repeat(np.arange(n), dup)))
        if not fails:
            pairs = np.sort(got[order].reshape(n, dup), axis=1)
            _expect(fails, "expansion values differ from the key's build "
                    "rows", np.array_equal(pairs, ebv.reshape(enk, dup)[epk]))
        return fails

    return (("dist_scan", scan), ("dist_segmented_scan", segmented_scan),
            ("dist_sort", sort), ("dist_group_aggregate", group_by),
            ("dist_group_aggregate_cols", group_by_cols),
            ("dist_hash_join", join),
            ("zipf hash exchange drops", zipf_exchange_drops),
            ("dist_hash_join zipf re-plan", zipf_join),
            ("dist_hash_join defer", join_defer),
            ("dist_sort_sample", sort_sample),
            ("dist_window_cols", window),
            ("dist_window_cols sorted_output", window_sorted),
            ("dist_window_cols lag/lead", lag_lead),
            ("dist_top_k", top_k), ("dist_distinct", distinct),
            ("dist_hash_join_expand defer", expand))


def dryrun_multichip(n_positions: int, *, devices=None) -> dict:
    """Run every check once over a mesh of n_positions positions: the
    first n_positions CUDA cards (raising without them), or the first
    n_positions entries of `devices`. Returns {check: "ok" or what
    failed}."""
    if devices is None:
        mesh = parallel.make_mesh(n_positions)
    else:
        mesh = parallel.make_mesh(n_positions, devices=devices)
    if mesh.size != n_positions:
        raise ValueError(f"{n_positions} positions asked for, "
                         f"{mesh.size} devices given")
    return {name: "; ".join(fails) if fails else "ok"
            for name, fails in ((name, fn()) for name, fn in _cases(mesh))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--positions", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="every position on this device (default: one "
                         "position per CUDA card)")
    a = ap.parse_args(argv)
    devices = None if a.device is None else [a.device] * a.positions
    out = dryrun_multichip(a.positions, devices=devices)
    print(json.dumps(out), flush=True)
    return 0 if all(v == "ok" for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
