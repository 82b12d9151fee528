"""Stripped-stage timing of the composite query pipelines (q1, rollup,
expand).

Counterpart of `cl_ops_tpu/bench/pipeline_probe.py`. Each pipeline's
stages run in isolation on data already on the device, each timed by
`time_adaptive` (a batch deep enough to fill `--target-s`), then the whole
pipeline ("FULL"), whose output is checked against numpy. The stages are
the port's own internals; where a JAX stage has none, the row names what
took its place:
  * "one jnp.cumsum (i32)" is one torch.cumsum, and "one Pallas carry
    scan" one scan_carry launch (aggregate._csum);
  * "ends (scan + 2level search)" is aggregate._group_ends, the port's
    exact search (a sort of the end flags where groups are dense, else a
    scan and torch.searchsorted); the JAX two-level search stops one step
    early and is not copied;
  * q1's sort is the port's real one: the validity bit packed above the
    key in one column (group_aggregate_cols' key_bits), with qty and
    price as payload: 3 columns where JAX sorted 4.
The last line sets the sum of the top-level stages beside FULL: the
probe exists to show that this bill adds up. Indented rows are parts of
the top-level row above them; expand's query, block-bound and glue steps
run between its band passes, so they are top-level here (the JAX probe
indented them, and its sum left them out). A failed check prints what
failed and exits 1. Runs on the card unless given `--device cpu`.

Usage:
  python -m cl_ops_tpu_torch.bench.pipeline_probe --pipe q1 -n 24
  python -m cl_ops_tpu_torch.bench.pipeline_probe --pipe rollup -n 24
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import checks, common
from cl_ops_tpu_torch.models import pipeline as pl
from cl_ops_tpu_torch.ops.exec import aggregate as agg
from cl_ops_tpu_torch.ops.exec import bandprobe, hash_join
from cl_ops_tpu_torch.ops.exec import join as jn
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.rng import threefry
from cl_ops_tpu_torch.ops.scan.segmented import segmented_scan_1d
from cl_ops_tpu_torch.ops.sort import sort_new
from cl_ops_tpu_torch.utils.platform import default_device

Q1_THRESHOLD = 768  # q1_query's default WHERE qty < 768


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pipe", default="q1",
                   choices=["q1", "rollup", "expand"])
    p.add_argument("--dup", type=int, default=4,
                   help="expand: matches per probe")
    p.add_argument("-n", "--log2n", type=int, default=24)
    p.add_argument("--groups", type=int, default=1 << 16)
    p.add_argument("--dim-log2", type=int, default=20)
    p.add_argument("--target-s", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    return p


class _Probe:
    """Times stages and keeps their rows."""

    def __init__(self, n, target_s, dev):
        self.n, self.target_s = n, target_s
        self.sync = common.default_sync(dev)
        self.rows = []

    def stage(self, name, fn, fargs=()):
        """Run fn once (its output is returned), then time it."""
        out = fn(*fargs)
        self.sync(out)
        dt = common.time_adaptive(fn, fargs, self.sync,
                                  target_s=self.target_s)
        self.rows.append((name, dt))
        print(f"  {name:<28s} {dt * 1e3:9.2f} ms  "
              f"({self.n / dt / 1e6:8.1f} Mrows/s)", flush=True)
        return out


def _q1(args, n, dev, probe):
    g = args.groups
    print(f"q1 pipeline probe: n=2^{args.log2n}, groups={g}")
    key_bits = pl._key_bits(g)

    def gen():
        # q1_query's columns and WHERE mask
        ids = torch.arange(n, dtype=torch.int32, device=dev)

        def column(counter, modulus):
            bits = threefry.random_bits(0, ids, counter)
            return (interop.widen_u32(bits) % modulus).to(torch.int32)
        keys, qty, price = column(0, g), column(1, 1024), column(2, 10000)
        return keys, qty, price, qty < Q1_THRESHOLD
    keys, qty, price, mask = probe.stage("gen (threefry x3 + mask)", gen)

    # the pipeline's real sort: (validity << key_bits | key) compared,
    # (qty, price) payload
    def sort3(k, q, p, m):
        packed = ((1 - m.to(torch.int32)) << key_bits) | k
        return psort.sort_i32_cols((packed, q, p), num_keys=1)
    skeys, sqty, sprice = probe.stage("sort 3-col (packed key + 2 pay)",
                                      sort3, (keys, qty, price, mask))
    n_valid = mask.sum(dtype=torch.int64)

    # the whole boundary reduce, six aggregate slots, on the sorted rows
    def reduce(k, q, p, nv):
        return agg._boundary_reduce_cols(
            k, (q, p, q, p, q, p), num_groups=g,
            aggs=("sum", "sum", "min", "max", "count", "mean"),
            key_ordered=(False,) * 6, n_valid=nv)
    probe.stage("boundary reduce (6 aggs)", reduce,
                (skeys, sqty, sprice, n_valid))

    # --- the boundary reduce's sub-stages ---
    def flags(k, nv):
        valid = torch.arange(n, dtype=torch.int32, device=dev) < nv
        one = torch.ones(1, dtype=torch.bool, device=dev)
        return valid, valid & torch.cat([one, k[1:] != k[:-1]])
    valid, is_new = probe.stage("  flags (prev-compare)", flags,
                                (skeys, n_valid))
    probe.stage("  one torch.cumsum (i32)",
                lambda x: torch.cumsum(x.to(torch.int32), 0,
                                       dtype=torch.int32), (is_new,))
    probe.stage("  one scan_carry (i32)",
                lambda x: agg._csum(x, torch.int32), (is_new,))

    def ends(isn, v):
        one = torch.ones(1, dtype=torch.bool, device=dev)
        is_end = v & (torch.cat([isn[1:], one]) | torch.cat([~v[1:], one]))
        return agg._group_ends(is_end, g, n)
    how = "end-flag sort" if g * 64 >= n else "scan + searchsorted"
    probe.stage(f"  ends ({how})", ends, (is_new, valid))
    probe.stage("  segmented max (price)",
                lambda v, f: segmented_scan_1d(v, f.to(torch.int32),
                                               op="max", exclusive=False),
                (sprice, is_new))

    out = probe.stage("FULL q1_query",
                      lambda: pl.q1_query(n, num_groups=g, device=dev))
    return checks.q1(*checks.q1_columns(n, g, 0, dev), g, Q1_THRESHOLD,
                     *out)


def _rollup(args, n, dev, probe):
    nd = 1 << args.dim_log2
    print(f"rollup pipeline probe: n=2^{args.log2n}, dim=2^{args.dim_log2}")

    def gen():
        keys, measures = pl.generate_table(n, 0, key_space=2 * nd,
                                           device=dev)
        return keys, measures.view(torch.int32)
    keys, measures = probe.stage("gen (threefry x2)", gen)

    ids = torch.arange(nd, dtype=torch.int32, device=dev)
    dim_keys = (ids * 2).view(torch.uint32)

    def join_only(k, m):
        return hash_join(dim_keys, ids, k, build_sorted=True,
                         sorted_output=True, probe_impl="banded",
                         probe_cols=(m, k), defer_overflow=True)
    found, _, _, (m_s, k_s), _ = probe.stage(
        "join (sorted_output+defer)", join_only, (keys, measures))

    def agg_only(f, ms, ks):
        return agg.group_aggregate_sorted(
            ks, torch.where(f, ms, 0), num_groups=2 * nd, agg="sum",
            keys_sorted=True)
    probe.stage("aggregate (keys_sorted)", agg_only, (found, m_s, k_s))

    # the probe sort inside the join: (key limb, position) compared, the
    # measure and the key riding
    limb = jn._limbs(keys)[0]
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    probe.stage("  probe sort 4-col (2 keys)",
                lambda a, b, c, d: psort.sort_i32_cols(
                    (a, b, c, d), num_keys=2, pad_safe=True),
                (limb, pos, measures, psort.as_i32(keys)))

    gk, table, cnt, ovf = probe.stage(
        "FULL rollup_query(defer)",
        lambda: pl.rollup_query(n, dim_rows=nd, defer=True, device=dev))
    if bool(ovf):
        # the serving form's contract: a set flag means re-run exactly
        # (probe sides much sparser than the dimension overflow a window)
        print("    band overflow: checking rollup_query(defer=False)")
        gk, table, cnt = pl.rollup_query(n, dim_rows=nd, device=dev)
    return checks.rollup(interop.to_numpy(keys), interop.to_numpy(measures),
                         gk, table, cnt)


def _expand(args, n, dev, probe):
    dup = args.dup
    nd = 1 << args.dim_log2
    nkeys = max(nd // dup, 1)
    rng = np.random.RandomState(8)
    dk = np.arange(nd, dtype=np.uint32) % nkeys
    rng.shuffle(dk)
    dv = np.arange(nd, dtype=np.int32)
    host_pk = rng.randint(0, nkeys, size=n).astype(np.uint32)
    pk = interop.to_torch(host_pk, dev)
    cap = dup * n
    sdk, sdv = sort_new("xla", elem_dtype="uint").sort_with_device_data(
        interop.to_torch(dk, dev), interop.to_torch(dv, dev))
    print(f"expand probe: n=2^{args.log2n} probes x {dup} matches, "
          f"build=2^{args.dim_log2}")
    bl, plimbs, vcols = jn._limbs(sdk), jn._limbs(pk), jn._val_cols(sdv)

    spos, ub, lb = probe.stage(
        "ranges (sort + 2 band)",
        lambda: jn._ranges_sorted(bl, vcols, plimbs, "auto"))

    def pass1_queries(u, l):
        prefix_inc = torch.cumsum(u - l, 0, dtype=torch.int32)
        r = torch.arange(cap, dtype=torch.int32, device=dev)
        return prefix_inc, torch.minimum(
            r, torch.clamp(prefix_inc[-1] - 1, min=0))
    prefix_inc, rq = probe.stage("pass1 queries (cumsum)", pass1_queries,
                                 (ub, lb))

    pr = 128  # _expand_from_ranges_banded's probe rows
    j, _, vps, vns, ovf1 = probe.stage(
        "pass1 band (segment search)",
        lambda pi, l, s, r: bandprobe.probe_banded_sorted(
            (pi,), (pi, l, s), (r,), probe_rows=pr),
        (prefix_inc, lb, spos, rq))
    fails = ["expand: pass 1 band overflow"] if bool(ovf1) else []

    bpos, blo, bhi = probe.stage(
        "pass2 inputs (blk minmax)",
        lambda a, b, c, d: jn._expand_pass2_inputs(
            a, b, c, d, nd, pr * bandprobe.ROW), (vns[1], rq, j, vps[0]))

    ikeys = torch.arange(nd, dtype=torch.int32, device=dev)
    _, _, valsr, _, ovf2 = probe.stage(
        "pass2 band (value pull)",
        lambda b, lo, hi: bandprobe.probe_banded_sorted(
            (ikeys,), tuple(vcols), (b,), probe_rows=pr,
            block_bounds=((lo,), (hi,))), (bpos, blo, bhi))
    print(f"    pass2 band overflow: {bool(ovf2)}")
    if bool(ovf2):
        valsr = probe.stage(
            "pass2 DIRECT gather",
            lambda b: tuple(v[b.to(torch.int64)] for v in vcols), (bpos,))

    probe.stage("glue", lambda a, b, c: jn._expand_glue(a, b, c, cap),
                (vns[2], valsr, prefix_inc))

    out = probe.stage(
        "FULL hash_join_expand",
        lambda p: jn.hash_join_expand(sdk, sdv, p, capacity=cap,
                                      build_sorted=True), (pk,))
    return fails + checks.expansion(host_pk, interop.to_numpy(sdk),
                                    interop.to_numpy(sdv), cap, *out)


PIPES = {"q1": _q1, "rollup": _rollup, "expand": _expand}


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = default_device(args.device)
    n = 1 << args.log2n
    probe = _Probe(n, args.target_s, dev)
    fails = PIPES[args.pipe](args, n, dev, probe)
    total_stages = sum(dt for nm, dt in probe.rows
                       if not nm.startswith(("FULL", "  ")))
    full_dt = probe.rows[-1][1]
    print(f"\n  stage sum (top-level)        {total_stages * 1e3:9.2f} ms"
          f"   vs FULL {full_dt * 1e3:.2f} ms"
          f"   (unaccounted {(full_dt - total_stages) * 1e3:+.2f} ms)")
    print(f"  FULL check: {'FAILED' if fails else 'ok'}")
    for f in fails:
        print(f"pipeline_probe {args.pipe}: check FAILED: {f}",
              file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
