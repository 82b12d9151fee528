"""Kernel-level measurement of the binned radix pass, on the card.

Counterpart of `cl_ops_tpu/bench/radix_dma_probe.py`. Times the two halves
of one blocked radix scatter pass over n int32 keys (RandomState(0), below
2^31) cut into blocks of `--block` keys, and prints the per-pass envelope:

  phase1_localsort: the stable digit sort inside each block. The bitonic
      network's stages K = 2 .. block run through the fused sort's entry
      points (block_sort_, multi_stage_, then per stage the pair_cross_
      passes of `cross_passes` and block_merge_) on the columns (digit *
      block + position, key). The JAX probe's one launch took a
      65536-key block; the merge tile at 2 columns is 16384 rows
      (PERF.md §3), so the stages above it take cross passes, as in the
      full sort.
  phase1_rankhist: the rank/histogram kernel (the counters of the run
      bases) at its own tile, at most 16384 digits (rank_hist's limit);
      a block's histogram is the sum of its tiles'.
  phase2_chunkcopy: the blocked writes: chunk_copy moving the radix-R run
      decomposition (R runs per block, digit-major) to chunk-aligned
      destinations.

Envelope: pass time ~= phase1_localsort + phase2_chunkcopy; u32 keys need
ceil(32 / log2(R)) passes. Checks (the JAX probe had none): each block of
phase 1a holds the block's keys in numpy's stable digit order, ascending
in even blocks and descending in odd ones (the network's last stage K =
block sorts block b ascending iff b * block & K == 0); phase 1b's
histograms equal np.bincount and its ranks the stable rank within each
tile's digit; every run of phase 2 lands where the run table says and the
slack holds the sentinel. A failed check prints what failed and exits 1.

    python -m cl_ops_tpu_torch.bench.radix_dma_probe -n 24 --radix 16

Prints one JSON line: the JAX probe's keys and each phase's launches.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import common
from cl_ops_tpu_torch.ops.sort import bitonic as bt
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
from cl_ops_tpu_torch.utils.bits import is_po2
from cl_ops_tpu_torch.utils.platform import default_device


def radix_run_table(n, block, radix):
    """Phase 2's runs: n int32 keys from RandomState(0), cut into blocks of
    `block` keys; each (block, digit) pair of the low digit is one run, in
    digit-major order, with chunk-aligned destinations. Returns (keys, run
    starts, destinations, lengths, n_chunks) as numpy."""
    keys = np.random.RandomState(0).randint(0, 1 << 31, size=n,
                                            dtype=np.int64).astype(np.int32)
    nb = n // block
    hist = np.bincount(np.repeat(np.arange(nb) * radix, block)
                       + (keys & (radix - 1)),
                       minlength=nb * radix).reshape(nb, radix)
    off_in_block = np.cumsum(hist, axis=1) - hist
    starts = (np.arange(nb)[:, None] * block + off_in_block).T.reshape(-1)
    lengths = hist.T.reshape(-1)
    qlen = (lengths + ds.CHUNK - 1) // ds.CHUNK * ds.CHUNK
    qstarts = np.cumsum(qlen) - qlen
    return (keys, starts.astype(np.int32), qstarts.astype(np.int32),
            lengths.astype(np.int32), n // ds.CHUNK + radix * nb)


def local_sort(cols, block: int):
    """Stages K = 2 .. block of the bitonic network over int32 columns, in
    place: every block sorted on all columns, block b ascending when b is
    even and descending when it is odd."""
    b, m = bt.resolve_geometry(block, len(cols))
    bk.block_sort_(cols, b)
    if m > b:
        bk.multi_stage_(cols, b, m)
    span = bk.cross_span(len(cols))
    k = 2 * m
    while k <= block:
        for j, jl in bk.cross_passes(k, k // 2, m, span):
            bk.pair_cross_(cols, k, j, j_last=jl)
        bk.block_merge_(cols, m, k)
        k *= 2
    return cols


def _launches():
    return {**bk.launches, **{k: v for k, v in rk.launches.items()
                              if k == "rank_hist"}, **ds.launches}


def _counted(fn):
    """The port's kernels that one call of fn launches, and how often (the
    counters are read, not reset)."""
    before = _launches()
    fn()
    return {k: v - before[k] for k, v in _launches().items()
            if v > before[k]}


def check_local_sort(keys, digits, block: int, comb, out) -> list[str]:
    """Each block in numpy's stable digit order: ascending in even blocks,
    descending in odd ones."""
    nb = keys.size // block
    order = np.argsort(np.repeat(np.arange(nb), block) * 256 + digits,
                       kind="stable").reshape(nb, block)
    order[1::2] = order[1::2, ::-1]
    fails = []
    if not np.array_equal(interop.to_numpy(out), keys[order.reshape(-1)]):
        fails.append("phase 1a: keys not in stable digit order per block")
    if not np.array_equal(interop.to_numpy(comb), (
            digits.astype(np.int64) * block
            + np.arange(keys.size) % block)[order.reshape(-1)]):
        fails.append("phase 1a: (digit, position) column out of order")
    return fails


def check_rank_hist(digits, radix: int, tile: int, block: int, rank,
                    hist) -> list[str]:
    """The tiles' histograms summed per block equal np.bincount; each rank
    is the digit's count among the tile's earlier keys."""
    n = digits.size
    nt = n // tile
    key = np.repeat(np.arange(nt), tile) * radix + digits
    want_hist = np.bincount(key, minlength=nt * radix).reshape(nt, radix)
    per_block = interop.to_numpy(hist).reshape(n // block, block // tile,
                                               radix).sum(1)
    fails = []
    if not np.array_equal(per_block, want_hist.reshape(
            n // block, block // tile, radix).sum(1)):
        fails.append("phase 1b: block histograms differ from np.bincount")
    order = np.argsort(key, kind="stable")
    first = np.cumsum(want_hist.reshape(-1)) - want_hist.reshape(-1)
    want_rank = np.empty(n, np.int64)
    want_rank[order] = np.arange(n) - first[key[order]]
    if not np.array_equal(interop.to_numpy(rank), want_rank):
        fails.append("phase 1b: ranks differ from the stable rank")
    return fails


def check_runs(keys, starts, qstarts, lengths, out) -> list[str]:
    """Every run at its destination, and the sentinel in the slack."""
    out = interop.to_numpy(out)
    run = np.repeat(np.arange(len(lengths)), lengths)
    j = np.arange(keys.size) - np.repeat(np.cumsum(lengths) - lengths,
                                         lengths)
    dst = qstarts[run] + j
    fails = []
    if not np.array_equal(out[dst], keys[starts[run] + j]):
        fails.append("phase 2: runs did not land where the table says")
    slack = np.ones(out.size, bool)
    slack[dst] = False
    if not (out[slack] == ds._SENT).all():
        fails.append("phase 2: slack is not the sentinel")
    return fails


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--log2n", type=int, default=24)
    ap.add_argument("--radix", type=int, default=16)
    ap.add_argument("--block", type=int, default=1 << 16,
                    help="keys per block (the JAX probe's 512 rows x 128 "
                         "lanes)")
    ap.add_argument("-r", "--runs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    n = 1 << args.log2n
    R, block = args.radix, args.block
    if not (is_po2(block) and block <= n and 2 <= R <= rk.MAX_RADIX
            and is_po2(R) and R * block <= 1 << 31):
        ap.error("--block must be a power of two <= 2^log2n, --radix a "
                 "power of two in [2, 256], radix x block <= 2^31")
    tile = min(block, rk.MAX_BLOCK_ELEMS)
    rk.check_block_elems(tile)
    nb = n // block
    sync = common.default_sync(dev)
    keys, starts, qstarts, lengths, n_chunks = radix_run_table(n, block, R)
    digits = (keys & (R - 1)).astype(np.int32)
    out, launches, fails = {}, {}, []

    # phase 1a: the block-local stable digit sort on the unique
    # (digit, position) key with the key as payload
    comb = interop.to_torch((digits.astype(np.int64) * block
                             + np.arange(n) % block).astype(np.int32), dev)
    payload = interop.to_torch(keys, dev)

    def sort_blocks():
        return local_sort([comb.clone(), payload.clone()], block)
    t = common.time_async(sort_blocks, (), args.runs, sync)
    out["phase1_localsort_ms"] = t / args.runs * 1e3
    launches["phase1_localsort"] = _counted(sort_blocks)
    c2, k2 = sort_blocks()
    fails += check_local_sort(keys, digits, block, c2, k2)

    # phase 1b: rank_hist, the counters of the run bases
    d = interop.to_torch(digits, dev)
    t = common.time_async(lambda x: rk.rank_hist(x, R, tile), (d,),
                          args.runs, sync)
    out["phase1_rankhist_ms"] = t / args.runs * 1e3
    launches["phase1_rankhist"] = _counted(lambda: rk.rank_hist(d, R, tile))
    fails += check_rank_hist(digits, R, tile, block, *rk.rank_hist(d, R,
                                                                   tile))

    # phase 2: the chunk copy of the run decomposition
    params = ds.plan_run_chunks(
        *(interop.to_torch(a, dev) for a in (starts, qstarts, lengths)),
        n_chunks_static=n_chunks)
    src = interop.to_torch(keys, dev)

    def copy():
        return ds.chunk_copy((src,), params, n_chunks=n_chunks)[0]
    t = common.time_async(copy, (), args.runs, sync)
    out["phase2_chunkcopy_ms"] = t / args.runs * 1e3
    out["phase2_gb_s"] = 2 * n_chunks * ds.CHUNK * 4 / (t / args.runs) / 1e9
    out["phase2_us_per_chunk"] = t / args.runs / n_chunks * 1e6
    qlen = (lengths + ds.CHUNK - 1) // ds.CHUNK * ds.CHUNK
    out["quant_overhead_frac"] = float(qlen.sum() - lengths.sum()) / n
    launches["phase2_chunkcopy"] = _counted(copy)
    fails += check_runs(keys, starts, qstarts, lengths, copy())

    passes = math.ceil(32 / math.log2(R))
    pass_ms = out["phase1_localsort_ms"] + out["phase2_chunkcopy_ms"]
    out["envelope_pass_ms"] = pass_ms
    out["envelope_sort_ms"] = pass_ms * passes
    out["envelope_mkeys_s"] = n / (pass_ms * passes / 1e3) / 1e6
    out.update(n=n, radix=R, nb=nb, n_runs=R * nb, n_chunks=n_chunks,
               passes=passes, block=block, tile=tile, device=str(dev),
               launches=launches, checks="FAILED" if fails else "ok")
    print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in out.items()}), flush=True)
    for f in fails:
        print(f"radix_dma_probe: check FAILED: {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
