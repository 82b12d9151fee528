#!/usr/bin/env python3
"""Smoke run of cl_ops_tpu_torch on one CUDA card.

Builds the CUDA kernels from `cl_ops_tpu_torch/csrc/` (bitonic.cu, scan.cu,
bandprobe.cu, radix.cu, dense_agg.cu and chunk_copy.cu, one nvcc per
source, started together), holds each of the fifteen kernel entry points
against its plain PyTorch version at the main path's shapes (with each
kernel's own device time from torch.profiler beside its event time),
drives the main path
(abitonic sort of 16M u32 keys, KV sort of 16M u64 keys with u32 values,
sort_pipeline at 16M, filter_compact over 64M rows at 10% selectivity,
GROUP BY of 256M rows into 1M groups, analytics_query over 64M rows,
q1_query over 16M rows into 64K groups, a GROUP BY of 16M int64 measures,
the join probe of 256M rows against 16M and of 16M against 1M in three
forms, hash_join_expand of 16M probes x 4 matches, rollup_query 16M x 1M,
star_query over 16M rows, scan_new ("blelloch") over 64M uint32 and
float32 values, satradix KV sorts of 16M u64 keys with u32 values at radix
16 and 256, the vendor sorter "xla" on the same, satradix and sbitonic of
16M u32 keys, abitonic single_launch=1 at 1M and autotune=1 at 16M,
gselect of 64K keys with values, the dense GROUP BY of TPC-H Q1 over 64M
rows and of 64M rows into 1024 groups, window sum + row_number over 16M
rows in 64K partitions in both output forms, top-1K of 64M u32 and a
duplicate flood at 16M, DISTINCT over 64M u32 with 1M values, and the
blocked run copy of one radix-16 pass over 16M keys), checks every result
against torch, numpy or a formula, and times the kernels and the phases
with CUDA events. Then the seven RNG generators (card against CPU at
262144 streams x 10 draws and on the first 4096 of 2^24 streams x 16
draws, HOST_MT states against numpy's), the measured stream ceiling, a
trace with a named() label and timed(), the port's headline JSON line
(`bench/headline.py`), and the sort, scan and rng bench CLIs, each of which
must return 0 with every check "ok". Run from the repository root:

    python3 chip_smoke.py

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, before that one JSON line lists every kernel
with its launches on the main path, time, bound and yardsticks, before
that the script's total seconds, and before that each CUDA kernel's device
ms summed over the traced cells. Any
failure raises and exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# NVIDIA H100 SXM data sheet: device memory rate, and the non-tensor-core
# 32-bit rate (the table lists float32; int32 compares and selects are taken
# at the same rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SEED = 0
SORT_N = 1 << 24
FILTER_N = 1 << 26
FILTER_THRESHOLD = 429496730  # u32 values below it: 10% of the range
GROUPBY_N = 1 << 28          # BASELINE config 4: 256M rows, 1M groups
GROUPBY_G = 1 << 20
ANALYTICS_N = 1 << 26        # BASELINE configs 3 + 4 chained
Q1_N, Q1_G = 1 << 24, 1 << 16  # bench_all.py q1_16Mx64K
SCAN_N = 1 << 24
JOIN_BIG = (1 << 28, 1 << 24)  # bench_all.py config 12: 256M x 16M
JOIN_MID = (1 << 24, 1 << 20)  # bench_all.py config 5: 16M x 1M
EXPAND_M, EXPAND_NB = 1 << 24, 1 << 22  # bench_all.py config 6
ROLLUP_N, ROLLUP_DIM = 1 << 24, 1 << 20  # bench_all.py config 7
STAR_N, STAR_DIM, STAR_CATS = 1 << 24, 1 << 14, 256  # README star_query
BLOCK_SCAN_N = 1 << 26  # scan_bench.py: the top of its default sweep
DENSE_N, DENSE_GROUPS = 1 << 24, (4, 8, 200, 1024)  # dense_agg's kernel phase
Q1D_N = 1 << 26              # TPC-H Q1 over lineitem at about SF 10
DENSE_BIG_N = 1 << 26        # DENSE_MAX_GROUPS groups
WINDOW_N, WINDOW_G = 1 << 24, 1 << 16  # bench_all.py config 9
TOPK_N, TOPK_K = 1 << 26, 1024         # bench_all.py config 10
FLOOD_N, FLOOD_K = 1 << 24, 10         # test_topk.py's flood, scaled
DISTINCT_N, DISTINCT_U = 1 << 26, 1 << 20  # bench_all.py config 11
DMA_N, DMA_BLOCK, DMA_RADIX = 1 << 24, 1 << 16, 16  # radix_dma_probe.py
RNG_STREAMS, RNG_DRAWS = 262144, 10  # rng_bench.py's defaults (ref gws)
RNG_BIG_STREAMS, RNG_BIG_DRAWS = 1 << 24, 16  # 2^28 values: BASELINE cfg 4
RNG_CHECK_STREAMS = 4096


def phase(name):
    """Print a phase's seconds on a line of its own when it ends."""
    class _P:
        def __enter__(self):
            self.t = time.perf_counter()
            print(f"== {name}", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"phase {name}: {time.perf_counter() - self.t:.3f} s",
                      flush=True)
    return _P()


def cuda_ms(fn, reps, before=None):
    """Median milliseconds of fn() over reps runs timed with CUDA events;
    before() runs untimed ahead of each run."""
    import torch
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# The CUDA kernel each kernel record times: a substring of its name in the
# profiler (multi_stage is block_sort_kernel from stage 2B; both rank_hist
# entry points run rank_hist_kernel).
DEVICE_KERNEL = {
    "block_sort": "block_sort_kernel", "multi_stage": "block_sort_kernel",
    "pair_cross": "pair_cross_kernel", "block_merge": "block_merge_kernel",
    "whole_sort": "whole_sort_kernel", "scan_carry": "carry_tiles",
    "scan_carry_wide": "carry_tiles", "seg_scan_carry": "seg_tiles",
    "scan_block": "scan_block_tiles", "scan_block_wide": "scan_block_tiles",
    "probe_band": "probe_band_kernel", "rank_hist": "rank_hist_kernel",
    "rank_hist_limb": "rank_hist_kernel", "dense_agg": "dense_agg_kernel",
    "chunk_copy": "chunk_copy_kernel",
}


def kernel_ms(name, fn, reps, before=None):
    """{"ms": fn's median time by CUDA events, wrapper included, "device_ms":
    the kernel's own mean device time over reps runs in a torch.profiler
    trace}; before() runs untimed ahead of each run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ms = cuda_ms(fn, reps, before)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages()
             if DEVICE_KERNEL[name] in e.key
             and e.device_type == torch.autograd.DeviceType.CUDA)
    return {"ms": ms, "device_ms": us / 1e3 / reps}


# Device ms of each of the port's CUDA kernels (DEVICE_KERNEL's values)
# summed over every cell that device_breakdown traces.
PROFILED_MS = dict.fromkeys(sorted(set(DEVICE_KERNEL.values())), 0.0)

KERNEL_GROUPS = (("bitonic", ("block_sort", "multi_stage", "pair_cross",
                              "block_merge", "whole_sort")),
                 ("scan", ("seg_tiles", "carry_tiles", "scan_block_tiles")),
                 ("join", ("probe_band",)),
                 ("radix", ("rank_hist",)),
                 ("dense", ("dense_agg",)),
                 ("copy", ("chunk_copy",)))


def device_breakdown(cell, fn):
    """Trace one fn() with torch.profiler and print the device time by
    kernel group (the port's bitonic, scan, band-probe, rank_hist,
    dense_agg and chunk_copy kernels, torch's own kernels, copies and
    fills), the call's time on the
    host clock and the device's idle share of it. The trace takes device
    activity only, after one traced warm-up call whose events are
    dropped: without the warm-up, the H100's traces lost kernels late in
    the script (the dense cells' dense_agg launches in every run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(
                     p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        prof.step()
    groups, top = {}, {}
    for e in traced[0]:
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), None)
        if group is None:
            group = "copies and fills" if any(
                k in name.lower() for k in ("memcpy", "memset", "fill")) \
                else "torch ops"
        groups[group] = groups.get(group, 0.0) + us / 1e3
        top[name[:60]] = top.get(name[:60], 0.0) + us / 1e3
        for key in PROFILED_MS:
            if key in name:
                PROFILED_MS[key] += us / 1e3
    busy = sum(groups.values())
    print(json.dumps({
        "profile": cell, "wall_ms": wall_ms, "device_ms": busy,
        "idle_share": 1 - busy / wall_ms if wall_ms else None,
        "device_ms_by_group": groups,
        "top_kernels_ms": dict(sorted(top.items(),
                                      key=lambda kv: -kv[1])[:8])}))


def kernel_record(name, source, err, times, plain_ms, nbytes, ops, library_ms,
                  shape, **extra):
    """One kernel's line: `times` from kernel_ms; its bound is the larger of
    nbytes over the memory rate and ops over the 32-bit rate."""
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            **times, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, **extra, "shape": shape}


def max_abs_err(got, want):
    """Largest |got - want| over pairs of integer tensors."""
    import torch
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def scan_record(name, n, kern, plain, library, nbytes, shape, tol=None,
                **extra):
    """Run a scan kernel and plain version on the same inputs, compare (exact,
    or within tol(got, want) elementwise), time both and the library
    call; returns the kernel's record (with `extra`'s keys)."""
    import torch
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if got.dtype.is_floating_point:
        nan = got.isnan()
        if not torch.equal(nan, want.isnan()):
            raise AssertionError(f"{name} {shape}: NaNs differ")
        diff = torch.where(nan, 0.0, (got - want).abs())
        err = float(diff.max())
        ok = bool((diff <= tol(got, want)).all()) if tol else err == 0
    else:
        ok, err = torch.equal(got, want), 0
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel differs from its "
                             f"plain version (max abs err {err})")
    del got, want
    # one add or compare per element
    return kernel_record(name, "cl_ops_tpu_torch/csrc/scan.cu", err,
                         kernel_ms(name, kern, 7), cuda_ms(plain, 3), nbytes,
                         n,
                         cuda_ms(library, 7) if library else None, shape,
                         **extra)


def band_record(shape, build, vals, probes, block, windowed):
    """probe_band against its plain version on one probe set: window starts
    from window_starts over sorted probes (as probe_banded_sorted computes
    them), or all zero for the direct shape. Times both and the library's
    torch.searchsorted (the count alone); returns the kernel's record."""
    import torch
    from cl_ops_tpu_torch.ops.exec import bandprobe as bp
    m, nb, nl, nv = (probes[0].numel(), build[0].numel(), len(build),
                     len(vals))
    dev = probes[0].device
    grid = -(-m // block)
    if windowed:
        heads = torch.arange(grid, device=dev) * block
        tails = (heads + block).clamp(max=m) - 1
        starts, ovf = bp.window_starts(build, [p[heads] for p in probes],
                                       [p[tails] for p in probes])
        if bool(ovf):
            raise AssertionError(f"probe_band {shape}: a window overflowed")
    else:
        starts = torch.zeros(grid, dtype=torch.int32, device=dev)

    def kern():
        return bp.probe_band(build, vals, probes, starts, block)

    def plain():
        return bp.probe_band_plain(build, vals, probes, starts, block)
    got, want = kern(), plain()
    err = max_abs_err((got[0], got[1], *got[2], *got[3]),
                      (want[0], want[1], *want[2], *want[3]))
    if err:
        raise AssertionError(f"probe_band {shape}: kernel differs from its "
                             f"plain version (max abs err {err})")
    del got, want
    lib_b, lib_p = ((build[0], probes[0]) if nl == 1 else
                    (bp._composite(build), bp._composite(probes)))
    # the bound reads each input once (probe limbs, the build's limbs and
    # values) and writes each output once (count 4, eq 1, 8 per value
    # column); the model also counts the window loads of every probe block
    nbytes = m * nl * 4 + m * (5 + 8 * nv) + nb * (nl + nv) * 4
    ops = 2 * nl * m * bp.WINDOW.bit_length()  # compare + select per step
    return kernel_record(
        "probe_band", "cl_ops_tpu_torch/csrc/bandprobe.cu", err,
        kernel_ms("probe_band", kern, 7), cuda_ms(plain, 3), nbytes, ops,
        cuda_ms(lambda: torch.searchsorted(lib_b, lib_p, right=True), 7),
        shape, model_bytes=bp.band_pass_traffic_bytes(m, nl, nb,
                                                      block // bp.ROW, nv))


def band_kernel_records(dev):
    """probe_band at the join cells' shapes (1 limb, 1 value, sorted
    probes), with 2 limbs and 3 values, and in the direct form."""
    import torch
    from cl_ops_tpu_torch.ops.exec import bandprobe as bp
    from cl_ops_tpu_torch.ops.exec import join as jn
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randint(hi, n, dtype=torch.int32):
        return torch.randint(0, hi, (n,), dtype=dtype, device=dev,
                             generator=gen)
    recs = {}
    for m, nb in (JOIN_BIG, JOIN_MID):
        build = (torch.arange(nb, dtype=torch.int32, device=dev),)
        probes = (torch.sort(randint(nb, m)).values,)
        recs[f"{m}x{nb}"] = band_record(
            f"m={m} nb={nb} 1 limb 1 value, sorted uniform probes",
            build, (build[0] * 7 + 1,), probes,
            jn._band_probe_rows(m, nb) * bp.ROW, True)
        del probes
    m, nb = JOIN_MID
    k = torch.arange(nb, dtype=torch.int64, device=dev) * 3
    p = torch.sort(randint(3 * nb, m, torch.int64)).values
    recs["2 limbs 3 values"] = band_record(
        f"m={m} nb={nb} 2 limbs 3 values, sorted uniform probes",
        ((k >> 10).to(torch.int32), (k & 1023).to(torch.int32)),
        tuple(randint(2 ** 31 - 1, nb) for _ in range(3)),
        ((p >> 10).to(torch.int32), (p & 1023).to(torch.int32)),
        jn._band_probe_rows(m, nb) * bp.ROW, True)
    del k, p
    nb = bp.DIRECT_MAX
    build = (torch.arange(nb, dtype=torch.int32, device=dev) * 2,)
    recs["direct"] = band_record(
        f"m={STAR_N} nb={nb} direct, unsorted probes", build,
        (build[0] + 5,), (randint(2 * nb, STAR_N),),
        bp.PROBE_ROWS * bp.ROW, False)
    return recs


def block_sort_ptxas(log):
    """{"<columns, rows>": "<spill line>; <registers line>"} of the
    block_sort_kernel instances (which block_sort and multi_stage share),
    read from nvcc's -Xptxas -v log: each entry line is followed by its
    spill line, then its register line."""
    import re
    out, inst = {}, None
    for line in log.splitlines():
        m = re.search(r"'_Z\d+block_sort_kernelILi(\d+)ELi(\d+)E", line)
        if m:
            inst = f"<{m.group(1)}, {m.group(2)}>"
            out[inst] = []
        elif inst and ("spill" in line or "registers" in line):
            out[inst].append(line.replace("ptxas info    :", "").strip())
            if "registers" in line:
                inst = None
    return {k: "; ".join(v) for k, v in out.items()}


def bitonic_record(name, kern, plain, args, state, num_keys, steps, library,
                   shape):
    """One fused-schedule kernel against its plain version on copies of
    `state`, timed (each run from the same input) beside its plain version
    and the library call; returns (record, the plain version's output)."""
    import torch
    n, nc = state[0].numel(), len(state)
    src = [c.clone() for c in state]
    work = [c.clone() for c in state]
    ref = [c.clone() for c in state]
    kern(work, *args, num_keys=num_keys)
    plain(ref, *args, num_keys)
    torch.cuda.synchronize()
    err = max_abs_err(work, ref)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")

    def restore():
        for w, s in zip(work, src):
            w.copy_(s)
    ms = kernel_ms(name, lambda: kern(work, *args, num_keys=num_keys), 7,
                   restore)
    plain_ms = cuda_ms(lambda: plain(work, *args, num_keys), 3, restore)
    lib_ms = cuda_ms(library, 5) if library is not None else None
    return kernel_record(name, "cl_ops_tpu_torch/csrc/bitonic.cu", err, ms,
                         plain_ms, 2 * nc * 4 * n,
                         2 * num_keys * (n // 2) * steps, lib_ms, shape), ref


def groupby_multi_stage_record(dev):
    """multi_stage at GROUP BY 256M x 1M's geometry: (key, value) columns,
    one key column with 256 rows a key, on the runs block_sort leaves."""
    import torch
    from cl_ops_tpu_torch.ops.sort import bitonic as bt
    from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cols = [torch.randint(0, hi, (GROUPBY_N,), dtype=torch.int32, device=dev,
                          generator=gen) for hi in (GROUPBY_G, 100)]
    b, m = bt.resolve_geometry(GROUPBY_N, 2)
    bk.block_sort_(cols, b, 1)
    steps = sum(range(b.bit_length(), m.bit_length()))
    rec, _ = bitonic_record(
        "multi_stage", bk.multi_stage_, bk.multi_stage_plain, (b, m), cols, 1,
        steps, None, f"n={GROUPBY_N} cols=2 num_keys=1 block={b} merge={m} "
                     f"(GROUP BY 256M x 1M)")
    return rec


def block_scan_records(dev, n):
    """scan_block (uint32 bits, float32) and scan_block_wide (uint32 ->
    64-bit sums) against their plain versions, with the tile bases the
    3-phase scan computes."""
    import torch
    from cl_ops_tpu_torch.ops.scan import kernels as sk
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    xi = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                       device=dev, generator=gen)
    xf = torch.rand(n, device=dev, generator=gen) * 2 - 1
    xu = xi.view(torch.uint32)
    bi = sk._tile_bases(xi, torch.int32)
    bf = sk._tile_bases(xf, torch.float32)
    bw = sk._tile_bases(xu, torch.int64)

    def f32_tol(got, want):
        # float32 sums of one tile in two orders, plus the base: 1e-5 of
        # the running sum of |x| in the tile and |base|, plus 1e-6
        return 1e-5 * sk.scan_block_plain(xf.abs(), bf.abs(), False) + 1e-6
    return {
        "scan_block uint32": scan_record(
            "scan_block", n, lambda: sk.scan_block(xi, bi),
            lambda: sk.scan_block_plain(xi, bi, False),
            lambda: torch.cumsum(xi, 0, dtype=torch.int32), 8 * n,
            f"n={n} uint32 bits inclusive"),
        "scan_block float32": scan_record(
            "scan_block", n, lambda: sk.scan_block(xf, bf),
            lambda: sk.scan_block_plain(xf, bf, False),
            lambda: torch.cumsum(xf, 0), 8 * n, f"n={n} float32 inclusive",
            f32_tol),
        "scan_block_wide": scan_record(
            "scan_block_wide", n, lambda: sk.scan_block_wide(xu, bw, True),
            lambda: sk.scan_block_wide_plain(xu, bw, True),
            lambda: torch.cumsum(xi, 0, dtype=torch.int64), 12 * n,
            f"n={n} uint32 -> 64-bit sums exclusive")}


def report(cell, fn, reps, model_bytes, launches, rows, **extra):
    """Time a cell's call with CUDA events, trace it once, and print its
    line: ms, Mrows/s, model bytes and their bound, launches."""
    ms = cuda_ms(fn, reps)
    device_breakdown(cell, fn)
    bound_ms = model_bytes / PEAK_BYTES_S * 1e3
    print(json.dumps({"cell": cell, "ms": ms, "mrows_s": rows / ms / 1e3,
                      "model_bytes": model_bytes, "bound_ms": bound_ms,
                      "bound_share": bound_ms / ms, "launches": launches,
                      **extra}), flush=True)
    return ms


def join_cells(dev, reset, count):
    """The join and scan_new cells: each driven once between reset() and
    count(), checked against numpy or a formula that needs no join, timed
    with CUDA events and traced once."""
    import numpy as np
    import torch

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.models import pipeline
    from cl_ops_tpu_torch.ops.exec import bandprobe as bp
    from cl_ops_tpu_torch.ops.exec import hash_join, hash_join_expand, psort
    from cl_ops_tpu_torch.ops.exec import join as jn
    from cl_ops_tpu_torch.ops.rng import threefry
    from cl_ops_tpu_torch.ops.scan import kernels as sk
    from cl_ops_tpu_torch.ops.scan import scan_new
    from cl_ops_tpu_torch.ops.sort import sort_new

    def check(name, ok):
        if not ok:
            raise AssertionError(name)

    def u32(t):
        return interop.widen_u32(t)

    def dim_and_probes(m, nb, seed_dim, seed_probe):
        """bench_all.py configs 5 and 12: a shuffled arange dimension with
        values key * 7 + 1 (sorted by the abitonic Sorter), probes
        uniform over its keys."""
        dim = np.arange(nb, dtype=np.uint32)
        np.random.RandomState(seed_dim).shuffle(dim)
        dimv = (dim * 7 + 1).astype(np.uint32)
        probe = np.random.RandomState(seed_probe).randint(
            0, nb, size=m).astype(np.uint32)
        sdk, sdv = sort_new("abitonic").sort_with_device_data(
            interop.to_torch(dim, dev), interop.to_torch(dimv, dev))
        return sdk, sdv, interop.to_torch(probe, dev)

    def check_probe(tag, probe, found, vals, rows=None):
        keys = u32(probe) if rows is None else \
            u32(probe)[rows.to(torch.int64)]
        check(f"{tag}: every probe found", bool(found.all()))
        check(f"{tag}: values", torch.equal(u32(vals),
                                            (keys * 7 + 1) & 0xFFFFFFFF))
        if rows is not None:
            check(f"{tag}: rows a permutation", bool((torch.bincount(
                rows.to(torch.int64), minlength=probe.numel()) == 1).all()))
            check(f"{tag}: rows in key order",
                  bool((keys[1:] >= keys[:-1]).all()))

    # join probe 256M x 16M: bench_all.py config 12, the serving form
    m, nb = JOIN_BIG
    with phase(f"join probe {m} x {nb}, sorted_output, deferred"):
        reset()
        sdk, sdv, probe = dim_and_probes(m, nb, 15, 16)

        def big():
            return hash_join(sdk, sdv, probe, build_sorted=True,
                             sorted_output=True, defer_overflow=True)
        found, vals, rows, ovf = big()
        torch.cuda.synchronize()
        launches = count("join probe big")
        check("join big: overflow flag clear", not bool(ovf))
        check_probe("join big", probe, found, vals, rows)
        del found, vals, rows
        pr = jn._band_probe_rows(m, nb)
        report(f"join probe {m} x {nb} sorted_output deferred", big, 3,
               psort.sort_traffic_bytes(m, 2)
               + bp.band_pass_traffic_bytes(m, 1, nb, pr), launches, m)
        del sdk, sdv, probe

    # join probe 16M x 1M in three forms: bench_all.py config 5
    m, nb = JOIN_MID
    with phase(f"join probe {m} x {nb}: restore, sorted_output, deferred"):
        reset()
        sdk, sdv, probe = dim_and_probes(m, nb, 6, 7)
        count("join mid build sort")
        pr = jn._band_probe_rows(m, nb)
        band = bp.band_pass_traffic_bytes(m, 1, nb, pr)
        sort2 = psort.sort_traffic_bytes(m, 2)
        forms = {
            "restore": (dict(), sort2 + band + sort2),
            "sorted_output": (dict(sorted_output=True), sort2 + band),
            "deferred": (dict(sorted_output=True, defer_overflow=True),
                         sort2 + band)}
        for form, (kw, model) in forms.items():
            def fn(kw=kw):
                return hash_join(sdk, sdv, probe, build_sorted=True, **kw)
            reset()
            out = fn()
            torch.cuda.synchronize()
            launches = count(f"join mid {form}")
            if form == "deferred":
                check("join mid: overflow flag clear", not bool(out[-1]))
            check_probe(f"join mid {form}", probe, out[0], out[1],
                        out[2] if kw else None)
            del out
            report(f"join probe {m} x {nb} {form}", fn, 3, model, launches,
                   m)
        del sdk, sdv, probe

    # hash_join_expand 16M probes x 4 matches, 4M build: config 6
    m, nb = EXPAND_M, EXPAND_NB
    with phase(f"join expand {m} x 4, build {nb}"):
        reset()
        nkeys = nb // 4
        dk = np.arange(nb, dtype=np.uint32) % nkeys
        np.random.RandomState(8).shuffle(dk)
        d_dk = interop.to_torch(dk, dev)
        d_pk = interop.to_torch(np.random.RandomState(9).randint(
            0, nkeys, size=m).astype(np.uint32), dev)
        sdk, sdv = sort_new("abitonic").sort_with_device_data(
            d_dk, torch.arange(nb, dtype=torch.int32, device=dev))
        cap = 4 * m

        def expand():
            return hash_join_expand(sdk, sdv, d_pk, capacity=cap,
                                    build_sorted=True)
        total, pidx, evals = expand()
        torch.cuda.synchronize()
        launches = count("join expand")
        check("expand total", int(total) == cap)
        pidx64 = pidx.to(torch.int64)
        check("expand pairs match", torch.equal(
            u32(d_dk)[evals.to(torch.int64)], u32(d_pk)[pidx64]))
        check("expand 4 per probe", bool((torch.bincount(
            pidx64, minlength=m) == 4).all()))
        del total, pidx, evals, pidx64
        prm = jn._band_probe_rows(m, nb)
        report(f"join expand {m} x 4", expand, 3,
               psort.sort_traffic_bytes(m, 2)
               + 2 * bp.band_pass_traffic_bytes(m, 1, nb, prm) + 2 * 4 * m
               + bp.band_pass_traffic_bytes(cap, 1, m, 128, n_vals=3)
               + bp.band_pass_traffic_bytes(cap, 1, nb, 128) + 3 * 4 * cap,
               launches, cap, unit="rows are match pairs")
        del sdk, sdv, d_dk, d_pk

    # rollup_query 16M x 1M, the serving form: config 7
    n, nd = ROLLUP_N, ROLLUP_DIM
    with phase(f"rollup_query {n} x {nd}, defer"):
        def rollup():
            return pipeline.rollup_query(n, dim_rows=nd, seed=SEED,
                                         defer=True, device=dev)
        reset()
        gk, table, cnt, ovf = rollup()
        torch.cuda.synchronize()
        launches = count("rollup_query")
        check("rollup: overflow flag clear", not bool(ovf))
        keys, meas = (interop.to_numpy(t) for t in pipeline.generate_table(
            n, SEED, key_space=2 * nd, device=dev))
        uniq = np.unique(keys)
        contrib = np.where(keys % 2 == 0, meas.astype(np.int64), 0)
        sums = np.bincount(keys, weights=contrib, minlength=2 * nd)[uniq]
        c = int(cnt)
        check("rollup count", c == len(uniq))
        check("rollup keys", np.array_equal(interop.to_numpy(gk)[:c], uniq))
        check("rollup sums", np.array_equal(
            interop.to_numpy(table)[:c].astype(np.float64), sums))
        del gk, table, keys, meas, contrib
        report(f"rollup_query {n} x {nd} defer", rollup, 3,
               psort.sort_traffic_bytes(n, 4)
               + bp.band_pass_traffic_bytes(n, 1, nd,
                                            jn._band_probe_rows(n, nd))
               + 8 * 4 * n, launches, n, groups=c)

    # star_query 16M, 16384 dim rows, 256 categories: README, pipeline
    n, nd, cats = STAR_N, STAR_DIM, STAR_CATS
    with phase(f"star_query {n}, dim {nd}, {cats} categories"):
        def star():
            return pipeline.star_query(n, dim_rows=nd, num_cats=cats,
                                       seed=SEED, device=dev)
        reset()
        s_cnt, s_table = star()
        torch.cuda.synchronize()
        launches = count("star_query")
        keys, vals = (interop.to_numpy(t) for t in pipeline.generate_table(
            n, SEED, key_space=nd, device=dev))
        ids = torch.arange(nd, dtype=torch.int32, device=dev)
        cat = (u32(threefry.random_bits(SEED + 1, ids, 2)) % cats).cpu() \
            .numpy()
        keep = vals < 512
        want = np.bincount(cat[keys[keep]], weights=vals[keep],
                           minlength=cats).astype(np.uint64) % (1 << 32)
        check("star count", int(s_cnt) == int(keep.sum()))
        check("star table", np.array_equal(
            interop.to_numpy(s_table).astype(np.uint64), want))
        del keys, vals, s_table
        report(f"star_query {n} dim {nd}", star, 3,
               psort.sort_traffic_bytes(n, 3)
               + bp.band_pass_traffic_bytes(n, 1, nd)
               + psort.sort_traffic_bytes(n, 2)
               + sk.scan_traffic_bytes(n, torch.uint32), launches, n,
               kept=int(s_cnt))

    # scan_new("blelloch"): the top of scan_bench's default sweep
    n = BLOCK_SCAN_N
    rng = np.random.default_rng(SEED + 7)
    for elem, exclusive in (("uint", True), ("float", True)):
        with phase(f"scan_new blelloch {n} {elem}"):
            scanner = scan_new("blelloch", elem_dtype=elem)
            if elem == "uint":
                hx = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
            else:
                hx = rng.uniform(-1, 1, n).astype(np.float32)
            dx = interop.to_torch(hx, dev)

            def scan(dx=dx, scanner=scanner, exclusive=exclusive):
                return scanner.scan_with_device_data(dx, exclusive=exclusive)
            reset()
            got = interop.to_numpy(scan())
            launches = count(f"scan_new {elem}")
            if elem == "uint":
                inc = np.cumsum(hx.astype(np.uint64))
                check("scan_new uint -> ulong", np.array_equal(
                    got, inc - hx if exclusive else inc))
                err = 0.0
            else:
                # float32 tiles with float64 tile bases against float64
                # sums: within 1e-6 of the running sum of |x|, plus 1e-6
                x64 = hx.astype(np.float64)
                exact = np.cumsum(x64) - (x64 if exclusive else 0)
                err = float(np.abs(got - exact).max())
                check("scan_new float32", bool((np.abs(got - exact) <= 1e-6
                                                * np.cumsum(np.abs(x64))
                                                + 1e-6).all()))
            del got
            report(f"scan_new blelloch {n} {elem} -> "
                   f"{str(scanner.sum_dtype).removeprefix('torch.')}",
                   scan, 5, sk.scan_traffic_bytes(
                       n, scanner.sum_dtype, single_pass=False,
                       elem_dtype=scanner.elem_dtype), launches, n,
                   max_abs_err_vs_float64=err)
            del dx, hx


def sort_family_kernel_records(dev):
    """rank_hist over 16M digits at radix 16 and 256, rank_hist_limb over
    16M limbs at a middle and the last shift of each, pair_cross at J = 1,
    16, 32 and 1024 over 16M u32 keys, and whole_sort at 1M, at its
    capacity (2^21 keys) and over 2^19 rows of three columns with two
    keys, each against its plain version and the library bit for bit."""
    import torch
    from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
    from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
    from cl_ops_tpu_torch.ops.sort import satradix as sr
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n = SORT_N
    recs = {}
    for radix in (16, 256):
        d = torch.randint(0, radix, (n,), dtype=torch.int32, device=dev,
                          generator=gen)
        block = rk.BLOCK_ELEMS
        got = rk.rank_hist(d, radix)
        want = rk.rank_hist_plain(d, radix, block)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"rank_hist radix {radix}: kernel differs "
                                 f"from its plain version ({err})")
        n_blocks = got[1].shape[0]
        del got, want
        # read each digit, write its rank and the histogram; one count per
        # digit
        recs[f"rank_hist {radix}"] = kernel_record(
            "rank_hist", "cl_ops_tpu_torch/csrc/radix.cu", err,
            kernel_ms("rank_hist", lambda: rk.rank_hist(d, radix), 7),
            cuda_ms(lambda: rk.rank_hist_plain(d, radix, block), 3),
            8 * n + 4 * n_blocks * radix, n, None,
            f"n={n} radix={radix} tile={block}")
        del d
        # the sorter's pass: the digit cut from a limb, at a middle shift
        # and at the last (the sign bit's flip); read the limb, write rank
        # and bucket and the histogram
        limb = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                             device=dev, generator=gen)
        shifts = sr.pass_shifts(radix)
        for shift in (shifts[len(shifts) // 2], shifts[-1]):
            got = rk.rank_hist_limb(limb, shift, radix)
            want = rk.rank_hist_limb_plain(limb, shift, radix, block)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"rank_hist_limb radix {radix} shift "
                                     f"{shift}: kernel differs from its "
                                     f"plain version ({err})")
            del got, want
            recs[f"rank_hist_limb {radix} {shift}"] = kernel_record(
                "rank_hist_limb", "cl_ops_tpu_torch/csrc/radix.cu", err,
                kernel_ms("rank_hist_limb",
                          lambda: rk.rank_hist_limb(limb, shift, radix), 7),
                cuda_ms(lambda: rk.rank_hist_limb_plain(limb, shift, radix,
                                                        block), 3),
                12 * n + 4 * n_blocks * radix, n, None,
                f"n={n} radix={radix} shift={shift} tile={block}")
        del limb
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                      device=dev, generator=gen)
    for j in (1, 16, 32, 1024):
        work, ref = [x.clone()], [x.clone()]
        bk.pair_cross_(work, 2 * j, j)
        bk.pair_cross_plain(ref, 2 * j, j, 1)
        torch.cuda.synchronize()
        err = max_abs_err(work, ref)
        if err:
            raise AssertionError(f"pair_cross J={j}: kernel differs from its "
                                 f"plain version ({err})")

        def restore(work=work):
            work[0].copy_(x)
        recs[f"pair_cross {j}"] = kernel_record(
            "pair_cross", "cl_ops_tpu_torch/csrc/bitonic.cu", err,
            kernel_ms("pair_cross", lambda: bk.pair_cross_(work, 2 * j, j),
                      7, restore),
            cuda_ms(lambda: bk.pair_cross_plain(work, 2 * j, j, 1), 3,
                    restore), 2 * 4 * n, 2 * (n // 2), None,
            f"n={n} cols=1 K={2 * j} J={j}")
        del work, ref
    for wn in (1 << 20, bk.WHOLE_MAX):
        xw = x[:wn].clone()
        work, ref = [xw.clone()], [xw.clone()]
        bk.whole_sort_(work)
        bk.whole_sort_plain(ref, 1)
        torch.cuda.synchronize()
        err = max_abs_err(work, ref)
        if err or not torch.equal(work[0], torch.sort(xw).values):
            raise AssertionError(f"whole_sort n={wn}: kernel differs from its "
                                 f"plain version ({err}) or from torch.sort")

        def restore(work=work, xw=xw):
            work[0].copy_(xw)
        sl, rows = bk.whole_geometry(wn, 1)
        recs[f"whole_sort {wn}"] = kernel_record(
            "whole_sort", "cl_ops_tpu_torch/csrc/bitonic.cu", err,
            kernel_ms("whole_sort", lambda: bk.whole_sort_(work), 7,
                      restore),
            cuda_ms(lambda: bk.whole_sort_plain(work, 1), 3, restore),
            2 * 4 * wn, 2 * (wn // 2) * bk.sbitonic_steps(wn),
            cuda_ms(lambda: torch.sort(xw), 7),
            f"n={wn} cols=1 slice={sl} rows/thread={rows} blocks={wn // sl}")
        del work, ref, xw
    # three columns, two of them keys: (key, key, row index) at the most
    # rows three columns hold; the library sorts the two keys as one int64
    # and gathers the columns
    wn, nk = bk.WHOLE_MAX // 4, 2
    src = [x[:wn].clone(), x[wn:2 * wn].clone(),
           torch.arange(wn, dtype=torch.int32, device=dev)]
    work, ref = [c.clone() for c in src], [c.clone() for c in src]
    bk.whole_sort_(work, nk)
    bk.whole_sort_plain(ref, nk)
    torch.cuda.synchronize()
    err = max_abs_err(work, ref)

    def lib_sort3():
        key = (src[0].to(torch.int64) << 32) | (
            src[1].to(torch.int64) + (1 << 31))
        order = torch.sort(key, stable=True).indices
        return [c[order] for c in src]
    if err or not all(torch.equal(a, b) for a, b in zip(work, lib_sort3())):
        raise AssertionError(f"whole_sort n={wn} x 3: kernel differs from its "
                             f"plain version ({err}) or from torch.sort")

    def restore3(work=work):
        for w, c in zip(work, src):
            w.copy_(c)
    sl, rows = bk.whole_geometry(wn, 3)
    recs[f"whole_sort {wn}x3"] = kernel_record(
        "whole_sort", "cl_ops_tpu_torch/csrc/bitonic.cu", err,
        kernel_ms("whole_sort", lambda: bk.whole_sort_(work, nk), 7,
                  restore3),
        cuda_ms(lambda: bk.whole_sort_plain(work, nk), 3, restore3),
        2 * 3 * 4 * wn, 2 * nk * (wn // 2) * bk.sbitonic_steps(wn),
        cuda_ms(lib_sort3, 7),
        f"n={wn} cols=3 num_keys={nk} slice={sl} rows/thread={rows} "
        f"blocks={wn // sl}")
    del work, ref, src
    return recs


def sort_family_cells(dev, reset, count):
    """The satradix, sbitonic, single-launch, autotune, gselect and xla
    cells: each driven once between reset() and count(), checked against
    numpy or torch.sort, timed with CUDA events and traced once."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.ops.sort import autotune
    from cl_ops_tpu_torch.ops.sort import bitonic as bt
    from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
    from cl_ops_tpu_torch.ops.sort import keys as keymod
    from cl_ops_tpu_torch.ops.sort import satradix as sr
    from cl_ops_tpu_torch.ops.sort import sort_new

    def check(name, ok):
        if not ok:
            raise AssertionError(name)

    def drive(tag, fn):
        reset()
        out = fn()
        torch.cuda.synchronize()
        return out, count(tag)

    rng = np.random.default_rng(SEED + 9)
    n = SORT_N
    # BASELINE config 2: 16M u64 keys, u32 values = the row index
    h64 = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    want_keys, want_vals = np.sort(h64), np.argsort(h64, kind="stable")
    d64 = interop.to_torch(h64, dev)
    idx32 = torch.arange(n, dtype=torch.int32, device=dev)
    idx = idx32.view(torch.uint32)
    # the library sorts the keys' signed view with the sign bit flipped
    # (and gathers int32 values: CUDA torch does not index uint32 tensors)
    flipped = d64.view(torch.int64) ^ -(1 << 63)

    def lib_kv():
        order = torch.sort(flipped, stable=True).indices
        return flipped[order], idx32[order]
    lib_kv_ms = cuda_ms(lib_kv, 5)

    def check_kv(tag, out):
        k, v = (interop.to_numpy(t) for t in out)
        check(f"{tag}: keys equal np.sort", np.array_equal(k, want_keys))
        check(f"{tag}: values equal the stable argsort",
              np.array_equal(v.astype(np.int64), want_vals))

    for radix in (16, 256):
        tag = f"satradix KV {n} u64 + u32 radix {radix}"
        with phase(tag):
            s = sort_new("satradix", f"radix={radix}", elem_dtype="ulong")

            def kv(s=s):
                return s.sort_with_device_data(d64, idx)
            out, launches = drive(tag, kv)
            check_kv(tag, out)
            del out
            passes = 2 * len(sr.pass_shifts(radix))
            report(tag, kv, 3, sr.satradix_traffic_bytes(n, 2, True, radix),
                   launches, n, library_ms=lib_kv_ms, passes=passes,
                   pass_bound_ms=passes * 24 * n / PEAK_BYTES_S * 1e3)

    tag = f"xla KV {n} u64 + u32"
    with phase(tag):
        s = sort_new("xla", elem_dtype="ulong")

        def xla_kv():
            return s.sort_with_device_data(d64, idx)
        out, launches = drive(tag, xla_kv)
        check_kv(tag, out)
        del out
        report(tag, xla_kv, 3, 2 * 12 * n, launches, n)
    del d64, idx, idx32, flipped, h64, want_keys, want_vals

    h32 = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    d32 = interop.to_torch(h32, dev)
    limb = keymod.to_limbs(d32)[0]
    want32 = torch.sort(limb).values
    lib32_ms = cuda_ms(lambda: torch.sort(limb), 5)

    def check32(tag, out, want=want32):
        check(f"{tag}: equals torch.sort",
              torch.equal(keymod.to_limbs(out)[0], want))

    tag = f"satradix {n} u32"
    with phase(tag):
        s = sort_new("satradix")

        def radix32():
            return s.sort_with_device_data(d32)
        out, launches = drive(tag, radix32)
        check32(tag, out)
        report(tag, radix32, 5, sr.satradix_traffic_bytes(n, 1, False),
               launches, n, library_ms=lib32_ms,
               pass_bound_ms=8 * 8 * n / PEAK_BYTES_S * 1e3)

    tag = f"sbitonic {n} u32"
    with phase(tag):
        s = sort_new("sbitonic")

        def steps():
            return s.sort_with_device_data(d32)
        out, launches = drive(tag, steps)
        check32(tag, out)
        check(f"{tag}: {bk.sbitonic_steps(n)} pair_cross launches",
              launches["pair_cross"] == bk.sbitonic_steps(n))
        report(tag, steps, 3, bt.sbitonic_traffic_bytes(n, 1), launches, n,
               library_ms=lib32_ms)

    n1 = 1 << 20  # BASELINE config 1
    tag = f"abitonic single_launch=1 {n1} u32"
    with phase(tag):
        d1 = d32[:n1].clone()
        limb1 = keymod.to_limbs(d1)[0]
        s = sort_new("abitonic", "single_launch=1")
        fused = sort_new("abitonic").sort_with_device_data(d1)

        def single():
            return s.sort_with_device_data(d1)
        out, launches = drive(tag, single)
        check(f"{tag}: one whole_sort launch", launches["whole_sort"] == 1)
        check32(tag, out, torch.sort(limb1).values)
        check(f"{tag}: equals the fused schedule bit for bit",
              torch.equal(out.view(torch.int32), fused.view(torch.int32)))
        report(tag, single, 7, bt.abitonic_traffic_bytes(
                   n1, 1, {"single_launch": "1"}), launches, n1,
               library_ms=cuda_ms(lambda: torch.sort(limb1), 7),
               fused_ms=cuda_ms(lambda: sort_new("abitonic")
                                .sort_with_device_data(d1), 7))
        del d1, limb1, fused, out

    tag = f"abitonic autotune=1 {n} u32"
    with phase(tag):
        cache_dir = tempfile.mkdtemp()
        saved = os.environ.get(autotune.CACHE_ENV)
        os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir, "tune.json")
        autotune._mem_cache.clear()
        s = sort_new("abitonic", "autotune=1")
        t = time.perf_counter()
        out, launches = drive(tag, lambda: s.sort_with_device_data(d32))
        sweep_s = time.perf_counter() - t
        check32(tag, out)
        geo = autotune.tune_geometry(n, 1, dev)
        report(tag, lambda: s.sort_with_device_data(d32), 5,
               bt.abitonic_traffic_bytes(n, 1, {
                   "block_elems": geo[0], "merge_elems": geo[1],
                   "single_launch": str(int(geo[2]))}), launches, n,
               geometry=geo, candidates=len(autotune.candidate_geometries(
                   n, 1)), sweep_s=sweep_s, library_ms=lib32_ms)
        if saved is None:
            del os.environ[autotune.CACHE_ENV]
        else:
            os.environ[autotune.CACHE_ENV] = saved
        shutil.rmtree(cache_dir)
    del d32, limb, want32, out

    ng = 1 << 16  # a selection sort: O(n^2) compares
    tag = f"gselect {ng} u32 + u32"
    with phase(tag):
        hg = h32[:ng]
        dg = interop.to_torch(hg, dev)
        vg = torch.arange(ng, dtype=torch.int32, device=dev)
        s = sort_new("gselect")

        def gsel():
            return s.sort_with_device_data(dg, vg)
        out, launches = drive(tag, gsel)
        k, v = (interop.to_numpy(t) for t in out)
        check(f"{tag}: keys equal np.sort", np.array_equal(k, np.sort(hg)))
        check(f"{tag}: values equal the stable argsort",
              np.array_equal(v, np.argsort(hg, kind="stable")))
        report(tag, gsel, 3, 2 * 8 * ng, launches, ng, compares=ng * ng)


def radix_run_table(n, block, radix):
    """radix_dma_probe.py's phase 2: n int32 keys from RandomState(0), cut
    into blocks of `block` keys; each (block, digit) pair of the low digit
    is one run, in digit-major order, with chunk-aligned destinations.
    Returns (keys, run starts, destinations, lengths, n_chunks) as numpy."""
    import numpy as np
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
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


def query_kernel_records(dev):
    """dense_agg over DENSE_N rows at each of DENSE_GROUPS (masked; an
    int32 sum, a flipped u32 min and max, float32 limbs' min and max), and
    chunk_copy on radix_dma_probe's run table, each against its plain
    version bit for bit. Yardsticks: one index_add_ of one int32 column
    into the groups; for chunk_copy, which no library call computes, the
    clone() of its source for scale."""
    import torch
    from cl_ops_tpu_torch.ops.exec import dense_agg as da
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
    from cl_ops_tpu_torch.ops.sort import keys as keymod
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n = DENSE_N
    recs = {}

    def randint(lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev,
                             generator=gen)
    mask = torch.rand(n, device=dev, generator=gen) < 0.98
    i32, u32 = randint(-2 ** 31, 2 ** 31 - 1), randint(-2 ** 31, 2 ** 31 - 1)
    f32 = keymod.to_limbs(torch.randn(n, device=dev, generator=gen))[0]
    reds = ((None, "count", False), (i32, "sum", False), (u32, "min", True),
            (u32, "max", True), (f32, "min", False), (f32, "max", False))
    for g in DENSE_GROUPS:
        gid = randint(0, g)

        def kern(gid=gid, g=g):
            return da.dense_agg(gid, mask, reds, g)

        def plain(gid=gid, g=g):
            return da.dense_agg_plain(gid, mask, reds, g)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err((got,), (want,))
        if err:
            raise AssertionError(f"dense_agg G={g}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        table = torch.zeros(g, dtype=torch.int32, device=dev)
        recs[f"dense_agg {g}"] = kernel_record(
            "dense_agg", "cl_ops_tpu_torch/csrc/dense_agg.cu", err,
            kernel_ms("dense_agg", kern, 7), cuda_ms(plain, 3),
            dense_read_bytes(n, 3, True),
            n * len(reds),
            cuda_ms(lambda gid=gid, t=table: t.index_add_(0, gid, i32), 7),
            f"n={n} groups={g} masked; count, int32 sum, u32 min and max, "
            f"float32 min and max")
        del gid
    del mask, i32, u32, f32

    keys, starts, qstarts, lengths, n_chunks = radix_run_table(
        DMA_N, DMA_BLOCK, DMA_RADIX)
    src = torch.from_numpy(keys).to(dev)
    params = ds.plan_run_chunks(
        *(torch.from_numpy(a).to(dev) for a in (starts, qstarts, lengths)),
        n_chunks_static=n_chunks)

    def copy():
        return ds.chunk_copy((src,), params, n_chunks=n_chunks)

    def copy_plain():
        return ds.chunk_copy_plain((src,), params, n_chunks)
    got, want = copy(), copy_plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"chunk_copy: kernel differs from its plain "
                             f"version (max abs err {err})")
    recs["chunk_copy"] = kernel_record(
        "chunk_copy", "cl_ops_tpu_torch/csrc/chunk_copy.cu", err,
        kernel_ms("chunk_copy", copy, 7), cuda_ms(copy_plain, 3),
        chunk_copy_bytes(params, 1), 0, None,
        f"n={DMA_N} block={DMA_BLOCK} radix={DMA_RADIX} runs={len(lengths)} "
        f"chunks={n_chunks}", clone_ms=cuda_ms(src.clone, 7))
    return recs


def query_cells(dev, reset, count):
    """The dense GROUP BY, window, top-k, DISTINCT and run-copy cells: each
    driven once between reset() and count(), checked against numpy, timed
    with CUDA events and traced once."""
    import numpy as np
    import torch

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.ops.exec import (distinct,
                                           group_aggregate_dense_cols, psort,
                                           top_k, topk, window_cols)
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds

    def check(name, ok):
        if not ok:
            raise AssertionError(name)

    def drive(tag, fn):
        reset()
        out = fn()
        torch.cuda.synchronize()
        return out, count(tag)

    # TPC-H Q1 over lineitem at about SF 10: the four (returnflag,
    # linestatus) pairs of Q1's answer in its proportions, gid = flag * 2 +
    # status in 6 slots, shipdate <= cutoff keeping about 98%
    n = Q1D_N
    tag = f"dense q1 {n}, 6 slots, 4 groups"
    with phase(tag):
        rng = np.random.default_rng(SEED + 11)
        pair = rng.choice(4, n, p=[0.25, 0.0065, 0.4935, 0.25])
        gid = np.array([0, 2, 3, 4], np.int32)[pair]  # AF, NF, NO, RF
        ship = rng.integers(0, 2557, n).astype(np.int32)
        cutoff = 2505
        qty = rng.integers(1, 51, n).astype(np.int32)
        disc = rng.integers(0, 11, n).astype(np.int32)
        price = (qty * rng.integers(90_000, 210_000, n)).astype(np.int32)
        d = [interop.to_torch(a, dev) for a in (gid, ship, qty, disc, price)]
        aggs = ("sum", "mean", "sum", "mean", "min", "max", "count")

        def q1():
            return group_aggregate_dense_cols(
                d[0], (d[2], d[2], d[3], d[3], d[4], d[4], d[2]), aggs,
                num_groups=6, valid_mask=d[1] <= cutoff)
        (gk, tabs, cnt), launches = drive(tag, q1)
        keep = ship <= cutoff
        present = [g for g in range(6) if (keep & (gid == g)).any()]
        check("dense q1 count", int(cnt) == len(present) == 4)
        check("dense q1 keys", interop.to_numpy(gk)[:4].tolist() == present)
        tabs = [interop.to_numpy(t)[:4] for t in tabs]
        for i, g in enumerate(present):
            m = keep & (gid == g)
            c = int(m.sum())
            sq, sd = int(qty[m].sum()), int(disc[m].sum())
            want = (sq, np.float32(sq) / np.float32(c), sd,
                    np.float32(sd) / np.float32(c), price[m].min(),
                    price[m].max(), c)
            for name, got_t, w in zip(aggs, tabs, want):
                check(f"dense q1 group {g} {name}", got_t[i] == w)
        del gk, tabs
        report(tag, q1, 5, n * sum(DENSE_Q1_BYTES_PER_ROW.values()),
               launches, n, kept=int(keep.sum()))
        del d, gid, ship, qty, disc, price, keep

    n, g = DENSE_BIG_N, 1024
    tag = f"dense {n} x {g} groups"
    with phase(tag):
        rng = np.random.default_rng(SEED + 12)
        gid = rng.integers(0, g, n).astype(np.int32)
        val = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        dg, dv = interop.to_torch(gid, dev), interop.to_torch(val, dev)

        def big():
            return group_aggregate_dense_cols(
                dg, (dv, dv, dv, dv), ("sum", "min", "max", "count"),
                num_groups=g)
        (gk, (s, mn, mx, c), cnt), launches = drive(tag, big)
        # sums mod 2^32 from exact float64 sums of the 16-bit halves; min
        # and max from one sort of (group, value)
        lo = np.bincount(gid, weights=val & 0xFFFF, minlength=g)
        hi = np.bincount(gid, weights=val >> 16, minlength=g)
        sums = ((lo.astype(np.int64) + (hi.astype(np.int64) << 16))
                & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        sk = np.sort((gid.astype(np.int64) << 32) | (val.astype(np.int64)
                                                     + 2 ** 31))
        first = np.searchsorted(sk >> 32, np.arange(g))
        last = np.searchsorted(sk >> 32, np.arange(g), side="right") - 1
        check("dense 1024 count", int(cnt) == g)
        check("dense 1024 keys", np.array_equal(interop.to_numpy(gk),
                                                np.arange(g)))
        check("dense 1024 sums", np.array_equal(interop.to_numpy(s), sums))
        check("dense 1024 min", np.array_equal(
            interop.to_numpy(mn), (sk[first] & 0xFFFFFFFF) - 2 ** 31))
        check("dense 1024 max", np.array_equal(
            interop.to_numpy(mx), (sk[last] & 0xFFFFFFFF) - 2 ** 31))
        check("dense 1024 counts", np.array_equal(interop.to_numpy(c),
                                                  np.bincount(gid)))
        del gk, s, mn, mx, c, sk, lo, hi
        report(tag, big, 5, dense_read_bytes(n, 1, False), launches, n)
        del dg, dv, gid, val

    # bench_all.py config 9: sum + row_number over 16M rows, 64K
    # partitions, the restore form and sorted_output
    n, g = WINDOW_N, WINDOW_G
    with phase(f"window {n} x {g}"):
        wk = np.random.RandomState(9).randint(0, g, size=n).astype(np.uint32)
        wo = np.random.RandomState(10).randint(0, 1 << 30, size=n) \
            .astype(np.uint32)
        wv = np.random.RandomState(11).randint(0, 100, size=n) \
            .astype(np.int32)
        dk, do, dv = (interop.to_torch(a, dev) for a in (wk, wo, wv))
        idx = np.lexsort((np.arange(n), wo, wk))  # the window order
        sk = wk[idx]
        start = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        run_len = np.diff(np.r_[start, n])
        row_start = np.repeat(start, run_len)
        csum = np.cumsum(wv[idx], dtype=np.int64)
        run_sum = csum - np.repeat(np.r_[0, csum[start[1:] - 1]], run_len)
        row_num = np.arange(n) - row_start + 1
        sorted_bytes = psort.sort_traffic_bytes(n, 4) + WINDOW_SCAN_BYTES * n
        for form, kw, model in (
                ("restore", {}, sorted_bytes
                 + psort.sort_traffic_bytes(n, 3)),
                ("sorted_output", {"sorted_output": True}, sorted_bytes)):
            tag = f"window {n} x {g} sum + row_number, {form}"

            def win(kw=kw):
                return window_cols(dk, do, (dv, None), ("sum", "row_number"),
                                   **kw)
            out, launches = drive(tag, win)
            if form == "restore":
                got_s, got_r = (interop.to_numpy(t) for t in out)
                check(f"{tag}: sums", np.array_equal(got_s[idx], run_sum))
                check(f"{tag}: row numbers",
                      np.array_equal(got_r[idx], row_num))
            else:
                (got_s, got_r), src = out
                check(f"{tag}: row_src", np.array_equal(
                    interop.to_numpy(src), idx))
                check(f"{tag}: sums", np.array_equal(
                    interop.to_numpy(got_s), run_sum))
                check(f"{tag}: row numbers", np.array_equal(
                    interop.to_numpy(got_r), row_num))
            del out, got_s, got_r
            report(tag, win, 3, model, launches, n, partitions=len(start))
        del dk, do, dv, idx, csum, run_sum, row_start, row_num

    # bench_all.py config 10: top-1K of 64M u32 with an int32 payload; and
    # a duplicate flood that takes the exact branch
    n, k = TOPK_N, TOPK_K
    tag = f"topk {k} of {n} u32 + int32"
    with phase(tag):
        tv = np.random.RandomState(12).randint(0, 1 << 30, size=n) \
            .astype(np.uint32)
        tp = np.random.RandomState(13).randint(0, 1 << 30, size=n) \
            .astype(np.int32)
        dtv, dtp = interop.to_torch(tv, dev), interop.to_torch(tp, dev)
        # numpy's stable order of the k smallest: every row up to the k-th
        # value, by (value, position)
        kth = np.partition(tv, k - 1)[k - 1]
        cand = np.flatnonzero(tv <= kth)
        want = cand[np.argsort(tv[cand], kind="stable")][:k]

        def tk():
            return top_k(dtv, k, dtp)
        (ov, op), launches = drive(tag, tk)
        branch = topk.last_branch
        check(f"{tag}: values", np.array_equal(interop.to_numpy(ov),
                                               tv[want]))
        check(f"{tag}: payload", np.array_equal(interop.to_numpy(op),
                                                tp[want]))
        report(tag, tk, 5, n * sum(TOPK_BYTES_PER_ROW.values()), launches,
               n, branch=branch)
        del dtv, dtp, tv, tp

    n, k = FLOOD_N, FLOOD_K
    tag = f"topk {k} of {n} u32, 90% ties at the minimum"
    with phase(tag):
        rng = np.random.RandomState(1)
        fv = np.zeros(n, np.uint32)
        fv[: n // 10] = rng.randint(1, 1 << 20, size=n // 10)
        rng.shuffle(fv)
        dfv = interop.to_torch(fv, dev)
        dpos = torch.arange(n, dtype=torch.int32, device=dev)

        def flood():
            return top_k(dfv, k, dpos)
        (ov, op), launches = drive(tag, flood)
        branch = topk.last_branch
        check(f"{tag}: exact branch", branch == "exact")
        want = np.flatnonzero(fv == 0)[:k]
        check(f"{tag}: values", np.array_equal(interop.to_numpy(ov),
                                               fv[want]))
        check(f"{tag}: payload", np.array_equal(interop.to_numpy(op), want))
        report(tag, flood, 3, psort.sort_traffic_bytes(n, 3)
               + n * sum(TOPK_BYTES_PER_ROW.values()), launches, n,
               branch=branch)
        del dfv, dpos, fv

    # bench_all.py config 11: DISTINCT over 64M u32 with 1M values
    n, u = DISTINCT_N, DISTINCT_U
    tag = f"distinct {n} u32, {u} values"
    with phase(tag):
        dk_h = np.random.RandomState(14).randint(0, u, size=n) \
            .astype(np.uint32)
        ddk = interop.to_torch(dk_h, dev)

        def dist():
            return distinct(ddk, capacity=u)
        (vals, cnt), launches = drive(tag, dist)
        uniq = np.unique(dk_h)
        c = int(cnt)
        check(f"{tag}: count", c == len(uniq))
        check(f"{tag}: values", np.array_equal(interop.to_numpy(vals)[:c],
                                               uniq))
        del vals
        report(tag, dist, 3, 2 * psort.sort_traffic_bytes(n, 1)
               + n * sum(DISTINCT_BYTES_PER_ROW.values()), launches, n,
               distinct=c)
        del ddk, dk_h, uniq

    # radix_dma_probe.py phase 2: the blocked writes of one radix-16 pass
    n = DMA_N
    tag = f"run copy {n} int32, radix {DMA_RADIX}, block {DMA_BLOCK}"
    with phase(tag):
        keys, starts, qstarts, lengths, n_chunks = radix_run_table(
            n, DMA_BLOCK, DMA_RADIX)
        src = interop.to_torch(keys, dev)
        runs = [interop.to_torch(a, dev) for a in (starts, qstarts, lengths)]

        def run_copy():
            params = ds.plan_run_chunks(*runs, n_chunks_static=n_chunks)
            return ds.chunk_copy((src,), params, n_chunks=n_chunks)
        (out,), launches = drive(tag, run_copy)
        out = interop.to_numpy(out)
        run = np.repeat(np.arange(len(lengths)), lengths)
        j = np.arange(n) - np.repeat(np.cumsum(lengths) - lengths, lengths)
        dst = qstarts[run] + j
        check(f"{tag}: runs land", np.array_equal(out[dst],
                                                  keys[starts[run] + j]))
        slack = np.ones(out.size, bool)
        slack[dst] = False
        check(f"{tag}: slack is the sentinel", bool((out[slack]
                                                     == ds._SENT).all()))
        params = ds.plan_run_chunks(*runs, n_chunks_static=n_chunks)
        report(tag, run_copy, 7, chunk_copy_bytes(params, 1), launches, n,
               runs=len(lengths), chunks=n_chunks,
               slack_share=float(slack.sum()) / out.size)
        del src, runs, out, params


def rng_cells(dev):
    """The seven generators: DEV_GID + knuth at rng_bench's default
    (262144 streams x 10 draws) on the card against the same call on CPU
    tensors, and HOST_MT states against numpy's; then 2^24 streams x 16
    draws (2^28 u32 values, BASELINE config 4's 256M generated keys),
    whose first 4096 streams equal a CPU run over 4096 streams (a DEV_GID
    stream depends only on its gid). Returns one record per generator."""
    import numpy as np
    import torch

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.ops.rng import generator_names, rng_new

    def same(tag, a, b):
        if not torch.equal(interop.signed_view(a).cpu(),
                           interop.signed_view(b)):
            raise AssertionError(f"rng {tag}: card differs from the CPU")

    recs = []
    for name in generator_names():
        kw = dict(main_seed=SEED, hash_name="knuth")
        card = rng_new(name, "dev_gid", RNG_STREAMS, device=dev, **kw)
        host = rng_new(name, "dev_gid", RNG_STREAMS, device="cpu", **kw)
        same(f"{name} seeds", card.states, host.states)
        same(f"{name} draws", card.generate(RNG_DRAWS),
             host.generate(RNG_DRAWS))
        same(f"{name} final states", card.states, host.states)
        mt = rng_new(name, "host_mt", RNG_STREAMS, main_seed=SEED,
                     device=dev)
        gen = mt._gen
        words = RNG_STREAMS * gen.seed_bytes // 4
        want = np.random.RandomState(SEED).randint(
            0, 2 ** 32, words, dtype=np.uint32).view(gen.state_dtype)
        if not np.array_equal(
                interop.to_numpy(mt.states, gen.state_dtype).reshape(-1),
                want):
            raise AssertionError(f"rng {name}: HOST_MT states differ from "
                                 "numpy's")

        big = rng_new(name, "dev_gid", RNG_BIG_STREAMS, device=dev, **kw)
        small = rng_new(name, "dev_gid", RNG_CHECK_STREAMS, device="cpu",
                        **kw)
        out = big.generate(RNG_BIG_DRAWS)
        same(f"{name} first {RNG_CHECK_STREAMS} streams of {RNG_BIG_STREAMS}",
             out[:, :RNG_CHECK_STREAMS].contiguous(),
             small.generate(RNG_BIG_DRAWS))
        del out
        ms = cuda_ms(lambda: big.generate(RNG_BIG_DRAWS), 3)
        values = RNG_BIG_STREAMS * RNG_BIG_DRAWS
        nbytes = 2 * RNG_BIG_STREAMS * gen.seed_bytes + 4 * values
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        rec = {"rng": name, "streams": RNG_BIG_STREAMS,
               "draws": RNG_BIG_DRAWS, "ms": ms,
               "mvalues_s": values / ms / 1e3, "model_bytes": nbytes,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms}
        print(json.dumps(rec))
        recs.append(rec)
        del big
    return recs


def profiling_cells(dev):
    """The stream ceiling measured (beside the nominal PEAK_BYTES_S, which
    every share in this script keeps dividing by), a trace of one 16M sort
    holding a named() label, and timed() filling its dict."""
    import tempfile

    import numpy as np
    import torch

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.bench import roofline
    from cl_ops_tpu_torch.ops.sort import sort_new
    from cl_ops_tpu_torch.utils import profiling

    with tempfile.TemporaryDirectory() as tmp:
        saved = {k: os.environ.pop(k, None)
                 for k in (roofline.GBS_ENV, roofline.CACHE_ENV)}
        os.environ[roofline.CACHE_ENV] = os.path.join(tmp, "roofline.json")
        roofline.stream_ceiling_gbs.cache_clear()
        ceiling = roofline.stream_ceiling_gbs()
        del os.environ[roofline.CACHE_ENV]
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
        nominal = PEAK_BYTES_S / 1e9
        print(json.dumps({"stream_ceiling_gb_s": ceiling,
                          "nominal_gb_s": nominal,
                          "ceiling_over_nominal": ceiling / nominal}))
        if not 0 < ceiling <= 1.05 * nominal:
            raise AssertionError(f"stream ceiling {ceiling} GB/s outside "
                                 f"(0, 1.05 x {nominal}]")

        keys = interop.to_torch(np.random.default_rng(SEED + 13).integers(
            0, 2 ** 32, SORT_N, dtype=np.uint32), dev)
        sorter = sort_new("abitonic")
        label = "chip_smoke abitonic 16M"
        with profiling.trace(tmp):
            with profiling.named(label):
                sorter.sort_with_device_data(keys)
            torch.cuda.synchronize()
        files = [f for f in os.listdir(tmp) if f.startswith("trace_")]
        if len(files) != 1:
            raise AssertionError(f"trace() wrote {files}")
        with open(os.path.join(tmp, files[0])) as f:
            events = json.load(f)["traceEvents"]
        if not any(e.get("name") == label for e in events):
            raise AssertionError("the named() label is not in the trace")
        kernels = sum(e.get("cat") == "kernel" for e in events)
        results = {}
        with profiling.timed("sort", results):
            sorter.sort_with_device_data(keys)
        if not results.get("sort", 0) > 0:
            raise AssertionError(f"timed() left {results}")
        print(json.dumps({"trace_events": len(events),
                          "trace_kernel_events": kernels,
                          "timed_sort_s": results["sort"]}))


def bench_cli_cells(reset, count):
    """The headline line and the reference-parity CLIs, each driven once
    between reset() and count(); every CLI must return 0 with every row's
    check "ok"."""
    import tempfile

    from cl_ops_tpu_torch.bench import (headline, rng_bench, scan_bench,
                                        sort_bench)

    with phase("headline"):
        reset()
        if headline.main([]) != 0:
            raise AssertionError("headline failed")
        count("headline")

    calls = [(sort_bench, "-a abitonic --minpo2 20 -n 24 -r 5"),
             (sort_bench, "-a satradix -t ulong --kv --minpo2 24 -n 24 -r 3"),
             (scan_bench, "-a blelloch --min-doub 20 -n 24"),
             (scan_bench, "-a lookback --min-doub 20 -n 24"),
             (rng_bench, "-g threefry --output none"),
             (rng_bench, "-g xorshift128 --output none")]
    with phase("bench CLIs"), tempfile.TemporaryDirectory() as tmp:
        for i, (mod, argv) in enumerate(calls):
            tag = f"{mod.__name__.rsplit('.', 1)[1]} {argv}"
            tsv = os.path.join(tmp, f"{i}.tsv")
            out = [] if mod is rng_bench else ["--out", tsv]
            reset()
            t = time.perf_counter()
            if mod.main(argv.split() + out) != 0:
                raise AssertionError(f"{tag} failed")
            print(f"{tag}: {time.perf_counter() - t:.3f} s")
            count(tag)
            if out:
                with open(tsv) as f:
                    rows = f.read().split("\n")[1:-1]
                if not rows or any(not r.endswith("\tok") for r in rows):
                    raise AssertionError(f"{tag}: checks {rows}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    import numpy as np

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.models import pipeline
    from cl_ops_tpu_torch.ops.exec import bandprobe as bp
    from cl_ops_tpu_torch.ops.exec import dense_agg as da
    from cl_ops_tpu_torch.ops.exec import (filter_compact,
                                           group_aggregate_cols,
                                           group_aggregate_sorted, psort)
    from cl_ops_tpu_torch.ops.rng import threefry
    from cl_ops_tpu_torch.ops.scan import kernels as sk
    from cl_ops_tpu_torch.ops.scan import segmented as seg
    from cl_ops_tpu_torch.ops.sort import bitonic as bt
    from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
    from cl_ops_tpu_torch.ops.sort import keys as keymod
    from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
    from cl_ops_tpu_torch.ops.sort import sort_new

    dev = torch.device("cuda")
    kernel_mods = (bk, sk, seg, bp, rk, da, ds)  # those with launch counters
    built = (bk, sk, bp, rk, da, ds)  # one per CUDA source
    rng = np.random.default_rng(SEED)

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print("nvidia-smi:", smi)
        print("torch", torch.__version__, "cuda", torch.version.cuda,
              "device", torch.cuda.get_device_name(0))
        t = time.perf_counter()
        with ThreadPoolExecutor(len(built)) as pool:  # one nvcc per source
            for f in [pool.submit(m.load_kernels) for m in built]:
                f.result()
        print(f"kernel build+load: {time.perf_counter() - t:.3f} s")
        for line in "".join(m.build_log for m in built).splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                print("ptxas:", line.strip())
        for inst, usage in block_sort_ptxas(bk.build_log).items():
            print(f"block_sort/multi_stage {inst}: {usage}")

    # -- each kernel against its plain version, at the main-path shapes -------
    def kernel_table(cols, num_keys, library):
        """Run the four kernels in schedule order from `cols`; each one's
        input is the previous one's output. Returns per-kernel records."""
        n, nc = cols[0].numel(), len(cols)
        b, m = bt.resolve_geometry(n, nc)
        assert n > m > b, (n, m, b)
        steps = {"block_sort": (b.bit_length() - 1) * b.bit_length() // 2,
                 "multi_stage": sum(s for s in range(b.bit_length(),
                                                     m.bit_length())),
                 "pair_cross": 1, "block_merge": m.bit_length() - 1}
        calls = {
            "block_sort": (bk.block_sort_, bk.block_sort_plain, (b,)),
            "multi_stage": (bk.multi_stage_, bk.multi_stage_plain, (b, m)),
            "pair_cross": (bk.pair_cross_, bk.pair_cross_plain, (2 * m, m)),
            "block_merge": (bk.block_merge_, bk.block_merge_plain,
                            (m, 2 * m)),
        }
        recs = []
        state = [c.clone() for c in cols]
        for name in bk.FUSED:
            kern, plain, args = calls[name]
            rec, state = bitonic_record(
                name, kern, plain, args, state, num_keys, steps[name],
                library.get(name), f"n={n} cols={nc} num_keys={num_keys} "
                                   f"block={b} merge={m}")
            recs.append(rec)  # the next kernel's input: its plain output
        return recs

    with phase("kernels vs plain"):
        keys32 = interop.to_torch(
            rng.integers(0, 2 ** 32, SORT_N, dtype=np.uint32), dev)
        limb32 = keymod.to_limbs(keys32)
        b1, m1 = bt.resolve_geometry(SORT_N, 1)
        x = limb32[0]
        u32_recs = kernel_table(limb32, 1, {
            "block_sort": lambda: torch.sort(x.view(-1, b1), dim=1),
            "multi_stage": lambda: torch.sort(x.view(-1, m1), dim=1),
            # sorts each M-block: block_merge's output at k = 0 on its
            # bitonic input
            "block_merge": lambda: torch.sort(x.view(-1, m1), dim=1)})
        keys64 = interop.to_torch(
            rng.integers(0, 2 ** 64, SORT_N, dtype=np.uint64), dev)
        vals32 = interop.to_torch(
            rng.integers(0, 2 ** 32, SORT_N, dtype=np.uint32), dev)
        kv_recs = kernel_table(
            keymod.to_limbs(keys64) + [vals32.view(torch.int32)], 2, {})
        gb_rec = groupby_multi_stage_record(dev)
        for r in u32_recs + kv_recs + [gb_rec]:
            print("kernel", json.dumps(r))

    with phase("scan kernels vs plain"):
        scan_recs = {}
        for n in (GROUPBY_N, SCAN_N):
            xi = interop.to_torch(rng.integers(-2 ** 31, 2 ** 31, n,
                                               dtype=np.int32), dev)
            scan_recs[f"scan_carry {n}"] = scan_record(
                "scan_carry", n, lambda: sk.scan_carry(xi),
                lambda: sk.scan_carry_plain(xi, False),
                lambda: torch.cumsum(xi, 0, dtype=torch.int32), 8 * n,
                f"n={n} int32 inclusive")
            del xi
        x64 = interop.to_torch(rng.integers(-2 ** 63, 2 ** 63, SCAN_N,
                                            dtype=np.int64), dev)
        scan_recs["scan_carry_wide"] = scan_record(
            "scan_carry_wide", SCAN_N, lambda: sk.scan_carry(x64),
            lambda: sk.scan_carry_plain(x64, False),
            lambda: torch.cumsum(x64, 0), 16 * SCAN_N,
            f"n={SCAN_N} int64 inclusive")
        del x64
        # segment density of q1: about 64K runs in 16M rows
        flags = interop.to_torch(
            (rng.random(SCAN_N) < 1 / 256).astype(np.int32), dev)
        vals = {"int32": interop.to_torch(rng.integers(
                    -2 ** 31, 2 ** 31, SCAN_N, dtype=np.int32), dev),
                "float32": interop.to_torch(rng.uniform(
                    -1, 1, SCAN_N).astype(np.float32), dev)}

        def f32_sum_tol(got, want, v=vals["float32"]):
            # float32 sums in two orders: 1e-5 (about 84 ulps) of the
            # running sum of |x| in the segment, plus 1e-6 near zero
            return 1e-5 * seg.seg_scan_carry_plain(v.abs(), flags, "add",
                                                   False) + 1e-6
        for dt, v in vals.items():
            for op in seg.OPS:
                scan_recs[f"seg_scan_carry {op} {dt}"] = scan_record(
                    "seg_scan_carry", SCAN_N,
                    lambda v=v, op=op: seg.seg_scan_carry(v, flags, op),
                    lambda v=v, op=op: seg.seg_scan_carry_plain(
                        v, flags, op, False), None, 12 * SCAN_N,
                    f"n={SCAN_N} {dt} {op} runs~{SCAN_N // 256}",
                    f32_sum_tol if (dt, op) == ("float32", "add") else None)
        # for scale only: torch.cummax is an unsegmented running max
        xi = vals["int32"]
        scan_recs["seg_scan_carry max int32"]["cummax_ms"] = cuda_ms(
            lambda: torch.cummax(xi, 0), 7)
        # the look-back's extremes: no flag (every tile walks back to a
        # PREFIX) and every row flagged (every tile publishes at once)
        for tag, fl in (("no flags", torch.zeros_like(flags)),
                        ("every row flagged", torch.ones_like(flags))):
            scan_recs[f"seg_scan_carry max int32 {tag}"] = scan_record(
                "seg_scan_carry", SCAN_N,
                lambda fl=fl: seg.seg_scan_carry(xi, fl, "max"),
                lambda fl=fl: seg.seg_scan_carry_plain(xi, fl, "max", False),
                None, 12 * SCAN_N, f"n={SCAN_N} int32 max, {tag}")
        del vals, flags, xi
        scan_recs.update(block_scan_records(dev, BLOCK_SCAN_N))
        for r in scan_recs.values():
            print("kernel", json.dumps(r))

    with phase("band probe kernel vs plain"):
        band_recs = band_kernel_records(dev)
        for r in band_recs.values():
            print("kernel", json.dumps(r))

    with phase("sort family kernels vs plain"):
        family_recs = sort_family_kernel_records(dev)
        for r in family_recs.values():
            print("kernel", json.dumps(r))

    with phase("dense_agg and chunk_copy kernels vs plain"):
        query_recs = query_kernel_records(dev)
        for r in query_recs.values():
            print("kernel", json.dumps(r))

    all_kernels = sum((m.KERNELS for m in kernel_mods), ())
    counters = tuple(m.launches for m in kernel_mods)
    main_launches = dict.fromkeys(all_kernels, 0)

    def reset():
        for m in kernel_mods:
            m.reset_launches()

    def count(name):
        now = {k: v for c in counters for k, v in c.items()}
        for k in all_kernels:
            main_launches[k] += now[k]
        print(f"launches in {name}:", json.dumps(now))
        return now

    sorter = sort_new("abitonic")
    with phase("sort 16M u32"):
        reset()
        out = sorter.sort_with_device_data(keys32)
        torch.cuda.synchronize()
        count("sort")
        limbs_in = x.clone()
        ref, _ = torch.sort(limbs_in)
        got = keymod.to_limbs(out)[0]
        if not torch.equal(got, ref):
            raise AssertionError("abitonic sort differs from torch.sort")
        sort_ms = cuda_ms(lambda: sorter.sort_with_device_data(keys32), 5)
        lib_sort_ms = cuda_ms(lambda: torch.sort(limbs_in), 5)
        traffic = bt.abitonic_traffic_bytes(SORT_N, 1)
        print(json.dumps({
            "sort": "abitonic", "n": SORT_N, "ms": sort_ms,
            "mkeys_s": SORT_N / sort_ms / 1e3,
            "gb_s_model": traffic / sort_ms / 1e6, "model_bytes": traffic,
            "bound_ms": traffic / PEAK_BYTES_S * 1e3,
            "library_ms": lib_sort_ms,
            "library_mkeys_s": SORT_N / lib_sort_ms / 1e3}))

    with phase("kv sort 16M u64 + u32"):
        kv_sorter = sort_new("abitonic", elem_dtype="ulong")
        host_keys = interop.to_numpy(keys64)
        idx = torch.arange(SORT_N, dtype=torch.int32, device=dev).view(
            torch.uint32)
        reset()
        ok_keys, ok_vals = kv_sorter.sort_with_device_data(keys64, idx)
        torch.cuda.synchronize()
        count("kv sort")
        hk = interop.to_numpy(ok_keys)
        hv = interop.to_numpy(ok_vals).astype(np.int64)
        if not np.array_equal(hk, np.sort(host_keys)):
            raise AssertionError("KV sort keys differ from np.sort")
        if not (np.array_equal(np.sort(hv), np.arange(SORT_N))
                and np.array_equal(host_keys[hv], hk)):
            raise AssertionError("KV sort lost or mismatched (key, value) "
                                 "pairs")
        kv_ms = cuda_ms(
            lambda: kv_sorter.sort_with_device_data(keys64, vals32), 3)
        kv_bytes = bt.abitonic_traffic_bytes(SORT_N, 3)
        print(json.dumps({"kv_sort": "abitonic u64+u32", "n": SORT_N,
                          "ms": kv_ms, "mkeys_s": SORT_N / kv_ms / 1e3,
                          "model_bytes": kv_bytes,
                          "bound_ms": kv_bytes / PEAK_BYTES_S * 1e3}))

    with phase("sort_pipeline 16M"):
        reset()
        sp_keys, ok = pipeline.sort_pipeline(SORT_N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        count("sort_pipeline")
        if not bool(ok):
            raise AssertionError("sort_pipeline: output not sorted")
        gk, _ = pipeline.generate_table(SORT_N, SEED, device="cuda")
        ck, _ = pipeline.generate_table(1 << 16, SEED, device="cpu")
        if not torch.equal(gk[:1 << 16].cpu().view(torch.int32),
                           ck.view(torch.int32)):
            raise AssertionError("threefry on the card differs from the CPU")
        if not torch.equal(keymod.to_limbs(sp_keys)[0],
                           torch.sort(keymod.to_limbs(gk)[0])[0]):
            raise AssertionError("sort_pipeline keys differ from torch.sort")

    with phase("filter 64M u32 + u32 at 10%"):
        h_data = rng.integers(0, 2 ** 32, FILTER_N, dtype=np.uint32)
        h_pay = rng.integers(0, 2 ** 32, FILTER_N, dtype=np.uint32)
        d_data = interop.to_torch(h_data, dev)
        d_pay = interop.to_torch(h_pay, dev)

        def pred(v):
            return interop.widen_u32(v) < FILTER_THRESHOLD
        reset()
        cnt, f_data, f_pay = filter_compact(d_data, pred, d_pay)
        torch.cuda.synchronize()
        count("filter")
        mask = h_data < FILTER_THRESHOLD
        c = int(cnt)
        if c != int(mask.sum()):
            raise AssertionError(f"filter count {c} != {int(mask.sum())}")
        if not (np.array_equal(interop.to_numpy(f_data)[:c], h_data[mask])
                and np.array_equal(interop.to_numpy(f_pay)[:c],
                                   h_pay[mask])):
            raise AssertionError("filter rows differ from data[mask]")
        filt_ms = cuda_ms(lambda: filter_compact(d_data, pred, d_pay), 3)
        # the sort of (rank, data, payload) inside; the mask and the
        # encodings are elementwise passes outside the model
        f_bytes = psort.sort_traffic_bytes(FILTER_N, 3)
        print(json.dumps({"filter": "64M u32 + u32 payload", "n": FILTER_N,
                          "selectivity": c / FILTER_N, "ms": filt_ms,
                          "mrows_s": FILTER_N / filt_ms / 1e3,
                          "sort_model_bytes": f_bytes,
                          "bound_ms": f_bytes / PEAK_BYTES_S * 1e3}))

        del d_data, d_pay, f_data, f_pay

    def check(name, ok):
        if not ok:
            raise AssertionError(name)

    with phase("group by 256M x 1M"):
        h_keys = np.random.RandomState(4).randint(
            0, GROUPBY_G, GROUPBY_N).astype(np.uint32)
        h_vals = np.random.RandomState(5).randint(
            0, 100, GROUPBY_N).astype(np.int32)
        d_keys = interop.to_torch(h_keys, dev)
        d_vals = interop.to_torch(h_vals, dev)

        def groupby():
            return group_aggregate_sorted(d_keys, d_vals,
                                          num_groups=GROUPBY_G, agg="sum")
        reset()
        gk, tbl, cnt = groupby()
        torch.cuda.synchronize()
        gb_launches = count("group by")
        check("group by runs scan_carry", gb_launches["scan_carry"] > 0)
        present = np.nonzero(np.bincount(h_keys, minlength=GROUPBY_G))[0]
        sums = np.bincount(h_keys, weights=h_vals,
                           minlength=GROUPBY_G)[present]  # exact: < 2^53
        c = int(cnt)
        check("group by count", c == len(present))
        check("group by keys", np.array_equal(
            interop.to_numpy(gk)[:c], present))
        check("group by sums", np.array_equal(
            interop.to_numpy(tbl)[:c].astype(np.float64), sums))
        check("group by padding", (interop.to_numpy(tbl)[c:] == 0).all())
        del gk, tbl, h_keys, h_vals
        gb_ms = cuda_ms(groupby, 3)
        device_breakdown("group by 256M x 1M", groupby)
        sort_bytes = psort.sort_traffic_bytes(GROUPBY_N, 2)
        glue = {k: v * GROUPBY_N for k, v in GROUPBY_BYTES_PER_ROW.items()}
        gb_bytes = sort_bytes + sum(glue.values())
        print(json.dumps({
            "groupby": "256M u32 keys x int32 values, 1M groups, sum",
            "n": GROUPBY_N, "groups": c, "ms": gb_ms,
            "mrows_s": GROUPBY_N / gb_ms / 1e3,
            "sort_model_bytes": sort_bytes, "boundary_bytes": glue,
            "model_bytes": gb_bytes,
            "bound_ms": gb_bytes / PEAK_BYTES_S * 1e3,
            "launches": gb_launches}))
        del d_keys, d_vals

    with phase("analytics_query 64M, 10%, 1M groups"):
        def analytics():
            return pipeline.analytics_query(
                ANALYTICS_N, num_groups=GROUPBY_G, seed=SEED, threshold=102,
                device="cuda")
        reset()
        a_cnt, a_table = analytics()
        torch.cuda.synchronize()
        a_launches = count("analytics_query")
        check("analytics runs scan_carry", a_launches["scan_carry"] > 0)
        hk, hv = (interop.to_numpy(t) for t in
                  pipeline.generate_table(ANALYTICS_N, SEED, device="cuda"))
        m = hv < 102
        check("analytics count", int(a_cnt) == int(m.sum()))
        want = np.bincount(hk[m] % GROUPBY_G, weights=hv[m],
                           minlength=GROUPBY_G)
        check("analytics table", np.array_equal(
            interop.to_numpy(a_table).astype(np.float64), want))
        kept = int(m.sum())
        del hk, hv, m, a_table
        a_ms = cuda_ms(analytics, 3)
        device_breakdown("analytics_query 64M", analytics)
        # filter sort (rank, value, key), prefix sort (packed key, value),
        # the dense group ends' one-column sort, and the value scan
        a_bytes = (psort.sort_traffic_bytes(ANALYTICS_N, 3)
                   + psort.sort_traffic_bytes(ANALYTICS_N, 2)
                   + psort.sort_traffic_bytes(ANALYTICS_N, 1)
                   + sk.scan_traffic_bytes(ANALYTICS_N, torch.uint32))
        print(json.dumps({
            "analytics_query": "64M rows, value < 102 of 1024, 1M groups",
            "n": ANALYTICS_N, "kept": kept, "ms": a_ms,
            "mrows_s": ANALYTICS_N / a_ms / 1e3, "model_bytes": a_bytes,
            "bound_ms": a_bytes / PEAK_BYTES_S * 1e3,
            "launches": a_launches}))

    with phase("q1 16M x 64K"):
        def q1():
            return pipeline.q1_query(Q1_N, num_groups=Q1_G, seed=SEED,
                                     device="cuda")
        reset()
        q_cnt, q_gk, q_tabs, q_gcnt = q1()
        torch.cuda.synchronize()
        q_launches = count("q1")
        check("q1 runs scan_carry", q_launches["scan_carry"] > 0)
        ids = torch.arange(Q1_N, dtype=torch.int32, device=dev)
        keys, qty, price = (
            (interop.widen_u32(threefry.random_bits(SEED, ids, c)) % mod)
            .cpu().numpy() for c, mod in ((0, Q1_G), (1, 1024), (2, 10000)))
        m = qty < 768
        k, q, p = keys[m], qty[m], price[m]
        uniq = np.unique(k)
        g = len(uniq)
        cnt = np.bincount(k, minlength=Q1_G)[uniq]
        mn = np.full(Q1_G, 2 ** 31 - 1, np.int64)
        mx = np.full(Q1_G, -2 ** 31, np.int64)
        np.minimum.at(mn, k, q)
        np.maximum.at(mx, k, p)
        sq = np.bincount(k, weights=q, minlength=Q1_G)[uniq]
        sp = np.bincount(k, weights=p, minlength=Q1_G)[uniq]
        tabs = [interop.to_numpy(t)[:g] for t in q_tabs]
        check("q1 counts", int(q_cnt) == int(m.sum()) and int(q_gcnt) == g)
        check("q1 keys", np.array_equal(interop.to_numpy(q_gk)[:g], uniq))
        for name, got, want in (("sum qty", tabs[0], sq),
                                ("sum price", tabs[1], sp),
                                ("min qty", tabs[2], mn[uniq]),
                                ("max price", tabs[3], mx[uniq]),
                                ("count", tabs[4], cnt)):
            check(f"q1 {name}", np.array_equal(got, want))
        mean32 = sp.astype(np.float32) / cnt.astype(np.float32)
        check("q1 mean", np.array_equal(tabs[5], mean32) and bool(
            (np.abs(tabs[5] - sp / cnt) <= 2 ** -23 * sp / cnt).all()))
        del keys, qty, price, ids, q_gk, q_tabs
        q_ms = cuda_ms(q1, 3)
        device_breakdown("q1 16M x 64K", q1)
        # the (packed key, qty, price) sort, five scans, two segmented scans
        q_bytes = (psort.sort_traffic_bytes(Q1_N, 3)
                   + 5 * sk.scan_traffic_bytes(Q1_N, torch.int32)
                   + 2 * 12 * Q1_N)
        print(json.dumps({
            "q1": "16M rows, qty < 768 of 1024, 64K groups, 6 aggregates",
            "n": Q1_N, "groups": g, "ms": q_ms,
            "mrows_s": Q1_N / q_ms / 1e3, "model_bytes": q_bytes,
            "bound_ms": q_bytes / PEAK_BYTES_S * 1e3,
            "launches": q_launches}))

    with phase("group by 16M int64 measures"):
        r64 = np.random.default_rng(SEED + 5)
        hk = r64.integers(0, Q1_G, SCAN_N).astype(np.int32)
        hv = r64.integers(-2 ** 63, 2 ** 63, SCAN_N, dtype=np.int64)
        dk, dv = interop.to_torch(hk, dev), interop.to_torch(hv, dev)

        def wide():
            return group_aggregate_cols(dk, (dv, dv), ("sum", "count"),
                                        num_groups=Q1_G)
        reset()
        w_gk, (w_sum, w_cnt), w_g = wide()
        torch.cuda.synchronize()
        w_launches = count("int64 measures")
        check("int64 measures run scan_carry_wide",
              w_launches["scan_carry_wide"] > 0)
        uniq = np.unique(hk)
        g = len(uniq)
        sums = np.zeros(Q1_G, np.int64)
        np.add.at(sums, hk, hv)  # wraps mod 2^64, as the port's sums
        check("int64 count", int(w_g) == g)
        check("int64 keys", np.array_equal(interop.to_numpy(w_gk)[:g], uniq))
        check("int64 sums", np.array_equal(interop.to_numpy(w_sum)[:g],
                                           sums[uniq]))
        check("int64 counts", np.array_equal(
            interop.to_numpy(w_cnt)[:g], np.bincount(hk)[uniq]))
        w_ms = cuda_ms(wide, 3)
        device_breakdown("group by 16M int64 measures", wide)
        print(json.dumps({"int64_measures": "16M rows, 64K groups, sum+count",
                          "n": SCAN_N, "groups": g, "ms": w_ms,
                          "launches": w_launches}))

    join_cells(dev, reset, count)
    sort_family_cells(dev, reset, count)
    query_cells(dev, reset, count)
    with phase("rng generators"):
        rng_cells(dev)
    with phase("profiling and roofline"):
        profiling_cells(dev)
    bench_cli_cells(reset, count)

    for name, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    summary = u32_recs + [scan_recs[f"scan_carry {GROUPBY_N}"],
                          scan_recs["scan_carry_wide"],
                          scan_recs["seg_scan_carry max int32"],
                          scan_recs["scan_block uint32"],
                          scan_recs["scan_block_wide"],
                          band_recs[f"{JOIN_BIG[0]}x{JOIN_BIG[1]}"],
                          family_recs["whole_sort 1048576"],
                          family_recs["rank_hist 16"],
                          family_recs["rank_hist_limb 16 28"],
                          query_recs["dense_agg 4"],
                          query_recs["chunk_copy"]]
    u32_recs[2]["ms_by_distance"] = {
        j: family_recs[f"pair_cross {j}"]["ms"] for j in (1, 16, 32, 1024)}
    for r in summary:
        r["launches"] = main_launches[r["name"]]
    print(json.dumps({"profiled_device_ms": PROFILED_MS}))
    print(f"total: {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


REPLACES = {
    "block_sort": "cl_ops_tpu/ops/sort/bitonic_kernels.py:254",
    "multi_stage": "cl_ops_tpu/ops/sort/bitonic_kernels.py:601",
    "pair_cross": "cl_ops_tpu/ops/sort/bitonic_kernels.py:472, :292, :318",
    "block_merge": "cl_ops_tpu/ops/sort/bitonic_kernels.py:271",
    "scan_carry": "cl_ops_tpu/ops/scan/kernels.py:182",
    "scan_carry_wide": "cl_ops_tpu/ops/scan/kernels.py:208",
    "seg_scan_carry": "cl_ops_tpu/ops/scan/segmented.py:111",
    "scan_block": "cl_ops_tpu/ops/scan/kernels.py:148",
    "scan_block_wide": "cl_ops_tpu/ops/scan/kernels.py:241",
    "probe_band": "cl_ops_tpu/ops/exec/bandprobe.py:87",
    "whole_sort": "cl_ops_tpu/ops/sort/bitonic_kernels.py:567",
    "rank_hist": "cl_ops_tpu/ops/sort/satradix.py:62",
    "rank_hist_limb": "cl_ops_tpu/ops/sort/satradix.py:62",
    "dense_agg": "cl_ops_tpu/ops/exec/dense_agg.py:56",
    "chunk_copy": "cl_ops_tpu/ops/sort/dma_scatter.py:47",
}

# Device-memory bytes per row of the GROUP BY cell outside the sort, counted
# from ops/exec/aggregate.py for a sum over u32 keys and int32 values (sparse
# group ends). The searchsorted over the end ranks (num_groups binary
# searches) is not counted.
GROUPBY_BYTES_PER_ROW = {
    "key limbs to and from the sort": 16,
    "positions and validity": 5,
    "is_new (compare, concat, and)": 14,
    "count (sum of is_new)": 1,
    "is_end (concats, not, or, and)": 12,
    "is_end to int32": 5,
    "scan_carry of the end flags": 8,
    "scan_carry of the values": 8,
}

# The query cells' models: device-memory bytes each row needs moved, counted
# from the port's code (each torch op reads its operands and writes its
# result once).
DENSE_Q1_BYTES_PER_ROW = {
    "shipdate read by the WHERE": 4,
    "mask written and read": 2,
    "group id": 4,
    "quantity, discount and price": 12,
}
# window: two segmented scans (value, flag, out) and the limb-change flags
WINDOW_SCAN_BYTES = 2 * 3 * 4 + 4
# top_k's fast branch: no n-row sort
TOPK_BYTES_PER_ROW = {
    "value limbs": 8,
    "survivor mask (compare, to int32)": 10,
    "survivor counts per block": 4,
    "four first-survivor sweeps": 16,
}
# distinct outside its two sorts (the keys', and the dense group ends' sort
# of flag * n + position)
DISTINCT_BYTES_PER_ROW = {
    "key limbs to and from the sort": 16,
    "positions and validity": 5,
    "is_new (compare, concat, and)": 14,
    "count (sum of is_new)": 1,
    "is_end (concats, not, or, and)": 12,
    "end flags' sort key (flag * n + position)": 29,
}


def dense_read_bytes(n, n_cols, masked):
    """The bytes dense_agg must read: each row's id, its mask byte where a
    mask is given, and each distinct column once (the tables are KBs)."""
    return n * (4 + int(masked) + 4 * n_cols)


def chunk_copy_bytes(params, n_arrays):
    """The bytes chunk_copy must move: per array, each chunk's valid
    elements read once and each whole chunk written once."""
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
    rem = int(params[3].double().sum())
    return n_arrays * (4 * rem + 4 * ds.CHUNK * params.shape[1])


if __name__ == "__main__":
    sys.exit(main())
