"""Benchmark harness shared pieces.

Counterpart of `cl_ops_tpu/bench/common.py` (the reference's bench common
module, `src/benchmarks/clo_bench.c`): typed random fill (`clo_bench_rand`,
clo_bench.c:67-142), typed comparator (`clo_bench_compare`,
clo_bench.c:31-65), plus the throughput formula and TSV output shared by
the CLIs (`clo_sort_bench.c:233-249`). The numpy helpers give the JAX
package's bytes exactly.

`time_async` queues `runs` calls and synchronises once at the end, so a
batch measures the device's time for the calls rather than one host round
trip per call (the reference sums profiled event times,
clo_sort_bench.c:201-208).
"""

from __future__ import annotations

import time

import numpy as np
import torch


def rand_array(dtype, n: int, seed: int = 0) -> np.ndarray:
    """Typed random values covering the type's range (clo_bench_rand parity).

    Integer types draw uniformly over their full range; floats draw normal
    scaled values like the reference's g_rand_double ranges.
    """
    rng = np.random.RandomState(seed)
    dt = np.dtype(dtype)
    if dt.kind in "ui" and dt.itemsize == 8:
        # Compose 64-bit draws from two 32-bit halves: a single randint is
        # capped below 2^63, which would never set the top bit of u64 data.
        lo = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        hi = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        return (lo | (hi << np.uint64(32))).view(np.uint64).astype(dt) \
            if dt.kind == "u" else (lo | (hi << np.uint64(32))).view(np.int64)
    if dt.kind == "u":
        bits = 8 * dt.itemsize
        return rng.randint(0, 2 ** bits, size=n,
                           dtype=np.uint64).astype(dt)
    if dt.kind == "i":
        lim = 2 ** (8 * dt.itemsize - 1)
        return rng.randint(-lim, lim, size=n, dtype=np.int64).astype(dt)
    return (rng.randn(n) * 128).astype(dt)


def compare_values(a, b) -> int:
    """Three-way compare (clo_bench_compare parity)."""
    return int(a > b) - int(a < b)


def time_async(fn, args, runs: int, sync_fn) -> float:
    """Queue `runs` calls of fn(*args), sync once; return seconds total."""
    out = fn(*args)
    sync_fn(out)  # warm-up: kernel builds, allocator
    t0 = time.perf_counter()
    for _ in range(runs):
        out = fn(*args)
    sync_fn(out)
    return time.perf_counter() - t0


def time_adaptive(fn, args, sync_fn, *, min_runs: int = 5,
                  target_s: float = 2.0, max_runs: int = 400) -> float:
    """Per-call seconds with a run depth that fills `target_s`.

    Measure one batch of `min_runs`; if it finished well under `target_s`,
    measure again with the run count that fills the target window, so a
    short call is not timed mostly by its batch's one synchronise. Same
    formula as the reference (numel*runs/seconds,
    `clo_sort_bench.c:233-235`); only the batch depth adapts.
    """
    dt = time_async(fn, args, min_runs, sync_fn) / min_runs
    if dt * min_runs >= target_s:
        return dt
    runs = min(max_runs, max(min_runs, int(target_s / max(dt, 1e-7))))
    if runs <= min_runs:
        return dt
    return time_async(fn, args, runs, sync_fn) / runs


def throughput_m(numel: int, runs: int, seconds: float) -> float:
    """Mkeys/s | MValues/s: 1e-6 * numel * runs / seconds
    (clo_sort_bench.c:233-235)."""
    return 1e-6 * numel * runs / seconds


def write_tsv(path: str, rows: list[dict]) -> None:
    """TSV output like the reference benches (clo_sort_bench.c:239-249)."""
    if not rows:
        return
    cols = list(rows[0].keys())
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(str(r[c]) for c in cols) + "\n")


def default_sync(device=None):
    """A sync_fn for time_async: it synchronises `device` when given, else
    the CUDA device of the output (the first element of a tuple), and does
    nothing for CPU tensors."""
    def sync(out):
        if device is not None:
            dev = torch.device(device)
        else:
            if isinstance(out, tuple):
                out = out[0]
            dev = out.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return sync
