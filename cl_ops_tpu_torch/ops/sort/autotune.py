"""On-card geometry tuner for the fused bitonic sort.

Counterpart of `cl_ops_tpu/ops/sort/autotune.py` (the reference's abitonic
kernel table plus live probing, `clo_sort_abitonic.c:58-313`). It times the
fused schedule over a small grid of (block_elems, merge_elems) geometries,
and the single-launch whole_sort where the problem fits it, once per
(device name, padded length, columns), on the card with CUDA events, and
keeps the winner in memory and in a JSON file: `$CL_OPS_AUTOTUNE_CACHE`,
else `~/.cl_ops_tpu_torch_autotune.json`.

Opt in with sort_new("abitonic", "autotune=1"), or CL_OPS_PSORT_AUTOTUNE=1
for the operators' `psort.sort_i32_cols`. CPU tensors are never tuned: they
take the static geometry. A candidate that fails to launch raises; nothing
is recorded as infeasible behind a caught error.
"""

from __future__ import annotations

import os
import statistics

import torch

from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.utils import jsoncache

CACHE_ENV = "CL_OPS_AUTOTUNE_CACHE"
_mem_cache: dict[str, tuple[int, int, bool]] = {}


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.expanduser(
        "~/.cl_ops_tpu_torch_autotune.json")


def candidate_geometries(n_padded: int,
                         n_arrays: int) -> list[tuple[int, int, bool]]:
    """(block_elems, merge_elems, single_launch) candidates: merge blocks of
    the largest power of two whose columns fit one block's shared memory and
    the two below it, sort blocks of a half, a quarter and an eighth of the
    merge block, clamped to the length; then whole_sort when n x columns
    fits it."""
    m_max = 2
    while n_arrays * (m_max * 2) * 4 <= bk.SMEM_MAX:
        m_max *= 2
    cands = []
    for m in (m_max, m_max // 2, m_max // 4):
        for b in (m // 2, m // 4, m // 8):
            b = max(min(b, n_padded), 1)
            geo = (b, max(min(m, n_padded), b), False)
            if geo not in cands:
                cands.append(geo)
    if n_padded * n_arrays <= bk.WHOLE_MAX:
        b, m, _ = cands[0]
        cands.append((b, m, True))
    return cands


def device_kind(device) -> str:
    return torch.cuda.get_device_name(device)


def time_candidate(geo: tuple[int, int, bool], src, reps: int = 3) -> float:
    """Median milliseconds of bitonic_sort_2d with geometry `geo` over
    `reps` timed runs after one warm-up, each on a fresh copy of the
    columns `src` (the copy is not timed)."""
    b, m, sl = geo
    work = [c.clone() for c in src]
    times = []
    for i in range(reps + 1):
        for w, s in zip(work, src):
            w.copy_(s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        bk.bitonic_sort_2d(work, block_elems=b, merge_elems=m,
                           single_launch=sl)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def tune_geometry(n_padded: int, n_arrays: int,
                  device) -> tuple[int, int, bool]:
    """The fastest (block_elems, merge_elems, single_launch) for sorting
    `n_arrays` int32 columns of `n_padded` rows on `device`, from the cache
    or from a sweep of candidate_geometries on random columns."""
    key = f"{device_kind(device)}:{n_padded}x{n_arrays}"
    if key in _mem_cache:
        return _mem_cache[key]
    disk = jsoncache.load(cache_path())
    if key not in disk:
        gen = torch.Generator(device=device).manual_seed(n_padded + n_arrays)
        src = [torch.randint(-2 ** 31, 2 ** 31 - 1, (n_padded,),
                             dtype=torch.int32, device=device, generator=gen)
               for _ in range(n_arrays)]
        times = {geo: time_candidate(geo, src)
                 for geo in candidate_geometries(n_padded, n_arrays)}
        disk[key] = list(min(times, key=times.get))
        jsoncache.save(cache_path(), disk)
    b, m, sl = disk[key]
    _mem_cache[key] = (int(b), int(m), bool(sl))
    return _mem_cache[key]
