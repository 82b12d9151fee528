"""Tracing / profiling helpers.

Counterpart of `cl_ops_tpu/utils/profiling.py`, after the reference's
event-profiling discipline (SURVEY.md §5): the reference names every
enqueued kernel event (`ccl_event_set_name`, e.g.
`clo_scan_blelloch.c:158,183,193`) and aggregates per-kernel durations with
`ccl_prof` (`clo_sort_bench.c:201-208`). Here:

  * `named(name)` — a `torch.profiler.record_function` range, plus an NVTX
    range where CUDA is available, so the enclosed work shows up labelled
    in profiler traces;
  * `trace(logdir)` — a `torch.profiler` capture of the enclosed block,
    written to `logdir` as a Chrome trace;
  * `timed(label)` — wall-clock time with a final device synchronise, for
    quick numbers without a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def named(name: str) -> Iterator[None]:
    """Label the enclosed ops in profiler traces (event-name parity)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block (CPU activity,
    and CUDA activity when CUDA is initialised) into a Chrome trace file
    `trace_<pid>_<ns>.json` in `logdir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def timed(label: str, results: dict | None = None) -> Iterator[None]:
    """Wall-clock the enclosed block, synchronising the current CUDA device
    at its end when CUDA is initialised."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        else:
            print(f"[{label}] {dt * 1e3:.2f} ms")
