"""Tracing / profiling helpers.

Counterpart of `cl_ops_tpu/utils/profiling.py`, after the reference's
event-profiling discipline (SURVEY.md §5): the reference names every
enqueued kernel event (`ccl_event_set_name`, e.g.
`clo_scan_blelloch.c:158,183,193`) and aggregates per-kernel durations with
`ccl_prof` (`clo_sort_bench.c:201-208`). Here:

  * `named(name, **attrs)` — a host range while a profiler records, else
    a shared no-op context, so the enclosed work shows up labelled in
    profiler traces at the cost of one check when nothing records;
    `spanned(name)` puts a function's calls in one;
  * `trace(logdir)` — a `torch.profiler` capture of the enclosed block,
    written to `logdir` as a Chrome trace;
  * `timed(label)` — wall-clock time with a final device synchronise, for
    quick numbers without a trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity


_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def named(name: str, **attrs):
    """Label the enclosed ops in profiler traces (event-name parity).

    While a torch profiler records, a range named `name` followed by each
    attribute as ` key=value`; otherwise one shared `nullcontext`, with
    nothing formatted. In a profiler schedule the warm-up steps record
    nothing, so neither do these ranges. The range is a plain host op
    (`_RecordFunctionFast`, the form torch's compiled graphs use), not a
    `record_function` user annotation: the profiler mirrors those onto
    every device stream they launched work on, and a trace's device
    timeline should hold the device's work alone. It also costs a few
    microseconds less a range while recording. For nsys, run under
    `torch.autograd.profiler.emit_nvtx()`, which turns every such range
    into an NVTX range.
    """
    if not _recording():
        return _OFF
    if attrs:
        name += "".join(f" {k}={v}" for k, v in attrs.items())
    return _range(name)


def spanned(name: str):
    """Decorator: run each call of the function inside `named(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with named(name):
                return fn(*args, **kwargs)
        return call
    return wrap


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
