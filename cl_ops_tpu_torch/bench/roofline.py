"""Device-memory roofline accounting for the benchmark harness.

Counterpart of `cl_ops_tpu/bench/roofline.py`. Every bench reports, next
to rows/s:

  * a bytes-moved model of the op (the traffic its launch schedule
    performs, computed on the host from the parameters the kernels use),
  * the achieved GB/s = bytes_moved / measured_seconds,
  * roofline_frac = achieved / measured stream ceiling.

The ceiling is measured once per process with an elementwise `a + 1` over a
large buffer (read + write), timed with CUDA events.
"""

from __future__ import annotations

import functools
import os

import torch

from cl_ops_tpu_torch.utils import jsoncache
from cl_ops_tpu_torch.utils.platform import default_device

GBS_ENV = "CL_OPS_ROOFLINE_GBS"
CACHE_ENV = "CL_OPS_ROOFLINE_CACHE"


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or os.path.expanduser(
        "~/.cl_ops_tpu_torch_roofline.json")


@functools.lru_cache(maxsize=None)
def stream_ceiling_gbs(mb: int = 1024, depth: int = 8) -> float:
    """Measured device stream bandwidth in GB/s (read + write).

    An `a + 1` over an mb-MiB int32 buffer moves 2x its size per iteration;
    `depth` chained iterations are timed with CUDA events, and the best of
    3 such runs is kept (a ceiling is a maximum). The value is cached in
    memory and in a JSON file ($CL_OPS_ROOFLINE_CACHE, else
    ~/.cl_ops_tpu_torch_roofline.json) per device name and size.
    $CL_OPS_ROOFLINE_GBS overrides the measurement.
    """
    if os.environ.get(GBS_ENV):
        return float(os.environ[GBS_ENV])
    dev = default_device("cuda")
    key = f"{torch.cuda.get_device_name(dev).replace(' ', '_')}:{mb}"
    cached = jsoncache.load(cache_path())
    if key in cached:
        return float(cached[key])
    n = mb * (1 << 20) // 4
    out = torch.arange(n, dtype=torch.int32, device=dev)
    out = out + 1  # warm-up
    best = 0.0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(depth):
            out = out + 1
        end.record()
        torch.cuda.synchronize(dev)
        best = max(best, 2.0 * n * 4 * depth / (start.elapsed_time(end) / 1e3)
                   / 1e9)
    cached[key] = best
    jsoncache.save(cache_path(), cached)
    return best


def roofline_row(bytes_moved: int, seconds: float) -> dict:
    """gb_s + roofline_frac fields for a bench row."""
    gbs = bytes_moved / seconds / 1e9
    ceil = stream_ceiling_gbs()
    return {"gb_s": round(gbs, 2),
            "roofline_frac": round(gbs / ceil, 3) if ceil > 0 else 0.0}
