"""Headline benchmark of the port: `bench.py`'s one JSON line.

The abitonic sort of 2^24 uint32 keys (the data of `bench.py:37-39`:
RandomState(7), values below 2^31), in Mkeys/s = n / seconds per call
(`clo_sort_bench.c:233-235`), timed by `time_adaptive` with the device
synchronised. The output must equal `torch.sort` of the same keys.
`vs_baseline` is `torch.sort`'s time over the port's (> 1: the port is
faster); `gb_s` and `roofline_frac` come from the fused schedule's bytes
model (`abitonic_traffic_bytes`) and the measured stream ceiling.

    python -m cl_ops_tpu_torch.bench.headline     # on the card

Prints exactly one JSON line on stdout. `--log2n` and `--device` exist so
that a test can run it small on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench.common import default_sync, time_adaptive
from cl_ops_tpu_torch.bench.roofline import stream_ceiling_gbs
from cl_ops_tpu_torch.ops.sort import autotune, sort_new
from cl_ops_tpu_torch.ops.sort.bitonic import abitonic_traffic_bytes
from cl_ops_tpu_torch.utils import jsoncache
from cl_ops_tpu_torch.utils.bits import nlpo2
from cl_ops_tpu_torch.utils.platform import default_device


def cached_geometry(n: int, device: torch.device) -> dict | None:
    """The autotuned geometry of a 1-column n-key sort when the tuner's
    cache already holds this device and shape, as sort options; None
    otherwise. Never starts a sweep."""
    if device.type != "cuda":
        return None
    geo = jsoncache.load(autotune.cache_path()).get(
        f"{autotune.device_kind(device)}:{nlpo2(n)}x1")
    if geo is None:
        return None
    b, m, sl = geo
    return {"block_elems": str(b), "merge_elems": str(m),
            "single_launch": str(int(sl))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log2n", type=int, default=24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = default_device(args.device)
    n = 1 << args.log2n

    host = np.random.RandomState(7).randint(
        0, 1 << 31, size=n, dtype=np.int64).astype(np.uint32)
    x = interop.to_torch(host, dev)
    # every key is below 2^31, so the int32 view sorts in the u32 order
    xi = x.view(torch.int32)
    sync = default_sync()

    geo = cached_geometry(n, dev)
    sorter = sort_new("abitonic", "autotune=1" if geo else None)
    out = sorter.sort_with_device_data(x)
    if not torch.equal(out.view(torch.int32), torch.sort(xi)[0]):
        raise AssertionError("abitonic output differs from torch.sort")
    dt_ours = time_adaptive(sorter.sort_with_device_data, (x,), sync)
    dt_lib = time_adaptive(torch.sort, (xi,), sync)

    bytes_moved = abitonic_traffic_bytes(n, 1, geo)
    gb_s = bytes_moved / dt_ours / 1e9
    ceiling = stream_ceiling_gbs()
    print(json.dumps({
        "metric": f"abitonic_sort_u32_{n >> 20}M" if n >= 1 << 20
        else f"abitonic_sort_u32_{n}",
        "value": round(n / dt_ours / 1e6, 1),
        "unit": "Mkeys/s",
        "vs_baseline": round(dt_lib / dt_ours, 4),
        "gb_s": round(gb_s, 2),
        "roofline_frac": round(gb_s / ceiling, 3),
        "ceiling_gb_s": round(ceiling, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
