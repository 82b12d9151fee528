#!/usr/bin/env python3
"""Smoke run of cl_ops_tpu_torch on one CUDA card.

Builds the CUDA kernels from `cl_ops_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version at the main path's shapes, drives the main
path (abitonic sort of 16M u32 keys, KV sort of 16M u64 keys with u32
values, sort_pipeline at 16M, filter_compact over 64M rows at 10%
selectivity), checks every result, and times the kernels, the sort and the
filter with CUDA events. Run from the repository root:

    python3 chip_smoke.py

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that one JSON line lists every
kernel with its launches on the main path, time, bound and yardsticks. Any
failure raises and exits non-zero; without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# NVIDIA H100 SXM data sheet: device memory rate, and the non-tensor-core
# 32-bit rate (the table lists float32; int32 compares and selects are taken
# at the same rate).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
SEED = 0
SORT_N = 1 << 24
FILTER_N = 1 << 26
FILTER_THRESHOLD = 429496730  # u32 values below it: 10% of the range


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    import numpy as np

    from cl_ops_tpu_torch import interop
    from cl_ops_tpu_torch.models import pipeline
    from cl_ops_tpu_torch.ops.exec import filter_compact, psort
    from cl_ops_tpu_torch.ops.sort import bitonic as bt
    from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
    from cl_ops_tpu_torch.ops.sort import keys as keymod
    from cl_ops_tpu_torch.ops.sort import sort_new

    dev = torch.device("cuda")
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
        bk.load_kernels()
        print(f"kernel build+load: {time.perf_counter() - t:.3f} s")
        for line in bk.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())

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
        for name in bk.KERNELS:
            kern, plain, args = calls[name]
            src = [c.clone() for c in state]
            work = [c.clone() for c in state]
            ref = [c.clone() for c in state]
            kern(work, *args, num_keys=num_keys)
            plain(ref, *args, num_keys)
            torch.cuda.synchronize()
            err = max(int((w.to(torch.int64) - r.to(torch.int64)).abs().max())
                      for w, r in zip(work, ref))
            if err != 0:
                raise AssertionError(f"{name}: kernel differs from its plain "
                                     f"version (max abs err {err})")

            def restore(work=work, src=src):
                for w, s in zip(work, src):
                    w.copy_(s)
            ms = cuda_ms(lambda: kern(work, *args, num_keys=num_keys), 7,
                         restore)
            plain_ms = cuda_ms(lambda: plain(work, *args, num_keys), 3,
                               restore)
            lib = library.get(name)
            lib_ms = cuda_ms(lib, 5) if lib is not None else None
            nbytes = 2 * nc * 4 * n
            ops = 2 * num_keys * (n // 2) * steps[name]
            bytes_ms = nbytes / PEAK_BYTES_S * 1e3
            ops_ms = ops / PEAK_OPS_S * 1e3
            recs.append({
                "name": name, "route": "cuda",
                "source": "cl_ops_tpu_torch/csrc/bitonic.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib_ms,
                "shape": f"n={n} cols={nc} num_keys={num_keys} "
                         f"block={b} merge={m}"})
            state = ref  # the next kernel's input (kernel and plain agree)
        return recs

    with phase("kernels vs plain"):
        keys32 = interop.to_torch(
            rng.integers(0, 2 ** 32, SORT_N, dtype=np.uint32), dev)
        limb32 = keymod.to_limbs(keys32)
        b1, m1 = bt.resolve_geometry(SORT_N, 1)
        x = limb32[0]
        u32_recs = kernel_table(limb32, 1, {
            "block_sort": lambda: torch.sort(x.view(-1, b1), dim=1),
            "multi_stage": lambda: torch.sort(x.view(-1, m1), dim=1)})
        keys64 = interop.to_torch(
            rng.integers(0, 2 ** 64, SORT_N, dtype=np.uint64), dev)
        vals32 = interop.to_torch(
            rng.integers(0, 2 ** 32, SORT_N, dtype=np.uint32), dev)
        kv_recs = kernel_table(
            keymod.to_limbs(keys64) + [vals32.view(torch.int32)], 2, {})
        for r in u32_recs + kv_recs:
            print("kernel", json.dumps(r))

    main_launches = dict.fromkeys(bk.KERNELS, 0)

    def count(name):
        for k in bk.KERNELS:
            main_launches[k] += bk.launches[k]
        print(f"launches in {name}:", json.dumps(bk.launches))

    sorter = sort_new("abitonic")
    with phase("sort 16M u32"):
        bk.reset_launches()
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
        bk.reset_launches()
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
        bk.reset_launches()
        sk, ok = pipeline.sort_pipeline(SORT_N, seed=SEED, device="cuda")
        torch.cuda.synchronize()
        count("sort_pipeline")
        if not bool(ok):
            raise AssertionError("sort_pipeline: output not sorted")
        gk, _ = pipeline.generate_table(SORT_N, SEED, device="cuda")
        ck, _ = pipeline.generate_table(1 << 16, SEED, device="cpu")
        if not torch.equal(gk[:1 << 16].cpu().view(torch.int32),
                           ck.view(torch.int32)):
            raise AssertionError("threefry on the card differs from the CPU")
        if not torch.equal(keymod.to_limbs(sk)[0],
                           torch.sort(keymod.to_limbs(gk)[0])[0]):
            raise AssertionError("sort_pipeline keys differ from torch.sort")

    with phase("filter 64M u32 + u32 at 10%"):
        h_data = rng.integers(0, 2 ** 32, FILTER_N, dtype=np.uint32)
        h_pay = rng.integers(0, 2 ** 32, FILTER_N, dtype=np.uint32)
        d_data = interop.to_torch(h_data, dev)
        d_pay = interop.to_torch(h_pay, dev)

        def pred(v):
            return interop.widen_u32(v) < FILTER_THRESHOLD
        bk.reset_launches()
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

    for name, n in main_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    for r in u32_recs:
        r["launches"] = main_launches[r["name"]]
    print(json.dumps({"kernels": u32_recs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


REPLACES = {
    "block_sort": "cl_ops_tpu/ops/sort/bitonic_kernels.py:254",
    "multi_stage": "cl_ops_tpu/ops/sort/bitonic_kernels.py:601",
    "pair_cross": "cl_ops_tpu/ops/sort/bitonic_kernels.py:472",
    "block_merge": "cl_ops_tpu/ops/sort/bitonic_kernels.py:271",
}

if __name__ == "__main__":
    sys.exit(main())
