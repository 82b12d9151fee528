"""Run one cell of the port's benchmark once and print the result line.

    python3 -m portbench.run --workload <config>.<mix> --seed N \
        --seconds S --trace 0|1

The cell's configuration, mix, plans, references and per-layer metrics are
files found by name (portbench/configs, data, mixes, plans, reference,
metrics). The run makes the configuration's tables on the device from the
seed, warms up the mix's queries, and then runs the window: a closed loop
with one client, the mix's queries in their fixed order, round and round,
each ending when its result is on the host. After the window every result
is compared with the plain reference. With --trace 1 a shorter window of
whole rounds runs under torch.profiler and the per-layer metrics are
printed instead of the end-to-end ones.

A cell of N chips runs on cuda:0 .. cuda:N-1 from this one process: its
generator gets the list of devices and holds each table one shard per
device. The harness waits on every card, reads each card's memory (the
working memory is the largest card's own, the peak the fullest card's), and
reads each card's busy time from the trace (the idle share is the mean over
the cards; device seconds of a layer are summed over them).
"""

from __future__ import annotations

import time

_MODULE_T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent        # the checkout
PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cl_ops_tpu")  # whole top-level names
WARMUP_ROUNDS = 2
TRACE_S = 3.0             # the traced window: whole rounds, at least this
UNITS = {"mrows_s": "Mrows/s", "query_ms_p95": "ms", "query_mem_gib": "GiB",
         "setup_s": "s"}
E2E = tuple(UNITS)


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _MODULE_T0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --- finding a cell's files by name -----------------------------------------

def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    for w in spec()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}")


def config(name: str) -> dict:
    return json.loads((PB / "configs" / f"{name}.json").read_text())


def mix(config_name: str, traffic: str) -> dict:
    return json.loads((PB / "mixes" / f"{config_name}.{traffic}.json")
                      .read_text())


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py: a generator, plan or reference."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric(name: str):
    """portbench/metrics/<name>.py (metric names hold dots)."""
    path = PB / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


# --- the window -------------------------------------------------------------

class Spans:
    """`span(layer)` around each operator call, `query(name)` around each
    query: record_function ranges when traced, nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def _range(self, name):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def __call__(self, layer: str):
        return self._range("pb.op:" + layer)

    def query(self, name: str):
        return self._range("pb.q:" + name)


def to_host(result: dict) -> dict:
    """A plan's or reference's result as numpy columns and int counts."""
    return {"rows": [c.cpu().numpy() for c in result["rows"]],
            "counts": {k: int(v) for k, v in result["counts"].items()}}


def rows(column) -> int:
    """Rows of a column: a tensor's, or the sum over its shards where it is
    held one shard per device (a list or tuple of tensors, or an object with
    `.shards`, such as the port's `Sharded`)."""
    shards = getattr(column, "shards", column)
    if isinstance(shards, (list, tuple)):
        return sum(s.shape[0] for s in shards)
    return column.shape[0]


def table_sizes(tables: dict) -> dict:
    """Rows of each table, from its first column."""
    return {name: rows(next(iter(cols.values())))
            for name, cols in tables.items()}


def cell_devices(w: dict, device: str = "cuda", devices=None) -> list:
    """The cell's devices: `device` for a cell of one chip, cuda:0 ..
    cuda:N-1 for one of N, or `devices` where given (tests: a CPU list, or
    one card repeated). Raises ValueError where `devices` holds another
    number than the cell's chips."""
    import torch
    if devices is None:
        n = w["chips"]
        devices = [device] if n == 1 else [f"{device}:{i}" for i in range(n)]
    if len(devices) != w["chips"]:
        raise ValueError(f"{len(devices)} devices for a cell of "
                         f"{w['chips']} chips")
    return [torch.device(d) for d in devices]


def make_tables(config_name: str, cfg: dict, seed: int, devices: list,
                scale: float = 1.0) -> dict:
    """The configuration's tables from the seed: on the one device, or one
    shard per device of a cell of several."""
    generate = module("data", config_name).generate
    return generate(cfg, seed, devices[0] if len(devices) == 1 else devices,
                    scale)


class Cards:
    """The distinct CUDA cards among a cell's devices, in device order:
    what the harness waits on and reads memory from (none on the CPU)."""

    def __init__(self, devices):
        import torch
        self.cuda = torch.cuda
        self.cards = list(dict.fromkeys(d for d in devices
                                        if d.type == "cuda"))

    def sync(self):
        for d in self.cards:
            self.cuda.synchronize(d)

    def allocated(self) -> list:
        return [self.cuda.memory_allocated(d) for d in self.cards]

    def peaks(self) -> list:
        return [self.cuda.max_memory_allocated(d) for d in self.cards]

    def reset_peaks(self):
        for d in self.cards:
            self.cuda.reset_peak_memory_stats(d)


def memory(resident: list, setup_peak: list, peak: list) -> tuple:
    """(working bytes, the fullest card's peak, each card's peak) from each
    card's bytes after set-up, its peak in set-up and its peak in the
    window. The working bytes are the largest of each card's own peak less
    its resident tables: what has to fit beside the tables on the card that
    runs out first."""
    per_card = [max(s, p) for s, p in zip(setup_peak, peak)]
    work = max((p - r for p, r in zip(peak, resident)), default=0)
    return work, max(per_card, default=0), per_card


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", devices=None, scale: float = 1.0,
             age=process_age_s) -> dict:
    """One run of a cell on its devices (`cell_devices`). Returns the
    result line's object, the compared numbers under "checks" (last)."""
    import torch
    w = cell(workload)
    cfg = config(w["config"])
    mx = mix(w["config"], w["traffic"])
    t_torch = age()
    queries = [(q["query"], q.get("params", {}), module("plans", q["query"]))
               for q in mx["queries"]]
    t_port = age()
    devs = cell_devices(w, device, devices)
    dev = devs[0]
    on_card = dev.type == "cuda"
    cards = Cards(devs)
    sync = cards.sync

    for d in dict.fromkeys(devs):       # the contexts, before the tables
        torch.zeros(1, device=d)
    sync()
    t_start = age()
    tables = make_tables(w["config"], cfg, seed, devs, scale)
    sizes = table_sizes(tables)
    sync()
    t_tables = age()
    resident = cards.allocated()
    spans = Spans(trace)

    def run_query(i):
        name, params, plan = queries[i % len(queries)]
        with spans.query(name):
            return name, to_host(plan.run(tables, params, spans))

    for i in range(WARMUP_ROUNDS * len(queries)):
        run_query(i)
    sync()
    setup_peak = cards.peaks()
    cards.reset_peaks()
    setup_s = age()
    print(f"setup: torch imported {t_torch:.3f} s, the port "
          f"{t_port - t_torch:.3f} s, device context {t_start - t_port:.3f}"
          f" s, tables "
          f"{t_tables - t_start:.3f} s ({sum(resident)} bytes), warm-up "
          f"{setup_s - t_tables:.3f} s", file=sys.stderr)

    results, times, events = [], [], []
    limit = min(seconds, TRACE_S) if trace else seconds
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, schedule

        from portbench import trace as tr
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        # One traced round is dropped: without it the card's traces lost
        # kernels.
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=lambda p: events.extend(
                           tr.from_profiler(p)))
        prof.start()
        for i in range(len(queries)):
            run_query(i)
        sync()
        prof.step()
    t0 = time.perf_counter()
    i = 0
    while True:
        tq = time.perf_counter()
        results.append(run_query(i))
        times.append(time.perf_counter() - tq)
        i += 1
        if time.perf_counter() - t0 >= limit and i % len(queries) == 0:
            break
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.step()
        prof.stop()
    work, fullest, per_card = memory(resident, setup_peak, cards.peaks())

    found = forbidden_modules()
    if found:
        raise SystemExit("the run loaded " + ", ".join(found))

    refs = {name: to_host(module("reference", name).answer(tables, params))
            for name, params, _ in queries}
    from portbench import compare
    checks = compare.check(results, refs)

    if trace:
        metrics, extra = _per_layer(workload, events, queries, sizes, refs,
                                    max(len(cards.cards), 1))
    else:
        fact = sizes[mx["fact_table"]]
        metrics = {"mrows_s": fact * len(results) / window_s / 1e6,
                   "query_ms_p95": float(np.percentile(times, 95)) * 1e3,
                   "query_mem_gib": work / 2 ** 30,
                   "setup_s": setup_s}
        metrics = {k: {"value": metrics[k], "unit": UNITS[k]} for k in E2E}
        extra = {}
    out = {"correct": checks["failed"] == 0, "attempted": len(results),
           "failed": checks["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if on_card else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if on_card
                               else dev.type),
                      "count": w["chips"],
                      "memory_peak_bytes": fullest,
                      "memory_peak_bytes_per_card": per_card,
                      **extra.pop("device", {})},
           **extra}
    out["checks"] = {k: {"value": checks[k], "limit": compare.LIMITS[k]}
                     for k in compare.LIMITS}
    return out


def _per_layer(workload, events, queries, sizes, refs, cards=1):
    """The cell's per-layer metrics from the traced window's events on
    `cards` cards. A reader gets `trace.aggregate`'s result with the port's
    summary under "port" (`port_trace.of`)."""
    from portbench import port_trace, roofline, trace as tr
    agg = tr.aggregate(events, cards)
    agg["port"] = port_trace.summarize(events, cards)
    per_query = {}
    for name, params, plan in queries:
        per_query[name] = {}
        for layer, nbytes in plan.work(sizes, refs[name]["counts"], params):
            per_query[name][layer] = per_query[name].get(layer, 0) + nbytes
    bound_s = {}
    for e in events:
        if e.kind == "query":
            for layer, nbytes in per_query[e.name[len(tr.QUERY):]].items():
                bound_s[layer] = (bound_s.get(layer, 0.0)
                                  + nbytes / roofline.PEAK_BYTES_S)
    agg["bound_s"] = bound_s
    metrics = {}
    for m in spec()["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = metric(m["name"]).read(agg)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(f"trace: {agg['queries']} queries, {agg['kernels']} kernels, "
          f"{agg['unattributed']} unattributed", file=sys.stderr)
    return metrics, {"device": {"busy_s": agg["busy_s"],
                                "window_s": agg["window_s"],
                                "busy_s_per_card": agg["busy_s_per_card"]},
                     "breakdown": {"device_ops": tr.top(agg["kernel_s"]),
                                   "idle_gaps": tr.top(agg["gaps"])}}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["CL_OPS_TORCH_BUILD_DIR"] = str(
        ROOT / "cl_ops_tpu_torch" / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
    import torch
    torch.set_num_threads(1)
    chips = cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print("card: " + card_line(), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
