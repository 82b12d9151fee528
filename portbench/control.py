"""The readings that the limits of `correct` are set from.

    python3 -m portbench.control --workload <config>.<mix> --seeds 1,2,3

For each seed: the cell's tables at full size, each query of the mix run
once by the program (the lower reading) and once by the control, the
reference computed with every decimal in float32 in the program's place
(the upper reading), both compared with the exact reference as a run
compares them. One JSON line a seed, with the reference's operator row
counts, then the largest program reading and the smallest control reading
of each compared number. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import compare, run


def readings(workload: str, seed: int, *, device: str = "cuda",
             scale: float = 1.0) -> dict:
    w = run.cell(workload)
    cfg = run.config(w["config"])
    mx = run.mix(w["config"], w["traffic"])
    tables = run.make_tables(w["config"], cfg, seed,
                             run.cell_devices(w, device), scale)
    spans = run.Spans(False)
    program, control, refs = [], [], {}
    for q in mx["queries"]:
        name, params = q["query"], q.get("params", {})
        program.append((name, run.to_host(
            run.module("plans", name).run(tables, params, spans))))
        ref = run.module("reference", name)
        refs[name] = run.to_host(ref.answer(tables, params))
        control.append((name, run.to_host(ref.answer(tables, params,
                                                     exact=False))))
    return {"seed": seed, "program": compare.check(program, refs),
            "control": compare.check(control, refs),
            "counts": {q: r["counts"] for q, r in refs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    os.environ["CL_OPS_TORCH_BUILD_DIR"] = str(
        run.ROOT / "cl_ops_tpu_torch" / "_build")
    lows, highs = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed)
        print(json.dumps(r), flush=True)
        for k in compare.LIMITS:
            lows[k] = max(lows.get(k, 0), r["program"][k])
            highs[k] = min(highs.get(k, r["control"][k]), r["control"][k])
    print(json.dumps({"workload": args.workload, "lower": lows,
                      "upper": highs, "limits": compare.LIMITS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
