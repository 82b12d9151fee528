"""The harness: every file found by name, every plan equal to its reference
through the port's plain paths, the result line's keys, the refusals, and
no JAX anywhere. Runs on the CPU; the card test skips without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests.conftest import SCALE

PB = Path(run.__file__).resolve().parent
SPEC = run.spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cpu_run(workload, trace=False, seed=11):
    w = run.cell(workload)
    return run.run_cell(workload, seed, 0.01, trace, device="cpu",
                        scale=SCALE[w["config"]])


def test_every_file_found_by_name():
    for c in SPEC["configs"]:
        cfg = run.config(c["name"])
        assert (run.ROOT / c["file"]).resolve() == \
            PB / "configs" / f"{c['name']}.json"
        assert cfg["name"] == c["name"]
        assert callable(run.module("data", c["name"]).generate)
    for w in SPEC["workloads"]:
        mx = run.mix(w["config"], w["traffic"])
        assert mx["fact_table"]
        for q in mx["queries"]:
            plan = run.module("plans", q["query"])
            assert callable(plan.run) and callable(plan.work)
            assert callable(run.module("reference", q["query"]).answer)
    for m in SPEC["per_layer"]:
        assert callable(run.metric(m["name"]).read)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_plan_equals_reference_on_cpu(workload, small_mix):
    out = _cpu_run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["mismatches"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, small_mix):
    out = _cpu_run("ssb_sf20.q1_flight", trace)
    keys = KEYS + (["breakdown"] if trace else [])
    # the compared numbers come last, under a key of their own
    assert list(out) == keys + ["checks"]
    json.dumps(out)
    want = {m["name"] for m in SPEC["per_layer"]
            if "ssb_sf20.q1_flight" in m["workloads"]} if trace \
        else set(run.E2E)
    got = set(out["metrics"])
    # a CPU trace holds no kernel: only the idle share has something to read
    assert got <= want and (got == want or trace)
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_exits_nonzero_without_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "2147483653",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_refused(monkeypatch, small_mix):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["json"])
    with pytest.raises(SystemExit, match="jax"):
        _cpu_run("ssb_sf20.q1_flight")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_the_benchmark_sources():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_no_jax_reached_from_a_run():
    code = ("import sys; from portbench import run;"
            "run.run_cell('ssb_sf20.q1_flight', 3, 0.01, False, "
            "device='cpu', scale=1e-4);"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "cl_ops_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_fails_without_the_program(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import run;"
            "print(run.run_cell('ssb_sf20.q1_flight', 3, 0.01, False, "
            "device='cpu', scale=1e-4))")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "cl_ops_tpu_torch" in out.stderr


@pytest.mark.cuda
def test_every_cell_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in WORKLOADS:
        assert run.main(["--workload", workload, "--seed", "2147483711",
                         "--seconds", "2"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"

