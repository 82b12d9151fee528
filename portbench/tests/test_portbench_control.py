"""The comparison that decides `correct` fails what it must: the control
(the reference with float32 decimals in the program's place) on three
seeds, and a run whose timed path is broken underneath, once for each
fault the cells can have: half of an operator's rows left out, and an
answer altered where an operator produces it. (The cells hold no state
that a step could leave unchanged, and run on one card, so there is no
exchange between chips to leave out.)"""

import pytest
import torch

from portbench import control, run
from portbench.tests.conftest import SCALE, SEEDS

WORKLOADS = [w["name"] for w in run.spec()["workloads"]]
# The operator each fault breaks in each cell: one whose rows reach the
# answer. Q18's first group is rarely in its top 100, so the altered
# answer is top_k's first row.
OPERATOR = {"tpch_sf10.q18_groupby": ("group_aggregate_cols", "top_k"),
            "ssb_sf20.q2_flight": ("group_aggregate_cols",) * 2,
            "tpch_sf10.q1_pricing": ("group_aggregate_cols",) * 2,
            "ssb_sf20.q1_flight": ("hash_join",) * 2}


def _plans(workload):
    w = run.cell(workload)
    mods = []
    for q in run.mix(w["config"], w["traffic"])["queries"]:
        plan = run.module("plans", q["query"])
        shared = getattr(plan, "_ssb_q2", None) or getattr(plan, "_ssb_q1",
                                                           None)
        mods.append(shared or plan)
    return mods


def _break(monkeypatch, workload, fault):
    name = OPERATOR[workload][fault == "answer_altered"]
    for mod in _plans(workload):
        fn = getattr(mod, name)

        if fault == "half_left_out":
            def broken(keys, vals, *a, _fn=fn, **k):
                if name == "hash_join":     # half of the probes
                    probe = a[0]
                    out = _fn(keys, vals, probe[:probe.numel() // 2], **k)
                    pad = probe.numel() - out[0].numel()
                    return tuple(torch.cat([o, torch.zeros(pad, dtype=o.dtype)])
                                 for o in out)
                n = keys.numel() // 2
                if "valid_mask" in k:
                    k["valid_mask"] = k["valid_mask"][:n]
                return _fn(keys[:n], tuple(v[:n] for v in vals), *a, **k)
        else:
            def broken(*a, _fn=fn, **k):
                out = list(_fn(*a, **k))
                if name == "hash_join":     # the first 1% of the probes
                    out[1] = out[1].clone()
                    m = max(1, out[1].numel() // 100)
                    out[1][:m] = 1 - out[1][:m]
                elif name == "top_k":       # the first row's payload
                    out[1] = out[1].clone()
                    out[1][0] += 1
                else:
                    t = list(out[1])
                    t[0] = t[0].clone()
                    t[0][0] += 1
                    out[1] = tuple(t)
                return tuple(out)
        monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, small_mix):
    scale = SCALE[run.cell(workload)["config"]]
    for seed in SEEDS:
        r = control.readings(workload, seed, device="cpu", scale=scale)
        assert r["program"]["mismatches"] == 0
        assert r["control"]["mismatches"] > 0, r


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_path_is_not_correct(workload, fault, small_mix, monkeypatch):
    _break(monkeypatch, workload, fault)
    out = run.run_cell(workload, SEEDS[2], 0.01, False, device="cpu",
                       scale=SCALE[run.cell(workload)["config"]])
    assert out["correct"] is False
    assert out["checks"]["mismatches"]["value"] > 0



def test_a_text_column_is_compared_byte_for_byte():
    from portbench import compare
    names = torch.randint(97, 123, (5, 25), dtype=torch.uint8).numpy()
    other = names.copy()
    other[3, 24] += 1
    assert compare.rows_wrong([names], [names.copy()]) == 0
    assert compare.rows_wrong([other], [names]) == 1
    assert compare.rows_wrong([names[:, :24]], [names]) == 5
