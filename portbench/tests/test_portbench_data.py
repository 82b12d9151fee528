"""The generators give every seed the same work: at a small scale, three
seeds keep the same row count at every operator of every query and take
the same path through every operator, while the answers differ."""

import json

import pytest
import torch

from cl_ops_tpu_torch.ops.exec import bandprobe, join, psort, topk
from portbench import run
from portbench.tests.conftest import SCALE, SEEDS, SMALL_PARAMS

CPU = torch.device("cpu")
CONFIGS = ("tpch_sf10", "ssb_sf20")


def _queries():
    spec = run.spec()
    out = []
    for w in spec["workloads"]:
        for q in run.mix(w["config"], w["traffic"])["queries"]:
            out.append((w["config"], q["query"],
                        SMALL_PARAMS.get(q["query"], q.get("params", {}))))
    return out


def _tables(config, seed):
    return run.module("data", config).generate(run.config(config), seed, CPU,
                                               SCALE[config])


def _traced_path(monkeypatch):
    """Record every sort, band probe and merge probe the port runs, with
    its sizes, and top_k's branch."""
    path = []

    def wrap(mod, name, describe):
        fn = getattr(mod, name)

        def recorded(*a, **k):
            path.append((name, describe(*a, **k)))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, recorded)

    wrap(psort, "sort_i32_cols", lambda cols, num_keys=None, **k: (
        len(cols), cols[0].shape[0], num_keys))
    wrap(bandprobe, "probe_direct", lambda b, v, p: (b[0].numel(),
                                                      p[0].numel()))
    wrap(bandprobe, "probe_banded_sorted", lambda b, v, p, **k: (
        b[0].numel(), p[0].numel()))
    wrap(join, "_merge_rank", lambda b, v, p, sorted_output=False: (
        b[0].numel(), p[0].numel()))
    return path


@pytest.mark.parametrize("config", CONFIGS)
def test_table_shapes_equal_across_seeds(config):
    shapes = [{t: {c: tuple(v.shape) for c, v in cols.items()}
               for t, cols in _tables(config, s).items()} for s in SEEDS]
    assert shapes[0] == shapes[1] == shapes[2]


@pytest.mark.parametrize("config,query,params", _queries())
def test_same_counts_and_path_every_seed(config, query, params, monkeypatch):
    plan = run.module("plans", query)
    ref = run.module("reference", query)
    spans = run.Spans(False)
    counts, paths, branches, answers = [], [], [], []
    for seed in SEEDS:
        t = _tables(config, seed)
        path = _traced_path(monkeypatch)
        got = run.to_host(plan.run(t, params, spans))
        monkeypatch.undo()
        want = run.to_host(ref.answer(t, params))
        assert got["counts"] == want["counts"]
        counts.append(got["counts"])
        paths.append(path)
        branches.append(topk.last_branch if query == "tpch_q18" else None)
        answers.append(json.dumps([c.tolist() for c in got["rows"]]))
    assert counts[0] == counts[1] == counts[2]
    assert paths[0] == paths[1] == paths[2]
    assert branches[0] == branches[1] == branches[2]
    assert len(set(answers)) == len(SEEDS), "the seed left the answer alone"
    assert all(v > 0 for v in counts[0].values()), counts[0]


def test_ssb_histograms_exact():
    t = _tables("ssb_sf20", SEEDS[2])
    lo, part, supp = t["lineorder"], t["part"], t["supplier"]
    n_lo = lo["lo_partkey"].numel()
    assert n_lo == 120 * part["p_partkey"].numel() \
        == 3000 * supp["s_suppkey"].numel()
    assert set(torch.bincount(lo["lo_partkey"]).tolist()) == {120}
    assert set(torch.bincount(lo["lo_suppkey"]).tolist()) == {3000}
    assert torch.equal(torch.sort(part["p_partkey"]).values,
                       torch.arange(part["p_partkey"].numel(),
                                    dtype=torch.int32))


def test_tpch_lines_per_order_mean_four():
    t = _tables("tpch_sf10", SEEDS[0])
    n_orders = t["orders"]["o_orderkey"].numel()
    lines = torch.bincount(t["lineitem"]["l_orderkey"], minlength=n_orders)
    assert t["lineitem"]["l_orderkey"].numel() == 4 * n_orders
    assert lines.min() == 1 and lines.max() == 7
    # every ordering customer (custkey % 3 != 0 before relabelling) holds
    # the same number of orders within one
    per_cust = torch.bincount(t["orders"]["o_custkey"],
                              minlength=t["customer"]["c_custkey"].numel())
    held = per_cust[per_cust > 0]
    assert held.max() - held.min() <= 1


@pytest.mark.parametrize("config", CONFIGS)
def test_every_table_and_column_of_the_spec(config):
    from portbench.data import common as c
    cfg = run.config(config)
    t = _tables(config, SEEDS[1])
    assert list(t) == list(cfg["tables"])
    for name, spec in cfg["tables"].items():
        assert list(t[name]) == list(spec["columns"]), name
        n = c.rows(cfg, name, SCALE[config])
        for col, s in spec["columns"].items():
            v = t[name][col]
            assert ("made" in s) != ("draw" in s), (name, col)
            if s["type"] == "char":
                assert v.dtype == torch.uint8 and v.shape == (n, s["width"])
            else:
                assert v.dtype == getattr(torch, s["type"])
                assert v.shape == (n,), (name, col)
    held = sum(v.numel() * v.element_size() for cols in t.values()
               for v in cols.values())
    assert held == c.resident_bytes(cfg, SCALE[config])
    assert cfg["resident_bytes"] == c.resident_bytes(cfg)


def test_tpch_derived_columns():
    t = _tables("tpch_sf10", SEEDS[2])
    li, o, ps = t["lineitem"], t["orders"], t["partsupp"]
    n_orders = o["o_orderkey"].numel()
    lines = torch.bincount(li["l_orderkey"], minlength=n_orders)
    top = torch.zeros(n_orders, dtype=torch.int32).scatter_reduce_(
        0, li["l_orderkey"].long(), li["l_linenumber"], "amax")
    assert torch.equal(top, lines.to(torch.int32))
    assert bool((li["l_receiptdate"] > li["l_shipdate"]).all())
    n_open = torch.bincount(li["l_orderkey"], weights=li["l_linestatus"].double(),
                            minlength=n_orders)[o["o_orderkey"].long()]
    want = torch.where(n_open == 0, ord("F"), torch.where(
        n_open == lines[o["o_orderkey"].long()], ord("O"), ord("P")))
    assert torch.equal(o["o_orderstatus"][:, 0].long(), want.long())
    pairs = ps["ps_partkey"].long() * 10 ** 6 + ps["ps_suppkey"].long()
    assert torch.unique(pairs).numel() == pairs.numel()
    assert set(torch.bincount(ps["ps_partkey"]).tolist()) == {4}
