"""The per-layer arithmetic: byte counts from shapes and reference counts
alone, kernels attributed to spans by correlation id, rooflines at most
100% on synthetic traces, and the idle share from the interval union."""

import random

import pytest

from cl_ops_tpu_torch.ops.exec import bandprobe
from cl_ops_tpu_torch.ops.sort import bitonic_kernels
from portbench import roofline as rf
from portbench import run
from portbench import trace as tr
from portbench.tests.conftest import SMALL_PARAMS

SIZES = {"lineitem": 60_000_000, "orders": 15_000_000, "customer": 1_500_000,
         "lineorder": 120_000_000, "part": 1_000_000, "supplier": 40_000,
         "date": 2556}
COUNTS = {"tpch_q18": {"groups": 15_000_000, "having": 624, "orders": 624,
                       "customers": 624, "limit": 100},
          "tpch_q1": {"groups": 4},
          "ssb_q2_1": {"parts": 40_000, "suppliers": 8_000,
                       "part_matches": 4_800_000,
                       "supplier_matches": 24_000_000, "kept": 960_000,
                       "date_matches": 960_000, "groups": 280},
          "ssb_q1_1": {"dates": 365, "date_matches": 120_000_000,
                       "kept": 2_000_000}}


def _work(query, sizes=SIZES, counts=None):
    plan = run.module("plans", query)
    return plan.work(sizes, counts or COUNTS[query],
                     SMALL_PARAMS.get(query, {}))


@pytest.mark.parametrize("query", sorted(COUNTS))
def test_bytes_depend_on_shapes_and_counts_alone(query, monkeypatch):
    before = _work(query)
    # launch counters and the padded power of two play no part
    monkeypatch.setitem(bitonic_kernels.launches, "block_merge", 10 ** 6)
    monkeypatch.setitem(bandprobe.launches, "probe_band", 10 ** 6)
    assert _work(query) == before
    # linear in the rows, so no padding: one more fact row adds a few bytes
    fact = "lineorder" if query.startswith("ssb") else "lineitem"
    bigger = dict(SIZES, **{fact: SIZES[fact] + 1})
    grow = sum(b for _, b in _work(query, bigger)) - sum(b for _, b in before)
    assert 0 <= grow <= 64


def test_q18_bytes_by_hand():
    by_layer = {}
    for layer, b in _work("tpch_q18"):
        by_layer[layer] = by_layer.get(layer, 0) + b
    # GROUP BY: 60M rows of a 4-byte key and an 8-byte sum in, 15M groups
    # of key and sum out
    assert by_layer["groupby"] == 60_000_000 * 12 + 15_000_000 * 12 + 8
    assert by_layer["topk"] == 624 * 12 + 100 * 12


def _events(spans, kernels):
    """Synthetic trace: spans (kind, name, start, end); kernels (name,
    start, end, launch time or None, linked op start or None)."""
    ev = [tr.Event(k, n, s, e) for k, n, s, e in spans]
    corr = 1000
    for name, s, e, launch, linked in kernels:
        corr += 1
        if launch is not None:
            ev.append(tr.Event("launch", "cudaLaunchKernel", launch,
                               launch + 1, corr))
        lk = 0
        if linked is not None:
            lk = corr + 50_000
            ev.append(tr.Event("cpu", "aten::op", linked, linked + 1, lk))
        ev.append(tr.Event("kernel", name, s, e, corr, lk))
    return ev


SPANS = [("query", "pb.q:q", 0, 1000), ("op", "pb.op:filter", 100, 200),
         ("op", "pb.op:join", 300, 400)]


def test_kernels_attributed_by_launch_not_start():
    # launched in the filter span, run on the device during the join span
    ev = _events(SPANS, [("k1", 310, 390, 150, None),
                         ("k2", 500, 600, None, 350),   # linked op only
                         ("k3", 700, 800, 900, None)])  # glue
    agg = tr.aggregate(ev)
    assert agg["layer_s"] == pytest.approx({"filter": 80e-9, "join": 100e-9,
                                            "glue": 100e-9})
    assert agg["kernels"] == 3 and agg["unattributed"] == 0


def test_idle_from_the_interval_union():
    ev = _events(SPANS, [("a", 100, 500, 110, None),
                         ("b", 300, 700, 120, None),    # overlaps a
                         ("c", 650, 660, 130, None)])   # inside b
    agg = tr.aggregate(ev)
    assert agg["busy_s"] == pytest.approx(600e-9)
    assert agg["window_s"] == pytest.approx(1000e-9)
    idle = run.metric("device_idle_pct").read(agg)
    assert idle == pytest.approx(40.0)
    # a sum of kernel times would read 410 / 1000 busy: the union is 600
    assert sum(agg["layer_s"].values()) == pytest.approx(810e-9)


def test_rooflines_at_most_100_on_synthetic_traces():
    rng = random.Random(7)
    layers = ("groupby", "filter", "join")
    for _ in range(200):
        spans, kernels, bound, t = [("query", "pb.q:q", 0, 10 ** 9)], [], {}, 10
        for layer in layers:
            nbytes = rng.randint(1, 10 ** 9)
            bound[layer] = nbytes / rf.PEAK_BYTES_S
            need = int(bound[layer] * 1e9) + 1   # no kernel beats the peak
            n_k = rng.randint(1, 5)
            spans.append(("op", "pb.op:" + layer, t, t + 10))
            for i in range(n_k):
                dur = need // n_k + 1 + rng.randint(0, need)
                kernels.append((layer, t + 20 + i * dur, t + 20 + (i + 1) * dur,
                                t + 1 + i, None))
            t += 30 + (n_k + 1) * (2 * need + 2)
        agg = tr.aggregate(_events(spans, kernels))
        agg["bound_s"] = bound
        for layer in layers:
            share = run.metric(layer + "_roofline").read(agg)
            assert 0 < share <= 100.0


def test_readers_return_nothing_without_their_layer():
    agg = tr.aggregate(_events(SPANS[:1], [("k", 10, 20, 5, None)]))
    agg["bound_s"] = {}
    assert run.metric("op_ms.topk").read(agg) is None
    assert run.metric("join_roofline").read(agg) is None
    assert run.metric("glue_ms").read(agg) == pytest.approx(10e-6)
    assert run.metric("launches_per_query").read(agg) == 1
