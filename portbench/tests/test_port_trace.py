"""The readers of the port's own spans (portbench/port_trace.py) on
synthetic traces: kernels go to the innermost port span, idle counts only
under an outermost operator span, the padding share and the counts are
exact, the harness's own per-layer call hands the readers the port's
summary, and every key of `trace.aggregate` reads the same with the port's
spans mixed in."""

import random

import pytest

from portbench import port_trace as pt
from portbench import run
from portbench import trace as tr

OLD = ("queries", "window_s", "busy_s", "kernels", "unattributed",
       "layer_s", "kernel_s", "gaps", "busy_s_per_card")
NEW = ("sort_ms", "sort_pad_pct", "port_syncs_per_query",
       "join_fallbacks_per_query", "port_idle_pct", "port_host_ms")


def _events(spans, kernels):
    """spans: (kind, name, start, end), each with a correlation id of its
    own, as the profiler gives host ops; kernels: (start, end, launch
    time), each launched by a runtime call."""
    ev, corr = [], 0
    for kind, name, s, e in spans:
        corr += 1
        ev.append(tr.Event(kind, name, s, e, corr))
    for s, e, launch in kernels:
        corr += 1
        ev.append(tr.Event("launch", "cudaLaunchKernel", launch, launch + 1,
                           corr))
        ev.append(tr.Event("kernel", "k", s, e, corr))
    return ev


def _read(events):
    """The new metrics as the harness reads them: from the aggregate, with
    the summary of the events it was made from under "port"."""
    agg = tr.aggregate(events)
    agg["port"] = pt.summarize(events)
    return {m: run.metric(m).read(agg) for m in NEW}


# One query: a GROUP BY whose sort pads 3 rows to 4, then a join that reads
# the band flag, overflows and sorts again in the merge fallback, then
# glue. Times in ns.
Q = [("query", "pb.q:q", 0, 10_000),
     ("op", "pb.op:groupby", 90, 5100),
     ("cpu", "clo.op:groupby", 100, 5000),
     ("cpu", "clo.sort n=3 padded=4 cols=2", 200, 3000),
     ("op", "pb.op:join", 5900, 9100),
     ("cpu", "clo.op:join", 6000, 9000),
     ("cpu", "clo.sync:band_overflow", 7000, 7100),
     ("cpu", "clo.join:fallback", 7200, 8800),
     ("cpu", "clo.sort n=1000 padded=1024 cols=3", 7300, 8000)]


class _Plan:
    """A plan that names no bytes for the rooflines."""

    @staticmethod
    def work(sizes, counts, params):
        return []


def test_the_harness_per_layer_call_reads_the_new_metrics():
    kernels = [(300, 400, 150), (400, 600, 250), (8600, 8700, 8500)]
    got, _ = run._per_layer("tpch_sf10.q18_groupby", _events(Q, kernels),
                            [("q", {}, _Plan())], {}, {"q": {"counts": {}}})
    assert {m: got[m]["value"] for m in NEW} == pytest.approx(
        {"sort_ms": 200e-6, "sort_pad_pct": 100.0 * 25 / 1028,
         "port_syncs_per_query": 1.0, "join_fallbacks_per_query": 1.0,
         # idle under the ops: 4900 - 300 ns of 100-5000, 3000 - 100 of
         # 6000-9000, in a 10,000 ns window
         "port_idle_pct": 75.0, "port_host_ms": 7800e-6})
    # the program before its spans: the new metrics are left out
    parent = [s for s in Q if not s[1].startswith(pt.PREFIX)]
    got, _ = run._per_layer("tpch_sf10.q18_groupby",
                            _events(parent, kernels),
                            [("q", {}, _Plan())], {}, {"q": {"counts": {}}})
    assert not set(NEW) & set(got)


def test_no_events_beside_the_aggregate_read_nothing():
    agg = tr.aggregate(_events(Q, []))
    assert pt.of(agg) is None
    assert {m: run.metric(m).read(tr.aggregate(_events(Q, [])))
            for m in NEW} == {m: None for m in NEW}
    events = _events(Q, [])
    agg = tr.aggregate(events)
    # the events beside it in this frame are not searched for
    assert pt.of(agg) is None
    agg["port"] = pt.summarize(events)
    assert pt.of(agg)["sorts"] == 2


def test_kernels_go_to_the_innermost_span():
    kernels = [(300, 400, 150),       # clo.op:groupby
               (400, 600, 250),       # clo.sort in the GROUP BY
               (600, 700, 3500),      # clo.op:groupby, after its sort
               (7300, 7310, 7050),    # clo.sync
               (7400, 7600, 7400),    # clo.sort in the fallback
               (8600, 8700, 8500),    # clo.join:fallback
               (9500, 9600, 9500)]    # glue: no port span
    port = pt.summarize(_events(Q, kernels))
    assert port["kind_s"] == pytest.approx({
        "op:groupby": 200e-9, "sort": 400e-9, "sync:band_overflow": 10e-9,
        "join:fallback": 100e-9})
    assert port["ops"] == {"groupby": 1, "join": 1}


def test_idle_only_under_an_outermost_operator_span():
    # busy 0-1000, 4000-6500, 8000-10000: idle 1000-4000 (in groupby),
    # 6500-8000 (in join, its sync and fallback included once)
    kernels = [(0, 1000, 10), (4000, 6500, 20), (8000, 10_000, 30)]
    events = _events(Q, kernels)
    agg = tr.aggregate(events)
    agg["port"] = pt.summarize(events)
    assert pt.summarize(events)["idle_s"] == pytest.approx(4500e-9)
    assert run.metric("port_idle_pct").read(agg) == pytest.approx(45.0)
    assert run.metric("device_idle_pct").read(agg) == pytest.approx(45.0)
    # idle outside any operator span (the glue after 9000) is not the port's
    kernels = [(0, 9000, 10)]
    events = _events(Q, kernels)
    agg = tr.aggregate(events)
    assert pt.summarize(events)["idle_s"] == 0
    assert run.metric("device_idle_pct").read(agg) == pytest.approx(10.0)


def test_pad_share_counts_and_host_time_exact():
    got = _read(_events(Q, [(0, 10, 5)]))
    # (4 - 3) + (1024 - 1000) pad rows of 4 + 1024 slots
    assert got["sort_pad_pct"] == 100.0 * 25 / 1028
    assert got["port_syncs_per_query"] == 1.0
    assert got["join_fallbacks_per_query"] == 1.0
    # 4900 ns of GROUP BY, 3000 ns of join less its 100 ns host read
    assert got["port_host_ms"] == pytest.approx(7800e-6)
    assert got["sort_ms"] == 0.0     # sorts ran; no kernel under them

    # the TPC-H Q1 sort: 60M rows padded to 2^26
    one = [("query", "pb.q:q1", 0, 100),
           ("cpu", "clo.op:groupby", 1, 99),
           ("cpu", f"clo.sort n=60000000 padded={2 ** 26} cols=2", 2, 98)]
    got = _read(_events(one, []))
    assert got["sort_pad_pct"] == pytest.approx(100 * (1 - 60e6 / 2 ** 26))
    assert got["port_syncs_per_query"] == 0.0      # no read: 0.0, not None
    assert got["join_fallbacks_per_query"] is None  # no join ran


def test_counts_read_zero_when_absent_and_nothing_without_spans():
    plain = [s for s in Q if not s[1].startswith(("clo.sync",
                                                  "clo.join:fallback"))]
    got = _read(_events(plain, [(0, 10, 5)]))
    assert got["port_syncs_per_query"] == 0.0
    assert got["join_fallbacks_per_query"] == 0.0
    # a program without the port's spans: every new reader finds nothing
    parent = [s for s in Q if not s[1].startswith(pt.PREFIX)]
    assert _read(_events(parent, [(0, 10, 5)])) == {
        m: None for m in NEW}


def test_spans_outside_the_queries_are_not_counted():
    ev = Q + [("cpu", "clo.op:join", 20_000, 21_000),
              ("cpu", "clo.sync:band_overflow", 20_100, 20_200)]
    port = pt.summarize(_events(ev, [(0, 10, 5)]))
    assert port["ops"] == {"groupby": 1, "join": 1} and port["syncs"] == 1


def _nested_ports(rng):
    """A random trace whose port spans nest inside the plan spans."""
    spans, kernels, ports, t = [], [], [], 0
    for q in range(rng.randint(1, 4)):
        q0 = t
        t += rng.randint(1, 50)
        for layer in rng.sample(("groupby", "filter", "join", "topk"), 3):
            o0, t = t, t + rng.randint(1, 50)
            c0 = t
            for _ in range(rng.randint(0, 3)):
                s0 = t + rng.randint(1, 20)
                s1 = s0 + rng.randint(5, 200)
                n = rng.randint(1, 5000)
                ports.append(("cpu", f"clo.sort n={n} padded="
                              f"{1 << (n - 1).bit_length()} cols=2", s0, s1))
                for _ in range(rng.randint(0, 4)):
                    launch = rng.randint(s0, s1)
                    k0 = launch + rng.randint(0, 300)
                    kernels.append((k0, k0 + rng.randint(1, 300), launch))
                t = s1
            t += rng.randint(1, 50)
            ports.append(("cpu", "clo.op:" + layer, c0, t))
            if layer == "join" and rng.random() < 0.5:
                ports.append(("cpu", "clo.sync:band_overflow", t - 1, t))
            spans.append(("op", "pb.op:" + layer, o0, t + 10))
            t += 20
        for _ in range(rng.randint(0, 3)):
            launch = rng.randint(q0, t)
            kernels.append((launch + 5, launch + 50, launch))
        spans.append(("query", f"pb.q:q{q}", q0, t))
        t += rng.randint(1, 100)
    return spans, ports, kernels


@pytest.mark.parametrize("seed", range(20))
def test_the_port_spans_leave_every_old_key_alone(seed):
    rng = random.Random(seed)
    spans, ports, kernels = _nested_ports(rng)
    before = tr.aggregate(_events(spans, kernels))
    mixed = spans + ports
    rng.shuffle(mixed)
    after = tr.aggregate(_events(mixed, kernels))
    assert set(after) == set(OLD)
    for key in OLD:
        assert after[key] == before[key], key
    assert pt.summarize(_events(mixed, kernels))["sorts"] == sum(p[1].startswith("clo.sort")
                                         for p in ports)
