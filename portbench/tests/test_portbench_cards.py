"""A cell on several cards: its devices, the rows of tables held one shard
per device, each card's memory, and each card's busy and idle time from
the trace. A four-position cell that exists only here (a toy table, one
shard per position, grouped through the mesh's exchange by
`parallel.dist_group_aggregate_cols`) runs through `run.run_cell` on four
CPU positions, and on the card in the test marked `cuda`. With one card
every number reads as the one-card arithmetic below gives it, to the
digit."""

import copy
import random

import pytest
import torch

from cl_ops_tpu_torch import parallel
from cl_ops_tpu_torch.parallel.mesh import Sharded
from portbench import port_trace as pt
from portbench import roofline as rf
from portbench import run
from portbench import trace as tr
from portbench.reference.common import group_sum
from portbench.tests import test_port_trace as tpt
from portbench.tests import test_portbench_metrics as tpm

# --- the four-position test cell ---------------------------------------------

CELL = "toy_mesh4.groupby_exchange"
CONFIG = {"name": "toy_mesh4", "rows_per_shard": 4096, "groups": 256}
MIX = {"fact_table": "fact", "queries": [{"query": "toy_groupby"}]}
METRICS = ("op_ms.groupby", "groupby_roofline", "launches_per_query",
           "device_idle_pct", "sort_ms", "sort_pad_pct")


class _Data:
    @staticmethod
    def generate(cfg, seed, devices, scale=1.0):
        """Keys and values, one shard per device, from the seed."""
        n = int(cfg["rows_per_shard"] * scale)
        k, v = [], []
        for i, d in enumerate(devices):
            g = torch.Generator(device=d)
            g.manual_seed(seed * len(devices) + i)
            k.append(torch.randint(0, cfg["groups"], (n,), generator=g,
                                   device=d, dtype=torch.int32))
            v.append(torch.randint(0, 1000, (n,), generator=g, device=d,
                                   dtype=torch.int64))
        return {"fact": {"k": k, "v": v}}


class _Plan:
    @staticmethod
    def run(t, params, span):
        """SELECT k, sum(v), count(*) GROUP BY k ORDER BY k, the rows
        exchanged between positions by key."""
        k, v = t["fact"]["k"], t["fact"]["v"]
        mesh = parallel.make_mesh(devices=[s.device for s in k])
        vals = Sharded(mesh, v)
        with span("groupby"):
            gk, (sums, cnts), n = parallel.dist_group_aggregate_cols(
                Sharded(mesh, k), (vals, vals), ("sum", "count"), mesh,
                num_groups=CONFIG["groups"], capacity=2 * k[0].shape[0])
        per = n.numpy()
        dev = k[0].device

        def gathered(x):
            return torch.cat([s[:m].to(dev, torch.int64)
                              for s, m in zip(x.shards, per)])
        keys = gathered(gk)
        order = torch.argsort(keys)
        return {"rows": [keys[order], gathered(sums)[order],
                         gathered(cnts)[order]],
                "counts": {"groups": int(per.sum())}}

    @staticmethod
    def work(sizes, counts, params):
        return [("groupby", rf.groupby_bytes(sizes["fact"], 4, [8],
                                             counts["groups"], [8, 8]))]


class _Reference:
    @staticmethod
    def answer(t, params, exact=True):
        dev = t["fact"]["k"][0].device
        k, v = (torch.cat([s.to(dev) for s in t["fact"][c]])
                for c in ("k", "v"))
        keys, sums, n = group_sum(k.long(), [v], torch.int64)
        return {"rows": [keys, sums[0], n],
                "counts": {"groups": keys.numel()}}


@pytest.fixture
def toy_cell(monkeypatch):
    """The test cell beside BENCHMARK.json's, found by name through the
    harness's own lookups; the table sizes it counted, kept."""
    spec = copy.deepcopy(run.spec())
    spec["workloads"].append({"name": CELL, "config": CONFIG["name"],
                              "traffic": "groupby_exchange", "chips": 4,
                              "why": "test double"})
    for m in spec["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(CELL)
    doubles = {("data", "toy_mesh4"): _Data, ("plans", "toy_groupby"): _Plan,
               ("reference", "toy_groupby"): _Reference}
    module, sizes = run.module, []

    def table_sizes(tables, _orig=run.table_sizes):
        sizes.append(_orig(tables))
        return sizes[-1]
    monkeypatch.setattr(run, "spec", lambda: spec)
    monkeypatch.setattr(run, "config", lambda name: dict(CONFIG))
    monkeypatch.setattr(run, "mix", lambda c, t: copy.deepcopy(MIX))
    monkeypatch.setattr(run, "module",
                        lambda kind, name: doubles.get((kind, name))
                        or module(kind, name))
    monkeypatch.setattr(run, "table_sizes", table_sizes)
    return sizes


@pytest.mark.parametrize("trace", [False, True])
def test_four_position_cell_on_the_cpu(toy_cell, trace):
    out = run.run_cell(CELL, 2 ** 31 + 7, 0.01, trace, devices=["cpu"] * 4)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 4
    # the fact table's rows: every shard's, so mrows_s counts them all
    assert toy_cell == [{"fact": 4 * CONFIG["rows_per_shard"]}]
    assert out["device"]["memory_peak_bytes"] == 0
    assert out["device"]["memory_peak_bytes_per_card"] == []
    if trace:
        # four positions of the one CPU: one device, idle throughout
        assert out["device"]["busy_s_per_card"] == [0.0]
        assert out["metrics"]["device_idle_pct"]["value"] == 100.0
        assert out["metrics"]["sort_pad_pct"]["value"] >= 0.0
    else:
        assert set(out["metrics"]) == set(run.E2E)
        assert out["metrics"]["mrows_s"]["value"] > 0
        assert out["metrics"]["query_mem_gib"]["value"] == 0


@pytest.mark.cuda
def test_four_position_cell_on_the_card(toy_cell, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    layouts = [["cuda:0"] * 4]
    if torch.cuda.device_count() >= 4:
        layouts.append([f"cuda:{i}" for i in range(4)])
    for devices in layouts:
        n_cards = len(set(devices))
        for trace in (False, True):
            out = run.run_cell(CELL, 2 ** 31 + 11, 2.0, trace,
                               devices=devices, scale=1024.0)
            with capsys.disabled():
                print(f"\ntoy cell on {devices}, trace {int(trace)}: {out}")
            assert out["correct"], out["checks"]
            assert out["device"]["count"] == 4
            per_card = out["device"]["memory_peak_bytes_per_card"]
            assert len(per_card) == n_cards and min(per_card) > 0
            assert out["device"]["memory_peak_bytes"] == max(per_card)
            if trace:
                busy = out["device"]["busy_s_per_card"]
                assert len(busy) == n_cards and min(busy) > 0
                assert out["device"]["busy_s"] == pytest.approx(
                    sum(busy) / n_cards)
                share = out["metrics"].get("groupby_roofline")
                assert share is None or 0 < share["value"] <= 100
            else:
                assert out["metrics"]["query_mem_gib"]["value"] > 0


def test_rows_of_tables_held_one_shard_per_device():
    a, b = torch.zeros(5), torch.zeros(7)
    mesh = parallel.make_mesh(devices=["cpu"] * 2)
    assert run.table_sizes({"t": {"c": a}}) == {"t": 5}
    assert run.table_sizes({"t": {"c": [a, b]}, "u": {"c": (b, b, b)},
                            "v": {"c": Sharded(mesh, [a, b])}}) == {
        "t": 12, "u": 21, "v": 12}


def test_the_cell_devices():
    one, four = {"chips": 1}, {"chips": 4}
    assert run.cell_devices(one) == [torch.device("cuda")]
    assert run.cell_devices(one, "cpu") == [torch.device("cpu")]
    assert run.cell_devices(four) == [torch.device("cuda", i)
                                      for i in range(4)]
    assert run.cell_devices(four, devices=["cpu"] * 4) == \
        [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        run.cell_devices(four, devices=["cpu"])


def test_one_device_gets_the_generator_as_before(monkeypatch):
    seen = []

    class Gen:
        @staticmethod
        def generate(cfg, seed, device, scale):
            seen.append(device)
            return {}
    monkeypatch.setattr(run, "module", lambda kind, name: Gen)
    run.make_tables("c", {}, 1, [torch.device("cpu")])
    run.make_tables("c", {}, 1, [torch.device("cpu")] * 2)
    assert seen == [torch.device("cpu"), [torch.device("cpu")] * 2]


# --- memory, per card ---------------------------------------------------------

@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda's memory API and synchronize over fake cards: {index:
    [allocated, peak]}, and the calls made."""
    state, calls = {}, []

    def idx(d):
        return torch.device(d).index

    def synchronize(d):
        calls.append(("sync", idx(d)))

    def reset(d):
        calls.append(("reset", idx(d)))
        state[idx(d)][1] = state[idx(d)][0]
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda d: state[idx(d)][0])
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: state[idx(d)][1])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    return state, calls


def _read_memory(cards, state, resident, setup_peak, window_peak):
    """Set-up, reset and window as run_cell reads them."""
    for i, r in enumerate(resident):
        state[i] = [r, setup_peak[i]]
    res, setup = cards.allocated(), cards.peaks()
    cards.reset_peaks()
    for i, p in enumerate(window_peak):
        state[i][1] = p
    return run.memory(res, setup, cards.peaks())


def test_memory_of_two_cards(fake_cards):
    state, calls = fake_cards
    cards = run.Cards([torch.device("cuda", 0), torch.device("cuda", 1)])
    work, fullest, per_card = _read_memory(
        cards, state, resident=[10, 20], setup_peak=[50, 40],
        window_peak=[30, 95])
    # card 0 works 20 bytes, card 1 75: the larger; card 1 is the fullest
    assert (work, fullest, per_card) == (75, 95, [50, 95])
    assert ("reset", 0) in calls and ("reset", 1) in calls
    cards.sync()
    assert calls[-2:] == [("sync", 0), ("sync", 1)]
    # a card whose set-up peak is its highest
    work, fullest, per_card = _read_memory(
        cards, state, resident=[10, 20], setup_peak=[500, 40],
        window_peak=[30, 35])
    assert (work, fullest, per_card) == (20, 500, [500, 40])


def test_memory_of_one_card_is_as_before(fake_cards):
    state, _ = fake_cards
    for resident, setup_peak, peak in [(100, 700, 400), (100, 300, 900),
                                       (5, 5, 5)]:
        cards = run.Cards([torch.device("cuda", 0)])
        got = _read_memory(cards, state, [resident], [setup_peak], [peak])
        assert got == (peak - resident, max(setup_peak, peak),
                       [max(setup_peak, peak)])
    # four positions of one card: one card; the CPU: none
    assert run.Cards([torch.device("cuda", 0)] * 4).cards == \
        [torch.device("cuda", 0)]
    cpu = run.Cards([torch.device("cpu")] * 4)
    assert cpu.cards == [] and run.memory(cpu.allocated(), cpu.peaks(),
                                          cpu.peaks()) == (0, 0, [])


# --- busy and idle, per card --------------------------------------------------

def _on(events, cards):
    """Each kernel and device event put on cards[i] (i: its order)."""
    out, i = [], 0
    for e in events:
        if e.kind in ("kernel", "device"):
            e = tr.Event(e.kind, e.name, e.start, e.end, e.corr, e.linked,
                         cards[i % len(cards)])
            i += 1
        out.append(e)
    return out


SPANS = [("query", "pb.q:q", 0, 1000), ("op", "pb.op:groupby", 0, 1000)]


def test_two_cards_union_per_card():
    # card 0 busy 0-600, card 1 busy 200-1000: one union would read 1000
    ev = _on(tpm._events(SPANS, [("a", 0, 600, 1, None),
                                 ("b", 200, 1000, 2, None)]), [0, 1])
    agg = tr.aggregate(ev, 2)
    assert agg["busy_s_per_card"] == pytest.approx([600e-9, 800e-9])
    assert agg["busy_s"] == pytest.approx(700e-9)
    assert run.metric("device_idle_pct").read(agg) == pytest.approx(30.0)
    # device seconds are summed over the cards
    assert agg["layer_s"] == pytest.approx({"groupby": 1400e-9})
    # idle gaps per card, summed under one label
    assert agg["gaps"] == pytest.approx({"q/groupby": 600e-9})
    assert tr.aggregate(ev)["busy_s"] == pytest.approx(1000e-9)


@pytest.mark.parametrize("busy_end", [1000, 400])
def test_four_cards_an_idle_card_counts(busy_end):
    ev = tpm._events(SPANS, [("a", 0, busy_end, 1, None)])
    agg = tr.aggregate(ev, 4)
    assert agg["busy_s_per_card"] == pytest.approx([busy_end * 1e-9, 0, 0,
                                                    0])
    idle = run.metric("device_idle_pct").read(agg)
    assert idle >= 75.0
    assert idle == pytest.approx(100 - 25 * busy_end / 1000)


def test_port_idle_per_card():
    # tpt.Q's outermost op spans hold 100-5000 and 6000-9000 (7900 ns of
    # 10,000); card 0 busy 0-1000, 4000-6500, 8000-10000 idles 4500 ns of
    # them, the three idle cards 7900 each
    kernels = [(0, 1000, 10), (4000, 6500, 20), (8000, 10_000, 30)]
    ev = tpt._events(tpt.Q, kernels)
    assert pt.summarize(ev)["idle_s"] == pytest.approx(4500e-9)
    four = pt.summarize(ev, 4)
    assert four["idle_s"] == pytest.approx((4500 + 3 * 7900) / 4 * 1e-9)
    agg = tr.aggregate(ev, 4)
    agg["port"] = four
    assert run.metric("port_idle_pct").read(agg) == pytest.approx(
        (4500 + 3 * 7900) / 4 / 100)
    # spread over two cards: each idles where it ran nothing
    two = pt.summarize(_on(ev, [0, 1]), 2)
    # card 0: 0-1000, 8000-10000; card 1: 4000-6500
    card0 = (5000 - 1000) + (8000 - 6000)
    card1 = (4000 - 100) + (9000 - 6500)
    assert two["idle_s"] == pytest.approx((card0 + card1) / 2 * 1e-9)


def test_a_device_event_off_the_cells_cards_is_refused():
    ev = _on(tpm._events(SPANS, [("a", 0, 10, 1, None)]), [2])
    with pytest.raises(ValueError, match="card 2"):
        tr.aggregate(ev, 2)
    tr.aggregate(ev)          # one card: every device event is its


class _KinetoEvent:
    def __init__(self, name, act, device_type, index):
        self._v = (name, act, device_type, index)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def device_index(self):
        return self._v[3]

    def start_ns(self):
        return 1

    def end_ns(self):
        return 2

    def correlation_id(self):
        return 3

    def linked_correlation_id(self):
        return 0


def test_device_events_carry_their_card():
    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [
                        _KinetoEvent("pb.q:q", "cpu_op", "DeviceType.CPU",
                                     4242),
                        _KinetoEvent("k", "kernel", "DeviceType.CUDA", 3),
                        _KinetoEvent("Memcpy", "gpu_memcpy",
                                     "DeviceType.CUDA", 1)]
    got = [(e.kind, e.device) for e in tr.from_profiler(Prof)]
    assert got == [("query", 0), ("kernel", 3), ("device", 1)]


# --- one card: the numbers of the one-union arithmetic, to the digit ---------

def _one_card_aggregate(events):
    """`trace.aggregate` as it read before cells of several cards: one
    union of every device event."""
    queries = [e for e in events if e.kind == "query"]
    qspans = tr._Intervals((e.start, e.end, e.name[len(tr.QUERY):])
                           for e in queries)
    ospans = tr._Intervals((e.start, e.end, e.name[len(tr.OP):])
                           for e in events if e.kind == "op")
    w0, w1 = min(e.start for e in queries), max(e.end for e in queries)
    launch_at = {e.corr: e.start for e in events if e.kind == "launch"}
    op_at = {e.corr: e.start for e in events
             if e.kind in ("cpu", "op", "query")}
    layer_s, kernel_s = {}, {}
    kernels = unattributed = 0
    for k in events:
        if k.kind != "kernel":
            continue
        t = launch_at.get(k.corr, op_at.get(k.linked))
        if t is None or qspans.at(t) is None:
            unattributed += t is None
            continue
        layer = ospans.at(t) or tr.GLUE
        dur = (k.end - k.start) * 1e-9
        layer_s[layer] = layer_s.get(layer, 0.0) + dur
        name = tr.short(k.name)
        kernel_s[name] = kernel_s.get(name, 0.0) + dur
        kernels += 1
    busy = tr.union((max(e.start, w0), min(e.end, w1)) for e in events
                    if e.kind in ("kernel", "device")
                    and e.end > w0 and e.start < w1)
    gaps = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            q = qspans.at(g0)
            label = f"{q}/{ospans.at(g0) or tr.GLUE}" if q \
                else "between_queries"
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    return {"queries": len(queries), "window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": kernels, "unattributed": unattributed,
            "layer_s": layer_s, "kernel_s": kernel_s, "gaps": gaps}


def _one_card_port_idle(events):
    """`port_trace.summarize`'s idle_s as it read before: device idle
    under one union, inside the outermost clo.op spans that start in a
    query."""
    queries = sorted((e.start, e.end) for e in events if e.kind == "query")
    w0, w1 = queries[0][0], max(q[1] for q in queries)
    busy = tr.union((max(e.start, w0), min(e.end, w1)) for e in events
                    if e.kind in ("kernel", "device")
                    and e.end > w0 and e.start < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans, parent = pt.nest(events)
    kinds = [pt.kind(s.name) for s in spans]
    held = []
    for i, s in enumerate(spans):
        if not kinds[i].startswith("op:") or not any(
                a <= s.start <= b for a, b in queries):
            continue
        j = parent[i]
        while j >= 0 and not kinds[j].startswith("op:"):
            j = parent[j]
        if j < 0:
            held.append((max(s.start, w0), min(s.end, w1)))
    return pt.overlap(idle, held) * 1e-9


def _fixtures():
    """The traces of test_port_trace.py and test_portbench_metrics.py."""
    q = {"Q kernels": [(300, 400, 150), (400, 600, 250), (8600, 8700, 8500)],
         "Q spans": [(300, 400, 150), (400, 600, 250), (600, 700, 3500),
                     (7300, 7310, 7050), (7400, 7600, 7400),
                     (8600, 8700, 8500), (9500, 9600, 9500)],
         "Q idle": [(0, 1000, 10), (4000, 6500, 20), (8000, 10_000, 30)],
         "Q glue": [(0, 9000, 10)], "Q one": [(0, 10, 5)]}
    out = {name: tpt._events(tpt.Q, k) for name, k in q.items()}
    out["Q plain"] = tpt._events(
        [s for s in tpt.Q if not s[1].startswith(("clo.sync",
                                                  "clo.join:fallback"))],
        [(0, 10, 5)])
    out["Q outside"] = tpt._events(
        tpt.Q + [("cpu", "clo.op:join", 20_000, 21_000),
                 ("cpu", "clo.sync:band_overflow", 20_100, 20_200)],
        [(0, 10, 5)])
    for seed in range(20):
        spans, ports, kernels = tpt._nested_ports(random.Random(seed))
        mixed = spans + ports
        random.Random(seed).shuffle(mixed)
        out[f"nested {seed}"] = tpt._events(mixed, kernels)
    out["metrics attributed"] = tpm._events(
        tpm.SPANS, [("k1", 310, 390, 150, None), ("k2", 500, 600, None, 350),
                    ("k3", 700, 800, 900, None)])
    out["metrics union"] = tpm._events(
        tpm.SPANS, [("a", 100, 500, 110, None), ("b", 300, 700, 120, None),
                    ("c", 650, 660, 130, None)])
    out["metrics bare"] = tpm._events(tpm.SPANS[:1],
                                      [("k", 10, 20, 5, None)])
    return out


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_one_card_reads_as_before(name):
    events = FIXTURES[name]
    want = _one_card_aggregate(events)
    # any card index reads as card 0 in a cell of one card
    on_cards = _on(events, [0, 3, 1])
    for ev in (events, on_cards):
        for got in (tr.aggregate(ev), tr.aggregate(ev, 1)):
            assert got.pop("busy_s_per_card") == [want["busy_s"]]
            assert got == want
        if any(e.kind == "query" for e in ev):
            idle = _one_card_port_idle(ev)
            assert pt.summarize(ev)["idle_s"] == idle
            assert pt.summarize(ev, 1)["idle_s"] == idle
