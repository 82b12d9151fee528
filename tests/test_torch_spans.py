"""The port's own profiler spans (utils/profiling.named): none and no range
made while nothing records, and under a torch.profiler schedule, as
portbench runs it, the operator, sort, host-read and fallback spans in the
active step only, host ops rather than user annotations, nested and with
exact attributes. CPU, the port's plain kernels, small tensors."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from cl_ops_tpu_torch.ops.exec import (filter_compact, group_aggregate_cols,
                                       hash_join, hash_join_expand, top_k,
                                       topk)
from cl_ops_tpu_torch.utils import profiling
from cl_ops_tpu_torch.utils.bits import nlpo2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FILTER_N = 3000
TOPK_N = 1 << 15     # past top_k's exact-sort sizes: its fast branch reads


def _gen():
    return torch.Generator().manual_seed(20)


def _operators():
    """One call of each operator the benchmark's plans make, the banded
    join with unique and with repeated build keys, the merge join, the
    expansion, and top_k's fast branch."""
    g = _gen()
    x = torch.randint(0, 40, (FILTER_N,), dtype=torch.int32, generator=g)
    filter_compact(x, lambda d: d > 25, x)
    group_aggregate_cols(x, (x.to(torch.int64),), ("sum",), num_groups=64)
    build = torch.randperm(2000, generator=g).to(torch.int32)
    probe = torch.randint(0, 2000, (4000,), dtype=torch.int32, generator=g)
    hash_join(build, build, probe, probe_impl="banded")
    hash_join(build // 2, build, probe, probe_impl="banded",
              unique_build=False)
    hash_join(build, build, probe, probe_impl="merge")   # no fallback
    hash_join_expand(build // 2, build, probe, capacity=8192)
    # the smallest values spread over the 1024-row blocks, a few a block,
    # so the threshold extraction holds them and its check passes
    pos = torch.arange(TOPK_N, dtype=torch.int32)
    top_k((pos % 1024) * 32 + pos // 1024, 10)
    assert topk.last_branch == "fast"


def _overflowing_join(probe_impl):
    """A build of 100K keys probed by 1,000 keys spread over all of it:
    one probe block spans more build rows than a band window holds."""
    build = torch.arange(100_000, dtype=torch.int32) * 7
    probe = torch.randint(0, 100_000, (1000,), dtype=torch.int32,
                          generator=_gen()) * 7
    return hash_join(build, build, probe, build_sorted=True,
                     probe_impl=probe_impl)


def test_nothing_records_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range made with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    assert not torch.autograd._profiler_enabled()
    _operators()
    _overflowing_join("banded")


def test_off_path_is_one_shared_context():
    assert profiling.named("clo.op:join") is profiling.named(
        "clo.sort", n=5, padded=8, cols=2)
    with profiling.named("clo.op:join") as entered:
        assert entered is None


@pytest.fixture(scope="module")
def traced():
    """Two profiler steps: warm-up, running a filter and a banded join,
    then active, running the operators and the overflowing join. Returns
    the ranges made in each step, the active step's port spans as (kind,
    attrs, start, end), their profiler activity types, and both joins'
    results."""
    calls = {"warmup": 0, "active": 0}
    spans, types = [], set()
    real = profiling._range

    def keep(p):
        for e in p.profiler.kineto_results.events():
            if e.name().startswith("clo."):
                if hasattr(e, "activity_type"):
                    types.add(e.activity_type())
                name, *kv = e.name().split()
                spans.append((name[len("clo."):],
                              {k: int(v) for k, v in
                               (a.split("=") for a in kv)},
                              e.start_ns(), e.end_ns()))

    def run_step(step, work):
        def counted(*args, **kwargs):
            calls[step] += 1
            return real(*args, **kwargs)
        profiling._range = counted
        try:
            return work()
        finally:
            profiling._range = real

    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=keep)
    def warmup():
        x = torch.arange(FILTER_N, dtype=torch.int32)
        filter_compact(x, lambda d: d % 3 == 0)
        hash_join(x, x, x.flip(0), probe_impl="banded")

    prof.start()
    run_step("warmup", warmup)
    prof.step()

    def active():
        _operators()
        return _overflowing_join("banded")
    banded = run_step("active", active)
    prof.step()
    prof.stop()
    spans.sort(key=lambda s: (s[2], -s[3]))
    return {"calls": calls, "spans": spans, "types": types, "banded": banded,
            "merge": _overflowing_join("merge")}


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _ops(spans):
    return [s for s in spans if s[0].startswith("op:")]


def _within(spans, op):
    return [s for s in spans if s is not op and _inside(s, op)]


def test_warmup_step_records_no_span(traced):
    assert traced["calls"]["warmup"] == 0
    assert traced["calls"]["active"] == len(traced["spans"]) > 0


def test_spans_are_host_ops(traced):
    # a user annotation (record_function) would be mirrored onto the
    # device's timeline, where a trace reader takes it for device work
    assert traced["types"] == {"cpu_op"}


def test_active_step_holds_the_operator_spans(traced):
    spans = traced["spans"]
    assert [s[0] for s in _ops(spans)] == [
        "op:filter", "op:groupby", "op:join", "op:join", "op:join",
        "op:join", "op:topk", "op:join"]
    assert {s[0] for s in spans} == {
        "op:filter", "op:groupby", "op:join", "op:topk", "sort",
        "sync:band_overflow", "sync:expand_overflow", "sync:topk_check",
        "join:fallback"}
    for s in spans:
        if s[0] == "sort":
            assert any(_inside(s, op) for op in _ops(spans)), s


def test_sort_attributes(traced):
    sorts = [s for s in traced["spans"] if s[0] == "sort"]
    assert sorts and all(s[1]["padded"] == nlpo2(s[1]["n"]) for s in sorts)
    # filter_compact partitions without a sort; the GROUP BY after it
    # still sorts its rows
    first, second = (_within(traced["spans"], op)
                     for op in _ops(traced["spans"])[:2])
    assert first == []
    assert second[0][0] == "sort" and second[0][1]["n"] == FILTER_N


def test_one_host_read_per_band_pass(traced):
    spans = traced["spans"]
    ops = _ops(spans)
    syncs = [[s[0] for s in _within(spans, op) if s[0].startswith("sync:")]
             for op in ops]
    # unique build keys: one band pass; repeated keys: two; the merge
    # join none; the expansion two for its ranges and one for each of its
    # own passes; the overflowing join stops after its first
    band, expand = ["sync:band_overflow"], ["sync:expand_overflow"]
    assert syncs == [[], [], band, band * 2, [], band * 2 + expand * 2,
                     ["sync:topk_check"], band]


def test_band_overflow_falls_back_once(traced):
    spans = traced["spans"]
    falls = [s for s in spans if s[0] == "join:fallback"]
    assert len(falls) == 1 and _inside(falls[0], _ops(spans)[-1])
    band = [s for s in spans if s[0] == "sync:band_overflow"][-1]
    assert band[3] <= falls[0][2]
    for got, want in zip(traced["banded"], traced["merge"]):
        assert torch.equal(got, want)
