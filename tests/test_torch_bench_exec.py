"""The port's query bench CLIs (exec_bench, pipeline_probe, radix_dma_probe,
bench_all) on the CPU, and bench_all's configs against the JAX operators.

The CLIs run small with `--device cpu`; their checks hold every output to
numpy, and a wrong answer must make them exit non-zero. The differential
cases feed bench_all's own numpy inputs (`data_<k>`) at `--scale 4096` to
the JAX operators (use_pallas=False, as the JAX package's CPU tests run
them) and compare with the port's config outputs bit for bit; order is
ignored only among rows tied on the probe key (the JAX merge path's sort
is unstable). At this scale no JAX call reaches the group-ends search that
stops one step early (groups * 64 >= rows everywhere), and the port's
rows are held to numpy by the configs' own checks besides.
"""

import json
import re

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.bench import (bench_all, exec_bench, pipeline_probe,
                                    radix_dma_probe, roofline)
from cl_ops_tpu_torch.ops import exec as ex
from cl_ops_tpu_torch.ops.exec import bandprobe
from cl_ops_tpu_torch.ops.sort import radix_kernels as rk

# tests/test_bench_cli.py's metric names, with the JAX CLI's units
METRICS = {"sort_u32_1M": "Mkeys/s", "sort_u64kv_16M": "Mpairs/s",
           "filter_64M_sel10": "Mrows/s",
           "aggregate_256M_1Mgroups": "Mrows/s",
           "join_probe_16Mx1M": "Mrows/s",
           "join_probe_16Mx1M_sorted": "Mrows/s",
           "join_probe_16Mx1M_deferred": "Mrows/s",
           "join_expand_16Mx4": "Mpairs/s", "rollup_16Mx1M": "Mrows/s",
           "q1_16Mx64K": "Mrows/s", "window_16Mx64K": "Mrows/s",
           "window_16Mx64K_sorted": "Mrows/s", "topk_1K_of_64M": "Mrows/s",
           "distinct_64M_1M": "Mrows/s", "join_probe_256Mx16M": "Mrows/s"}

RADIX_JAX_KEYS = ["phase1_localsort_ms", "phase1_rankhist_ms",
                  "phase2_chunkcopy_ms", "phase2_gb_s", "phase2_us_per_chunk",
                  "quant_overhead_frac", "envelope_pass_ms",
                  "envelope_sort_ms", "envelope_mkeys_s", "n", "radix", "nb",
                  "n_runs", "n_chunks", "passes"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ceiling(monkeypatch):
    """A stream ceiling of 3350 GB/s from the environment."""
    monkeypatch.setenv(roofline.GBS_ENV, "3350")
    roofline.stream_ceiling_gbs.cache_clear()
    yield
    roofline.stream_ceiling_gbs.cache_clear()


# join and expand take a 2^16-row build side here (the default 2^20 makes
# the CPU's plain band probe take seconds a call); --sparse then spans 4
# build rows a probe, so pass 2 overflows its window
@pytest.mark.parametrize("argv", [
    "--op filter", "--op aggregate", "--op join --dim-log2 16",
    "--op join --dim-log2 16 --zipf 1.1", "--op expand --dim-log2 16",
    "--op expand --dim-log2 16 --sparse", "--op window",
    "--op window --sorted-output", "--op topk", "--op distinct"])
def test_exec_bench_ops(argv, ceiling, capsys, monkeypatch):
    overflows = []
    real = bandprobe.probe_banded_sorted

    def spy(*a, **kw):
        out = real(*a, **kw)
        overflows.append(bool(out[-1]))
        return out
    monkeypatch.setattr(bandprobe, "probe_banded_sorted", spy)
    assert exec_bench.main(argv.split() + ["-n", "12", "-r", "1",
                                           "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip()
    op = argv.split()[1]
    assert re.fullmatch(rf"{op}: 4096 rows x 1 runs -> [0-9.]+ Mrows/s "
                        rf"\([0-9.]+ ms/run\)  \[[0-9.]+ GB/s, [0-9.]+ of "
                        rf"ceiling\]", line), line
    if "--sparse" in argv:  # the direct-gather fallback of pass 2 ran
        assert any(overflows)


def test_exec_bench_fails_on_a_wrong_answer(monkeypatch, capsys):
    real = ex.top_k

    def wrong(*a, **kw):
        vals, pay = real(*a, **kw)
        return vals, pay + 1
    monkeypatch.setattr(ex, "top_k", wrong)
    assert exec_bench.main(["--op", "topk", "-n", "12", "-r", "1",
                            "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "topk: check FAILED: topk payload" in err


@pytest.mark.parametrize("argv,stages", [
    ("--pipe q1", ["gen (threefry x3 + mask)",
                   "sort 3-col (packed key + 2 pay)",
                   "boundary reduce (6 aggs)", "  flags (prev-compare)",
                   "  one torch.cumsum (i32)", "  one scan_carry (i32)",
                   "  ends (end-flag sort)", "  segmented max (price)",
                   "FULL q1_query"]),
    ("--pipe rollup --dim-log2 10", [
        "gen (threefry x2)", "join (sorted_output+defer)",
        "aggregate (keys_sorted)", "  probe sort 4-col (2 keys)",
        "FULL rollup_query(defer)"]),
    ("--pipe expand --dim-log2 14", [
        "ranges (sort + 2 band)", "pass1 queries (cumsum)",
        "pass1 band (segment search)", "pass2 inputs (blk minmax)",
        "pass2 band (value pull)", "glue", "FULL hash_join_expand"])])
def test_pipeline_probe(argv, stages, capsys):
    assert pipeline_probe.main(argv.split() + [
        "-n", "12", "--target-s", "0.01", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = [m.group(1) for m in re.finditer(
        r"^  (.+?) +[0-9.]+ ms  \( +[0-9.]+ Mrows/s\)$", out, re.M)]
    assert got == stages
    assert re.search(r"stage sum \(top-level\) +[0-9.]+ ms +vs FULL "
                     r"[0-9.]+ ms", out)
    assert "FULL check: ok" in out


def test_pipeline_probe_rollup_overflow_checks_the_exact_form(capsys):
    # 1024 probes over a 2^17-key space overflow the band windows: the
    # serving form's flag is set, and the exact form is what gets checked
    assert pipeline_probe.main(["--pipe", "rollup", "-n", "10",
                                "--dim-log2", "16", "--target-s", "0.01",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "band overflow: checking rollup_query(defer=False)" in out
    assert "FULL check: ok" in out


def test_radix_dma_probe(capsys):
    assert radix_dma_probe.main(["-n", "16", "--block", "4096", "-r", "1",
                                 "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert list(row)[:len(RADIX_JAX_KEYS)] == RADIX_JAX_KEYS
    assert row["checks"] == "ok" and row["nb"] == 16
    assert row["n_runs"] == 256 and row["passes"] == 8
    assert set(row["launches"]) == {"phase1_localsort", "phase1_rankhist",
                                    "phase2_chunkcopy"}


def test_radix_dma_probe_tiles_a_block(capsys):
    # a 65536-key block takes four rank_hist tiles of 16384
    assert radix_dma_probe.main(["-n", "17", "--block", "65536", "-r", "1",
                                 "--radix", "4", "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert (row["tile"], row["nb"], row["checks"]) == (16384, 2, "ok")


def test_radix_dma_probe_fails_on_a_wrong_histogram(monkeypatch, capsys):
    real = rk.rank_hist

    def wrong(*a, **kw):
        rank, hist = real(*a, **kw)
        return rank, hist.flip(1)
    monkeypatch.setattr(rk, "rank_hist", wrong)
    assert radix_dma_probe.main(["-n", "14", "--block", "4096", "-r", "1",
                                 "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out)["checks"] == "FAILED"
    assert "phase 1b: block histograms differ from np.bincount" in out.err


def test_local_sort_directions():
    """The network's stages K = 2 .. block leave even blocks ascending and
    odd ones descending, whatever the tile geometry."""
    rng = np.random.RandomState(1)
    x = rng.permutation(1 << 13).astype(np.int32)
    cols = [torch.from_numpy(x.copy()), torch.from_numpy(-x)]
    radix_dma_probe.local_sort(cols, 2048)
    got = cols[0].numpy().reshape(4, 2048)
    want = np.sort(x.reshape(4, 2048), axis=1)
    want[1::2] = want[1::2, ::-1]
    assert np.array_equal(got, want)
    assert np.array_equal(cols[1].numpy(), -cols[0].numpy())


def _rows(out):
    return [json.loads(line) for line in out.strip().split("\n")
            if line.startswith("{")]


def test_bench_all_cli(tmp_path, monkeypatch, capsys, ceiling):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.jsonl"
    assert bench_all.main(["--scale", "4096", "--runs", "1", "--target-s",
                           "0", "--device", "cpu", "--out", str(out)]) == 0
    rows = _rows(capsys.readouterr().out)
    assert {r["metric"]: r["unit"] for r in rows} == METRICS
    assert len(rows) == 15
    for r in rows:
        assert "error" not in r and r["value"] >= 0 and r["ms"] > 0
        assert r["device"] == "cpu" and "roofline_frac" in r
    assert [json.loads(line) for line in out.read_text().split("\n")
            if line] == rows
    assert not (tmp_path / "BENCH_ALL.json").exists()


def test_bench_all_error_row(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    real = ex.distinct

    def wrong(keys, *, capacity):
        uv, cnt = real(keys, capacity=capacity)
        return uv, cnt - 1
    monkeypatch.setattr(ex, "distinct", wrong)
    assert bench_all.main(["--scale", "4096", "--runs", "1", "--target-s",
                           "0", "--device", "cpu", "--configs",
                           "10,11"]) == 1
    rows = {r["metric"]: r for r in _rows(capsys.readouterr().out)}
    assert "error" not in rows["topk_1K_of_64M"]
    assert rows["distinct_64M_1M"]["value"] is None
    assert rows["distinct_64M_1M"]["error"].startswith("distinct count")
    assert not (tmp_path / "BENCH_ALL.json").exists()


def test_bench_all_raising_config_gives_error_rows(monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("boom")
    monkeypatch.setattr(ex, "hash_join", boom)
    assert bench_all.main(["--scale", "4096", "--runs", "1", "--target-s",
                           "0", "--device", "cpu", "--configs", "5"]) == 1
    rows = _rows(capsys.readouterr().out)
    assert [r["metric"] for r in rows] == [
        "join_probe_16Mx1M", "join_probe_16Mx1M_sorted",
        "join_probe_16Mx1M_deferred"]
    assert all(r["error"] == "RuntimeError: boom" for r in rows)


# --- bench_all's configs against the JAX operators ---------------------------

SCALE = 4096


@pytest.fixture(scope="module")
def jax_exec():
    pytest.importorskip("jax")
    return pytest.importorskip("cl_ops_tpu.ops.exec")


@pytest.fixture(scope="module")
def ctx():
    return bench_all.Ctx(torch.device("cpu"), SCALE, 1, 0.0)


def _n(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _no_errors(rows):
    assert all("error" not in r for r in rows), rows


def test_config_4_matches_jax(jax_exec, ctx):
    import jax.numpy as jnp
    rows, outs = bench_all.config_4(ctx)
    _no_errors(rows)
    keys, vals, groups = bench_all.data_4(SCALE)
    assert groups * 64 >= keys.size
    want = jax_exec.group_aggregate_sorted(
        jnp.asarray(keys), jnp.asarray(vals), num_groups=groups,
        use_pallas=False)
    for g, w in zip(outs["aggregate"], want):
        assert np.array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("metric,kw", [
    ("join_probe_16Mx1M", {}),
    ("join_probe_16Mx1M_sorted", {"sorted_output": True}),
    ("join_probe_16Mx1M_deferred", {"sorted_output": True,
                                    "defer_overflow": True})])
def test_config_5_matches_jax(jax_exec, ctx, metric, kw):
    import jax.numpy as jnp
    rows, outs = bench_all.config_5(ctx)
    _no_errors(rows)
    _, _, probe = bench_all.data_5(SCALE)
    sdk, sdv = (_n(t) for t in outs["build"])
    want = [np.asarray(w) for w in jax_exec.hash_join(
        jnp.asarray(sdk), jnp.asarray(sdv), jnp.asarray(probe),
        build_sorted=True, use_pallas=False, **kw)]
    got = [_n(t) for t in outs[metric]]
    assert len(got) == len(want)
    if kw:  # rows tied on the probe key: order by (key, probe row)
        for out in (got, want):
            order = np.lexsort((out[2], probe[out[2]]))
            out[:3] = [c[order] for c in out[:3]]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_config_6_matches_jax(jax_exec, ctx):
    import jax.numpy as jnp
    rows, outs = bench_all.config_6(ctx)
    _no_errors(rows)
    _, _, pk, cap = bench_all.data_6(SCALE)
    sdk, sdv = (_n(t) for t in outs["build"])
    want = jax_exec.hash_join_expand(
        jnp.asarray(sdk), jnp.asarray(sdv), jnp.asarray(pk), capacity=cap,
        build_sorted=True, use_pallas=False)
    for g, w in zip(outs["expand"], want):
        assert np.array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("metric,so", [("window_16Mx64K", False),
                                       ("window_16Mx64K_sorted", True)])
def test_config_9_matches_jax(jax_exec, ctx, metric, so):
    import jax.numpy as jnp
    rows, outs = bench_all.config_9(ctx)
    _no_errors(rows)
    wk, wo, wv = (jnp.asarray(a) for a in bench_all.data_9(SCALE))
    want = jax_exec.window_cols(wk, wo, (wv, None), ("sum", "row_number"),
                                use_pallas=False, sorted_output=so)
    got = outs[metric]
    if so:
        (got, src), (want, wsrc) = got, want
        assert np.array_equal(_n(src), np.asarray(wsrc))
    for g, w in zip(got, want):
        assert np.array_equal(_n(g), np.asarray(w))


def test_config_11_matches_jax(jax_exec, ctx):
    import jax.numpy as jnp
    rows, outs = bench_all.config_11(ctx)
    _no_errors(rows)
    keys, du = bench_all.data_11(SCALE)
    assert du * 64 >= keys.size
    want = jax_exec.distinct(jnp.asarray(keys), capacity=du,
                             use_pallas=False)
    for g, w in zip(outs["distinct"], want):
        assert np.array_equal(_n(g), np.asarray(w))
