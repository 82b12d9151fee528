"""The port's bench harness, CLIs, headline line and profiling helpers on
the CPU, against cl_ops_tpu's where both produce bytes.

The CLIs run with `--device cpu` at `tests/test_bench_cli.py`'s sizes;
rand_array and rng_bench's output files must equal the JAX package's byte
for byte. `$CL_OPS_ROOFLINE_GBS` stands in for the stream ceiling, which
only the card can measure.
"""

import json

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import bench
from cl_ops_tpu_torch.bench import (common, headline, plot_rng, rng_bench,
                                    roofline, scan_bench, sort_bench)
from cl_ops_tpu_torch.core.dtypes import all_type_names, type_info
from cl_ops_tpu_torch.core.errors import CloOpsError
from cl_ops_tpu_torch.utils import platform, profiling

HEADLINE_KEYS = ["metric", "value", "unit", "vs_baseline", "gb_s",
                 "roofline_frac", "ceiling_gb_s"]


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
    yield 3350.0
    roofline.stream_ceiling_gbs.cache_clear()


@pytest.mark.parametrize("type_name", all_type_names())
def test_rand_array_matches_reference(type_name):
    pytest.importorskip("jax")
    from cl_ops_tpu.bench import common as jcommon
    dt = type_info(type_name).np_dtype
    got = common.rand_array(dt, 1000, seed=7)
    want = jcommon.rand_array(dt, 1000, seed=7)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_public_names_match_reference():
    pytest.importorskip("jax")
    import cl_ops_tpu.bench as jbench
    assert bench.__all__ == jbench.__all__


def test_harness_helpers():
    assert [common.compare_values(a, b) for a, b in
            ((1, 2), (2, 2), (3, 2))] == [-1, 0, 1]
    assert common.throughput_m(1000, 4, 2.0) == 2e-3
    calls = []
    secs = common.time_async(lambda x: calls.append(x) or x, (1,), 3,
                             lambda out: calls.append("sync"))
    assert secs >= 0 and calls == [1, "sync", 1, 1, 1, "sync"]
    sync = common.default_sync()
    sync(torch.zeros(3))
    sync((torch.zeros(3), torch.ones(2)))  # CPU tensors: nothing to wait on
    assert common.time_adaptive(lambda: None, (), lambda out: None,
                                target_s=0.01, max_runs=20) >= 0


def test_roofline_row_and_ceiling(ceiling, monkeypatch, tmp_path):
    assert roofline.stream_ceiling_gbs() == ceiling
    row = roofline.roofline_row(3_350_000_000, 0.002)
    assert row == {"gb_s": 1675.0, "roofline_frac": 0.5}
    monkeypatch.setenv(roofline.CACHE_ENV, str(tmp_path / "c.json"))
    assert roofline.cache_path() == str(tmp_path / "c.json")
    monkeypatch.delenv(roofline.GBS_ENV)
    roofline.stream_ceiling_gbs.cache_clear()
    monkeypatch.setattr(platform, "has_cuda", lambda: False)
    with pytest.raises(CloOpsError):  # no fallback to a CPU figure
        roofline.stream_ceiling_gbs()


def test_sort_bench_cli(tmp_path):
    out = tmp_path / "sort.tsv"
    rc = sort_bench.main(["-a", "xla", "-r", "1", "--minpo2", "4",
                          "--maxpo2", "6", "--out", str(out),
                          "--device", "cpu"])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "n\tmkeys_s\tms_per_run\tcheck"
    assert len(lines) == 4  # header + 3 sizes
    assert all(l.endswith("\tok") for l in lines[1:])


@pytest.mark.parametrize("args", [["-t", "uint"], ["-t", "ulong", "--kv"],
                                  ["-t", "float"], ["-t", "char"]])
def test_sort_bench_abitonic_roofline(tmp_path, ceiling, args):
    out = tmp_path / "sort.tsv"
    rc = sort_bench.main(["-a", "abitonic", "--minpo2", "3", "--maxpo2",
                          "7", "--out", str(out), "--device", "cpu"] + args)
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert lines[0].split("\t") == ["n", "mkeys_s", "ms_per_run", "gb_s",
                                    "roofline_frac", "check"]
    assert len(lines) == 6 and all(l.endswith("\tok") for l in lines[1:])


def test_sort_bench_fails_on_unsorted_unsigned_output(monkeypatch, capsys):
    """The port holds the output to np.sort exactly: an unsorted uint32
    output fails, where a check by np.diff(out) >= 0 passes it (the
    unsigned difference wraps)."""
    real_new = sort_bench.sort_new

    class Unsorted:
        def __init__(self, sorter):
            self.elem_dtype = sorter.elem_dtype

        def sort_with_device_data(self, data, values=None):
            # random keys reversed: not sorted
            return data.view(torch.int32).flip(0).view(data.dtype)

    monkeypatch.setattr(sort_bench, "sort_new",
                        lambda *a, **k: Unsorted(real_new(*a, **k)))
    rc = sort_bench.main(["-a", "xla", "--minpo2", "5", "--maxpo2", "5",
                          "--device", "cpu"])
    assert rc == 1
    assert "FAILED" in capsys.readouterr().out
    bad = common.rand_array(np.uint32, 32, 5)[::-1]
    assert np.all(np.diff(bad) >= 0) and not np.array_equal(bad,
                                                            np.sort(bad))


@pytest.mark.parametrize("alg", ["xla", "blelloch", "lookback"])
def test_scan_bench_cli(tmp_path, ceiling, alg):
    out = tmp_path / "scan.tsv"
    rc = scan_bench.main(["-a", alg, "-r", "1", "--min-doub", "2",
                          "-n", "4", "--out", str(out), "--device", "cpu"])
    assert rc == 0
    lines = out.read_text().strip().split("\n")
    assert len(lines) == 4 and all(l.endswith("\tok") for l in lines[1:])


def test_scan_bench_float_and_overflow(tmp_path):
    rc = scan_bench.main(["-a", "xla", "-t", "float", "--min-doub", "2",
                          "-n", "3", "--device", "cpu"])
    assert rc == 0
    out = tmp_path / "scan.tsv"
    rc = scan_bench.main(["-a", "xla", "-t", "uchar", "--sum-type", "uchar",
                          "--min-doub", "4", "-n", "4", "--out", str(out),
                          "--device", "cpu"])
    assert rc == 0
    assert out.read_text().strip().split("\n")[1].endswith("\toverflow")


def test_rng_bench_cli_dieharder(tmp_path):
    out = tmp_path / "rng.dh"
    rc = rng_bench.main(["-g", "threefry", "--gws", "64", "-r", "4",
                         "--output", "file-dh", "--out-file", str(out),
                         "--device", "cpu"])
    assert rc == 0
    head = out.read_text().split("\n")[:3]
    assert head == ["type: d", "count: 256", "numbit: 32"]


def test_rng_bench_cli_tsv_and_plot(tmp_path):
    tsv = tmp_path / "rng.tsv"
    rc = rng_bench.main(["-g", "mwc64x", "--gws", "32", "-r", "32",
                         "--output", "file-tsv", "--out-file", str(tsv),
                         "--device", "cpu"])
    assert rc == 0
    assert np.loadtxt(tsv, delimiter="\t").shape == (32, 32)
    png = tmp_path / "rng.png"
    rc = plot_rng.main([str(tsv), "--out", str(png)])
    if rc == 0:  # matplotlib present
        assert png.exists()


def test_rng_bench_bits_and_maxint(capsys):
    rc = rng_bench.main(["-g", "lcg", "--gws", "16", "-r", "2", "--bits",
                         "8", "--output", "stdout-uint", "--device", "cpu"])
    assert rc == 0
    vals = [int(v) for v in capsys.readouterr().out.split()]
    assert len(vals) == 32 and all(0 <= v < 256 for v in vals)
    rc = rng_bench.main(["-g", "lcg", "--gws", "16", "-r", "2", "--max-int",
                         "9", "--output", "stdout-uint", "--device", "cpu"])
    assert rc == 0
    vals = [int(v) for v in capsys.readouterr().out.split()]
    assert all(0 <= v <= 9 for v in vals)
    assert rng_bench.main(["--max-int", str(2 ** 32 - 1), "--gws", "4",
                           "--device", "cpu"]) == 1
    assert rng_bench.main(["-r", "0", "--gws", "4", "--device", "cpu"]) == 1


@pytest.mark.parametrize("args", [
    ["-g", "threefry", "--output", "file-tsv"],
    ["-g", "xorshift64", "--hash", "xs1", "-s", "-7", "--output", "file-dh"],
    ["-g", "mwc64x", "--seed-type", "host_mt", "-s", "99", "--output",
     "file-tsv"],
    ["-g", "lcg", "--bits", "8", "--output", "file-dh"],
    ["-g", "parkmiller", "--max-int", "999", "--output", "file-tsv"],
    ["-g", "tauslcg", "--hash", "", "--output", "file-dh"],
    ["-g", "xorshift128", "--output", "file-tsv"],
], ids=lambda a: a[1])
def test_rng_bench_files_match_reference(tmp_path, args):
    pytest.importorskip("jax")
    from cl_ops_tpu.bench import rng_bench as jrng_bench
    mine, ref = tmp_path / "port.out", tmp_path / "jax.out"
    common_args = ["--gws", "48", "-r", "6"] + args
    assert rng_bench.main(common_args + ["--out-file", str(mine),
                                         "--device", "cpu"]) == 0
    assert jrng_bench.main(common_args + ["--out-file", str(ref)]) == 0
    assert mine.read_bytes() == ref.read_bytes()


def test_rng_bench_stdout_bin(capsysbinary):
    assert rng_bench.main(["-g", "threefry", "--gws", "8", "-r", "3",
                           "--output", "stdout-bin", "--device", "cpu"]) == 0
    assert len(capsysbinary.readouterr().out) == 8 * 3 * 4


def test_headline_line(ceiling, capsys):
    assert headline.main(["--log2n", "12", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == HEADLINE_KEYS
    assert line["metric"] == "abitonic_sort_u32_4096"
    assert line["unit"] == "Mkeys/s" and line["ceiling_gb_s"] == ceiling
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert headline.cached_geometry(1 << 12, torch.device("cpu")) is None


def test_profiling_helpers(tmp_path, capsys):
    with profiling.trace(str(tmp_path)):
        with profiling.named("cl_ops_label"):
            torch.sort(torch.arange(1000, 0, -1))
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "cl_ops_label" for e in events)
    results = {}
    with profiling.timed("step", results):
        torch.ones(10).sum()
    assert set(results) == {"step"} and results["step"] >= 0
    with profiling.timed("printed"):
        pass
    assert capsys.readouterr().out.startswith("[printed] ")
