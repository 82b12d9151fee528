"""scaling_bench and the multichip dry run of cl_ops_tpu_torch, on the CPU.

The port's counterparts of tests/test_bench_cli.py's scaling_bench cases,
on eight positions of the CPU (`--device cpu --virtual 8`): scan and join
at mesh sizes 1 and 8, the refused oversize request and the multiproc leg
at 2 processes x 2 positions; then every op at 1, 2 and 4 positions,
strong scaling, and a wrong dist_scan answer that must exit 1. The
inputs that `scaling_bench.make_case` draws for scan, join and aggregate
go through the JAX operators too (use_pallas=False, check="defer", jitted
once in a module fixture on tests/conftest.py's 8 CPU devices), and the
outputs must be bit-identical. The dry run runs once at 8 CPU positions,
each of its checks one case. Every check of the CLI and the dry run is
exact against numpy.
"""

import functools
import os

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop, parallel
from cl_ops_tpu_torch.bench import checks, common, dryrun, scaling_bench
from cl_ops_tpu_torch.core.errors import CloOpsError
from cl_ops_tpu_torch.parallel.mesh import Sharded, make_mesh

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jpar = pytest.importorskip("cl_ops_tpu.parallel")

CPU8 = ["--device", "cpu", "--virtual", "8"]
OPS = ("scan", "sort", "join", "aggregate", "window", "topk")
DRYRUN_CHECKS = ("dist_scan", "dist_segmented_scan", "dist_sort",
                 "dist_group_aggregate", "dist_group_aggregate_cols",
                 "dist_hash_join", "zipf hash exchange drops",
                 "dist_hash_join zipf re-plan", "dist_hash_join defer",
                 "dist_sort_sample", "dist_window_cols",
                 "dist_window_cols sorted_output",
                 "dist_window_cols lag/lead", "dist_top_k", "dist_distinct",
                 "dist_hash_join_expand defer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tsv(path):
    lines = path.read_text().strip().split("\n")
    head = lines[0].split("\t")
    return head, [dict(zip(head, ln.split("\t"))) for ln in lines[1:]]


# --- the JAX CLI's tests, mirrored -------------------------------------------

def test_scaling_bench_cli(tmp_path):
    out = tmp_path / "scaling.tsv"
    rc = scaling_bench.main(CPU8 + ["--op", "scan,join", "--devices", "1,8",
                                    "-n", "10", "-r", "1", "--out",
                                    str(out)])
    assert rc == 0
    head, rows = _tsv(out)
    assert head == ["op", "devices", "rows", "mrows_s", "speedup",
                    "efficiency"]
    assert len(rows) == 4  # 2 ops x 2 mesh sizes
    for r in rows:  # weak scaling: rows grow with the mesh
        assert int(r["rows"]) == (1 << 10) * int(r["devices"])


def test_scaling_bench_rejects_oversized_mesh(capsys):
    # 16 is not last in the list: make_mesh would silently cut it
    rc = scaling_bench.main(CPU8 + ["--op", "scan", "--devices", "16,8",
                                    "-n", "8", "-r", "1"])
    assert rc == 1
    assert "only 8 positions available; need 16" in capsys.readouterr().err


def test_scaling_bench_multiproc(tmp_path, monkeypatch):
    """2 processes x 2 CPU positions over gloo, measured at 1 and 2
    processes, each worker holding its rows to numpy."""
    monkeypatch.setattr(scaling_bench, "MP_WAIT_S", 120)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "mp.tsv"
    rc = scaling_bench.main(["--multiproc", "2", "--virtual", "2",
                             "--device", "cpu", "--op", "scan,join",
                             "-n", "8", "-r", "1", "--out", str(out)])
    assert rc == 0
    head, rows = _tsv(out)
    assert head == ["op", "hosts", "devices", "rows", "mrows_s", "speedup",
                    "efficiency"]
    assert {(r["op"], r["hosts"]) for r in rows} == {
        ("scan", "1"), ("scan", "2"), ("join", "1"), ("join", "2")}
    for r in rows:  # weak scaling: rows grow with the global mesh
        assert int(r["devices"]) == 2 * int(r["hosts"])
        assert int(r["rows"]) == (1 << 8) * 2 * int(r["hosts"])


# --- more of the CLI ---------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_scaling_bench_every_op(op, tmp_path, capsys):
    out = tmp_path / "scaling.tsv"
    rc = scaling_bench.main(CPU8 + ["--op", op, "--devices", "1,2,4",
                                    "-n", "8", "-r", "1", "--out",
                                    str(out)])
    assert rc == 0
    _, rows = _tsv(out)
    assert [(r["op"], int(r["devices"]), int(r["rows"])) for r in rows] == [
        (op, k, 256 * k) for k in (1, 2, 4)]
    assert float(rows[0]["efficiency"]) == 1.0
    stdout = capsys.readouterr().out
    # the positions share one device: the note above the table says so
    assert stdout.startswith("# mesh sizes above 1 share one device's "
                             "memory (cpu)")


def test_scaling_bench_strong(tmp_path):
    out = tmp_path / "strong.tsv"
    rc = scaling_bench.main(CPU8 + ["--op", "sort,aggregate", "--devices",
                                    "1,2,8", "--scaling", "strong",
                                    "-n", "11", "-r", "1", "--out",
                                    str(out)])
    assert rc == 0
    _, rows = _tsv(out)
    assert len(rows) == 6
    assert {int(r["rows"]) for r in rows} == {1 << 11}


def test_scaling_bench_wrong_answer_exits_1(monkeypatch, capsys):
    real = parallel.dist_scan

    def wrong(*a, **kw):
        out = real(*a, **kw)
        shards = [s.clone() for s in out.shards]
        interop.signed_view(shards[-1])[-1] += 1  # u32: via its int32 bits
        return Sharded(out.mesh, shards)

    monkeypatch.setattr(parallel, "dist_scan", wrong)
    rc = scaling_bench.main(CPU8 + ["--op", "scan", "--devices", "1,2",
                                    "-n", "8", "-r", "1"])
    assert rc == 1
    assert "scan at 1 positions: scan rows differ" in capsys.readouterr().err


def test_scaling_bench_defaults_to_the_card():
    args = scaling_bench.build_parser().parse_args([])
    assert (args.device, args.virtual) == ("cuda", 0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(CloOpsError):  # no fallback to the CPU
        scaling_bench.main(["--op", "scan", "-n", "4", "-r", "1"])


# --- the same inputs through the JAX operators -------------------------------

def _case(op, k=8, log2=8):
    args = scaling_bench.build_parser().parse_args(CPU8 + ["-n", str(log2)])
    mesh = make_mesh(devices=["cpu"] * k)
    return scaling_bench.make_case(op, k, mesh, args,
                                   np.random.RandomState(0))


@pytest.fixture(scope="module")
def jref():
    """The JAX operators' outputs on the port's make_case inputs at 8
    positions, each jitted once."""
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    mesh = jpar.make_mesh(8)
    shard = 256
    cap = max(2 * shard // 8 + 64, 128)  # make_case's cap_for

    def scan():
        _, (x,), _, _ = _case("scan")
        return np.asarray(jax.jit(lambda a: jpar.dist_scan(
            a, mesh, sum_dtype=jnp.uint32, use_pallas=False))(x.numpy()))

    def join():
        _, fargs, _, _ = _case("join")
        b, v, p = (a.numpy() for a in fargs)
        found, vals, dropped = jax.jit(lambda b, v, p: jpar.dist_hash_join(
            b, v, p, mesh, capacity_build=max(2 * (len(b) // 8) // 8 + 64,
                                              128),
            capacity_probe=cap, use_pallas=False, check="defer"))(b, v, p)
        assert all(int(np.asarray(d).sum()) == 0 for d in dropped)
        return np.asarray(found), np.asarray(vals)

    def aggregate():
        _, (k, v), _, _ = _case("aggregate")
        groups = min(1 << 16, 2 * (1 << 16) // 8 + 256)
        gk, table, cnt, dropped = jax.jit(
            lambda a, b: jpar.dist_group_aggregate(
                a, b, mesh, num_groups=groups, capacity=cap,
                use_pallas=False, check="defer"))(k.numpy(), v.numpy())
        assert int(np.asarray(dropped).sum()) == 0
        return tuple(np.asarray(a) for a in (gk, table, cnt))

    cases = {"scan": scan, "join": join, "aggregate": aggregate}
    return functools.cache(lambda name: cases[name]())


def test_scan_case_matches_jax(jref):
    fn, fargs, _, check = _case("scan")
    out = fn(*fargs)
    assert check(out) == []
    # JAX widens a 32-bit sum_dtype to 64 bits under x64 (ROADMAP 3b item
    # 7); its sums are compared after the cast, bit for bit
    got, want = out.numpy(), jref("scan").astype(np.uint32)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_join_case_matches_jax(jref):
    fn, fargs, _, check = _case("join")
    out = fn(*fargs)
    assert check(out) == []
    want_found, want_vals = jref("join")
    for got, want in zip(out[:2], (want_found, want_vals)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def _groups_by_key(gk, table, cnt, p=8):
    g, t = gk.reshape(p, -1), table.reshape(p, -1)
    c = cnt.reshape(-1)
    keys = np.concatenate([g[i, :c[i]] for i in range(p)])
    vals = np.concatenate([t[i, :c[i]] for i in range(p)])
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def test_aggregate_case_matches_jax(jref):
    fn, fargs, _, check = _case("aggregate")
    gk, table, cnt, _ = out = fn(*fargs)
    assert check(out) == []
    got = _groups_by_key(gk.numpy(), table.numpy(), cnt.numpy())
    want = _groups_by_key(*jref("aggregate"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_case_draws_follow_the_jax_cli():
    """make_case draws from the shared RandomState in the JAX CLI's order:
    the join's build side is a permutation of arange(n / 16), its probes
    draw after it."""
    rng = np.random.RandomState(3)
    _, (b, v, p), n, _ = scaling_bench.make_case(
        "join", 2, make_mesh(devices=["cpu"] * 2),
        scaling_bench.build_parser().parse_args(["-n", "8", "-s", "3"]),
        rng)
    want = np.random.RandomState(3)
    bk = want.permutation(n // 16).astype(np.int32)
    np.testing.assert_array_equal(b.numpy(), bk)
    np.testing.assert_array_equal(v.numpy(), bk * 2 + 1)
    np.testing.assert_array_equal(
        p.numpy(), want.randint(0, n // 16, size=n).astype(np.int32))


# --- the dry run -------------------------------------------------------------

@pytest.fixture(scope="module")
def dry():
    return dryrun.dryrun_multichip(8, devices=["cpu"] * 8)


def test_dryrun_runs_every_check(dry):
    assert tuple(dry) == DRYRUN_CHECKS


@pytest.mark.parametrize("name", DRYRUN_CHECKS)
def test_dryrun_check(dry, name):
    assert dry[name] == "ok"


def test_dryrun_cli_reports_a_wrong_answer(monkeypatch, capsys):
    """A wrong top-k turns its entry into a failure and the CLI's exit code
    into 1; the other checks stay "ok"."""
    import json
    real = parallel.dist_top_k

    def wrong(*a, **kw):
        tv, *rest = real(*a, **kw)
        shards = [s.clone() for s in tv.shards]
        for s in shards:
            interop.signed_view(s)[0] += 1
        return (Sharded(tv.mesh, shards, tv.layout), *rest)

    monkeypatch.setattr(parallel, "dist_top_k", wrong)
    assert dryrun.main(["--positions", "2", "--device", "cpu"]) == 1
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["dist_top_k"] == "top-k values differ from np.sort"
    assert all(v == "ok" for k, v in got.items() if k != "dist_top_k")


def test_dryrun_needs_cards_without_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(CloOpsError):
        dryrun.dryrun_multichip(2)


# --- harness pieces ----------------------------------------------------------

def test_default_sync_takes_sharded_outputs(monkeypatch):
    """A Sharded (alone, or first in a tuple) of CPU shards needs no
    synchronise; torch.cuda.synchronize must not be reached."""
    def no_cuda(*a):
        raise AssertionError("synchronised a CPU output")

    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    mesh = make_mesh(devices=["cpu"] * 4)
    x = parallel.dist_scan(np.arange(64, dtype=np.uint32), mesh,
                           sum_dtype=np.uint32)
    sync = common.default_sync()
    sync(x)
    sync((x, torch.zeros(2)))
    sync(torch.zeros(2))
    assert common.time_async(lambda: x, (), 2, sync) >= 0


@pytest.mark.parametrize("kd, od, n, key_hi", [
    (np.uint32, np.int32, 5000, 50),
    (np.int32, np.uint32, 3000, 7),
    (np.uint32, np.int32, 1, 3),
    (np.uint32, np.int32, 40, 2 ** 32),  # past 64 bits: lexsort itself
])
def test_window_oracle_order_is_lexsort(kd, od, n, key_hi):
    rng = np.random.RandomState(n)
    keys = rng.randint(0, key_hi, size=n, dtype=np.int64).astype(kd)
    order = rng.randint(-2 ** 31, 2 ** 31, size=n, dtype=np.int64).astype(od)
    np.testing.assert_array_equal(checks._lex_order(keys, order),
                                  np.lexsort((np.arange(n), order, keys)))


def test_worker_cwd_is_the_package_root():
    assert os.path.isdir(os.path.join(scaling_bench._ROOT,
                                      "cl_ops_tpu_torch"))
