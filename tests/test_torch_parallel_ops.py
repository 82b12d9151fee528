"""The distributed layer's operators in cl_ops_tpu_torch against cl_ops_tpu's.

The port runs on eight CPU shards (`make_mesh(devices=["cpu"] * 8)`), and
on two and four where the depth of the hypercube sort or the size of the
local table matters; the JAX package runs on tests/conftest.py's 8-device
CPU mesh with use_pallas=False. Integers are held bit for bit, float32
sums and means within 1e-6 of the running sum of |x|.

What JAX leaves unspecified is held to numpy and to the port's own rule
instead: the first match value of a non-unique build key (JAX's XLA local
path sorts with an unstable lax.sort; the port gives the least value), and
the order of the expansion's pairs within a key (compared per position as
a multiset). JAX's GROUP BY searches its group ends one step short when
num_groups * 64 < local rows (ROADMAP 3b item 1), so it is compared only
at capacities that keep it on its exact path; larger shapes go to numpy.

Each JAX result is computed once per module (`jref`), jitted: JAX's join
and aggregate jit whole under check="defer", compared at capacities that
drop nothing. Its re-planning path reads counters on the host; there the
port is held to numpy, and its final capacities to JAX's
keyed_exchange_replan.
"""

import functools

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop, parallel
from cl_ops_tpu_torch.ops.exec import bandprobe, window_cols
from cl_ops_tpu_torch.ops.exec.topk import top_k
from cl_ops_tpu_torch.parallel import join as tjoin
from cl_ops_tpu_torch.parallel.mesh import Sharded, iota_sharded
from cl_ops_tpu_torch.parallel.splitters import hash_partition_ids

jax = pytest.importorskip("jax")
jpar = pytest.importorskip("cl_ops_tpu.parallel")
jsp = pytest.importorskip("cl_ops_tpu.parallel.splitters")
_jit_splitters = pytest.importorskip(
    "tests.test_torch_parallel")._jit_splitters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n=8):
    return parallel.make_mesh(devices=["cpu"] * n)


def per_position(x, n=8):
    """A Sharded's or a JAX array's rows as (positions, rows a position)."""
    a = x.numpy() if isinstance(x, Sharded) else np.asarray(x)
    return a.reshape(n, -1)


def group_dict(gk, tables, cnt, n=8):
    """{key: (aggregates...)} over every position's valid rows."""
    g = per_position(gk, n)
    ts = [per_position(t, n) for t in tables]
    c = per_position(cnt, n).reshape(-1)
    return {int(g[p, i]): tuple(t[p, i].item() for t in ts)
            for p in range(n) for i in range(c[p])}


def expansion_pairs(totals, pidx, vals, n=8):
    """Each position's (probe row, value) pairs, sorted."""
    t = per_position(totals, n).reshape(-1)
    p, v = per_position(pidx, n), per_position(vals, n)
    return [sorted(zip(p[c, :t[c]].tolist(), v[c, :t[c]].tolist()))
            for c in range(n)]


# --- inputs, made from seeds -------------------------------------------------

N = 8 * 512
_r = np.random.RandomState(30)
DIM = np.unique(_r.randint(0, 1 << 20, size=600).astype(np.uint32))
DIM = DIM[:len(DIM) // 8 * 8]
DIM_V = (DIM * 3 + 1).astype(np.uint32)
FACT = np.concatenate([DIM[_r.randint(0, len(DIM), size=8 * 200)],
                       _r.randint(1 << 20, 1 << 21, size=8 * 56)
                       .astype(np.uint32)])
_r.shuffle(FACT)
_r = np.random.RandomState(34)
MULTI_B = _r.randint(0, 32, size=8 * 32).astype(np.uint32)
MULTI_V = (MULTI_B * 100).astype(np.int32)
MULTI_P = _r.randint(0, 48, size=8 * 64).astype(np.uint32)
_r = np.random.RandomState(60)
EXP_B = np.sort(_r.randint(0, 200, size=8 * 64).astype(np.uint32))
EXP_V = np.arange(8 * 64, dtype=np.int32) + 7
EXP_P = _r.randint(0, 256, size=8 * 128).astype(np.uint32)
EXP_CAP = 4096
_r = np.random.RandomState(31)
AGG_K = _r.randint(0, 100, size=N).astype(np.uint32)
AGG_V = _r.randint(0, 50, size=N).astype(np.int32)
AGG_CAP = 128  # local rows 8 * 128 <= 64 * 256 groups: JAX's exact path
_r = np.random.RandomState(83)
COLS_K = _r.randint(0, 60, size=N).astype(np.int32)
COLS_V1 = _r.randint(-40, 40, size=N).astype(np.int32)
COLS_V2 = _r.randint(0, 100, size=N).astype(np.int32)
COLS_AGGS = ("sum", "min", "max", "count", "mean")
ALL_AGGS = ("sum", "min", "max", "mean", "count", "row_number", "rank",
            "dense_rank", "lag", "lead")
_NO_MEASURE = ("count", "row_number", "rank", "dense_rank")


def _window_case(n, n_keys, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n_keys, size=n).astype(np.uint32),
            rng.randint(0, 40, size=n).astype(np.int32),
            rng.randint(0, 1000, size=n).astype(np.uint32))


WIN = _window_case(8 * 125, 6, 3)
_r = np.random.RandomState(23)
TOPK_V = _r.randint(0, 300, size=8 * 500).astype(np.uint32)  # heavy ties
TOPK_P = _r.randint(-100, 100, size=8 * 500).astype(np.int32)
# zipf(1.2) probes whose even-share buckets overflow the hash plan
ZIPF_P = (np.random.default_rng(50).zipf(1.2, size=8 * 1024)
          % (1 << 16)).astype(np.uint32)
ZIPF_DIM = np.arange(8 * 64, dtype=np.uint32)
ZIPF_CAPS = (len(ZIPF_DIM), 8 * 1024 // 64)


# --- the JAX side, each result computed once ---------------------------------

def _np(*arrays):
    out = tuple(np.asarray(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def _jax_cases(mesh):
    def jit(fn, *args):
        return jax.jit(fn)(*args)

    def join(build, bvals, probe, **kw):
        out = jit(lambda b, v, p: jpar.dist_hash_join(
            b, v, p, mesh, capacity_build=len(build),
            capacity_probe=len(probe), use_pallas=False, check="defer",
            **kw), build, bvals, probe)
        *res, dropped = out
        assert all(int(np.asarray(d).sum()) == 0 for d in dropped)
        return _np(*res)

    def window(keys, order, vals):
        values = tuple(None if a in _NO_MEASURE else vals for a in ALL_AGGS)
        return _np(*jit(lambda k, o, v: jpar.dist_window_cols(
            k, o, tuple(None if x is None else v for x in values), ALL_AGGS,
            mesh, use_pallas=False), keys, order, vals))

    def zipf_replan():
        with pytest.MonkeyPatch.context() as mp:
            _jit_splitters(mp, mesh)
            return jsp.keyed_exchange_replan(
                [(ZIPF_DIM, ()), (ZIPF_P, ())], mesh, capacities=ZIPF_CAPS,
                samples_per_chip=64, splitter_side=1)[1]

    return {
        "join unique": lambda: join(DIM, DIM_V, FACT),
        "join multi": lambda: join(MULTI_B, MULTI_V, MULTI_P,
                                   unique_build=False),
        "join semi": lambda: join(MULTI_B, MULTI_V, MULTI_P,
                                  join_type="semi"),
        "join anti": lambda: join(MULTI_B, MULTI_V, MULTI_P,
                                  join_type="anti"),
        "expand": lambda: _np(*jit(lambda b, v, p: jpar.dist_hash_join_expand(
            b, v, p, mesh, capacity_build=len(EXP_B),
            capacity_probe=len(EXP_P), capacity_out=EXP_CAP,
            check="defer")[:3], EXP_B, EXP_V, EXP_P)),
        "aggregate": lambda: _np(*jit(lambda k, v: jpar.dist_group_aggregate(
            k, v, mesh, num_groups=256, capacity=AGG_CAP, use_pallas=False,
            check="defer")[:3], AGG_K, AGG_V)),
        "aggregate cols": lambda: jit(
            lambda k, a, b: jpar.dist_group_aggregate_cols(
                k, (a, a, b, b, a), COLS_AGGS, mesh, num_groups=128,
                capacity=N // 16, use_pallas=False, check="defer")[:3],
            COLS_K, COLS_V1, COLS_V2),
        "window": lambda: window(*WIN),
        "top_k": lambda: _np(*jit(lambda v, p: jpar.dist_top_k(
            v, 37, mesh, p, use_pallas=False), TOPK_V, TOPK_P)),
        "zipf replan caps": zipf_replan,
    }


@pytest.fixture(scope="module")
def jref():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    cases = _jax_cases(jpar.make_mesh(8))
    return functools.cache(lambda name: cases[name]())


# --- dist_hash_join ----------------------------------------------------------

@pytest.mark.parametrize("check", ["replan", "defer"])
def test_dist_hash_join_unique_matches_jax(jref, check):
    out = parallel.dist_hash_join(DIM, DIM_V, FACT, cpu_mesh(),
                                  capacity_build=len(DIM),
                                  capacity_probe=len(FACT), check=check)
    found, vals = out[0].numpy(), out[1].numpy()
    if check == "defer":
        assert all(int(d.numpy().sum()) == 0 for d in out[2])
    want_found, want_vals = jref("join unique")
    expect = np.isin(FACT, DIM)
    np.testing.assert_array_equal(found, want_found)
    np.testing.assert_array_equal(found, expect)
    np.testing.assert_array_equal(vals[expect], want_vals[expect])
    np.testing.assert_array_equal(vals[expect], FACT[expect] * 3 + 1)


def test_dist_hash_join_non_unique_matches_jax(jref):
    cnt, fv = parallel.dist_hash_join(
        MULTI_B, MULTI_V, MULTI_P, cpu_mesh(), capacity_build=len(MULTI_B),
        capacity_probe=len(MULTI_P), unique_build=False)
    want_cnt, want_fv = jref("join multi")
    cnt, fv = cnt.numpy(), fv.numpy()
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_array_equal(
        cnt, (MULTI_B[None, :] == MULTI_P[:, None]).sum(1))
    hit = cnt > 0
    np.testing.assert_array_equal(fv[hit], want_fv[hit])
    np.testing.assert_array_equal(fv[hit], MULTI_P[hit] * 100)


def test_dist_hash_join_first_value_is_the_least():
    """The port's rule where JAX's is unspecified: a non-unique key's first
    value is the least of its matches' values (the local table's order)."""
    rng = np.random.RandomState(35)
    build = rng.randint(0, 16, size=8 * 32).astype(np.uint32)
    bvals = rng.permutation(8 * 32).astype(np.int32) - 100
    probe = rng.randint(0, 20, size=8 * 64).astype(np.uint32)
    cnt, fv = parallel.dist_hash_join(build, bvals, probe, cpu_mesh(),
                                      capacity_build=len(build),
                                      capacity_probe=len(probe),
                                      unique_build=False)
    cnt, fv = cnt.numpy(), fv.numpy()
    for i, p in enumerate(probe):
        m = build == p
        assert cnt[i] == m.sum()
        if m.any():
            assert fv[i] == bvals[m].min()


@pytest.mark.parametrize("join_type", ["semi", "anti"])
def test_dist_hash_join_semi_anti_match_jax(jref, join_type):
    got = parallel.dist_hash_join(
        MULTI_B, MULTI_V, MULTI_P, cpu_mesh(), capacity_build=len(MULTI_B),
        capacity_probe=len(MULTI_P), join_type=join_type).numpy()
    np.testing.assert_array_equal(got, jref(f"join {join_type}"))
    isin = np.isin(MULTI_P, MULTI_B)
    np.testing.assert_array_equal(got, isin if join_type == "semi"
                                  else ~isin)


def test_dist_hash_join_max_key():
    """A real key equal to the limb maximum joins; fill slots never
    match."""
    rng = np.random.RandomState(33)
    dim = np.array([0xFFFFFFFF, 1, 2, 3, 4, 5, 6, 7], np.uint32)
    dim_vals = np.arange(8, dtype=np.uint32) + 100
    fact = rng.choice(np.array([0xFFFFFFFF, 1, 2, 9], np.uint32), size=64)
    for unique_build in (True, False):
        out = parallel.dist_hash_join(dim, dim_vals, fact, cpu_mesh(),
                                      capacity_build=8,
                                      capacity_probe=len(fact),
                                      unique_build=unique_build)
        hit, vals = out[0].numpy(), out[1].numpy()
        expect = np.isin(fact, dim)
        np.testing.assert_array_equal(hit > 0, expect)
        lut = dict(zip(dim.tolist(), dim_vals.tolist()))
        assert [int(v) for v in vals[expect]] == [lut[int(f)]
                                                  for f in fact[expect]]


def test_dist_hash_join_zipf_replan(jref, monkeypatch):
    """Zipf(1.2) probes overflow the hash plan at the even share: the join
    re-plans to the capacities JAX's keyed_exchange_replan reaches, and
    returns the exact answer."""
    caps = []
    orig = tjoin.keyed_exchange_replan

    def recording(*a, **kw):
        out = orig(*a, **kw)
        caps.append(out[1])
        return out

    monkeypatch.setattr(tjoin, "keyed_exchange_replan", recording)
    dim_vals = (ZIPF_DIM * 5 + 3).astype(np.int32)
    found, vals = parallel.dist_hash_join(
        ZIPF_DIM, dim_vals, ZIPF_P, cpu_mesh(), capacity_build=ZIPF_CAPS[0],
        capacity_probe=ZIPF_CAPS[1], samples_per_chip=64)
    expect = ZIPF_P < len(ZIPF_DIM)
    np.testing.assert_array_equal(found.numpy(), expect)
    np.testing.assert_array_equal(vals.numpy()[expect],
                                  (ZIPF_P[expect] * 5 + 3).astype(np.int32))
    assert caps == [tuple(jref("zipf replan caps"))]
    pid = hash_partition_ids(interop.to_torch(ZIPF_P, "cpu"), 8)
    _, dropped, _ = parallel.partition_exchange(ZIPF_P, pid, cpu_mesh(),
                                                capacity=ZIPF_CAPS[1])
    assert int(dropped.numpy().sum()) > 0, "the case must overflow hash"


def test_dist_hash_join_overflow_raises():
    probe = np.full(8 * 64, 7, np.uint32)  # one key: no plan splits it
    dim = np.arange(8, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="overflow persists"):
        parallel.dist_hash_join(dim, dim.astype(np.int32), probe, cpu_mesh(),
                                capacity_build=8, capacity_probe=8,
                                max_replan=1)


def test_dist_hash_join_range_partition():
    rng = np.random.RandomState(54)
    dim = np.arange(8 * 32, dtype=np.uint32) * 3
    fact = rng.randint(0, 3 * len(dim), size=8 * 128).astype(np.uint32)
    found, vals = parallel.dist_hash_join(
        dim, (dim + 9).astype(np.int32), fact, cpu_mesh(),
        capacity_build=len(dim), capacity_probe=len(fact),
        partition="range", samples_per_chip=32)
    expect = fact % 3 == 0
    np.testing.assert_array_equal(found.numpy(), expect)
    np.testing.assert_array_equal(vals.numpy()[expect],
                                  (fact[expect] + 9).astype(np.int32))


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(tjoin, name)
    monkeypatch.setattr(tjoin, name, lambda *a, **kw: calls.append(1)
                        or orig(*a, **kw))
    return calls


@pytest.mark.parametrize("check,unique_build", [
    ("replan", True), ("replan", False), ("defer", True), ("defer", False)])
def test_dist_hash_join_table_past_direct_max(monkeypatch, check,
                                              unique_build):
    """Local tables of 4 x 8192 slots: band passes under "replan", the
    merge probe under "defer" (exact for any skew without a host read)."""
    band = _count_calls(monkeypatch, "_banded_passes")
    merge = _count_calls(monkeypatch, "_merge_rank")
    rng = np.random.RandomState(5)
    nb = 4 * 8192
    dim = rng.permutation(nb).astype(np.uint32)
    probe = rng.randint(0, 2 * nb, size=4 * 4096).astype(np.uint32)
    out = parallel.dist_hash_join(dim, (dim * 7 + 1).astype(np.uint32),
                                  probe, cpu_mesh(4), capacity_build=8192,
                                  capacity_probe=4096, check=check,
                                  unique_build=unique_build)
    assert 4 * 8192 > bandprobe.DIRECT_MAX
    assert (len(band), len(merge)) == ((4, 0) if check == "replan" else
                                       (0, 4 * (2 - unique_build)))
    expect = probe < nb
    np.testing.assert_array_equal(out[0].numpy() > 0, expect)
    np.testing.assert_array_equal(out[1].numpy()[expect],
                                  probe[expect] * 7 + 1)


def test_dist_hash_join_band_overflow_falls_back_to_merge(monkeypatch):
    """A key repeated past one band window overflows the band pass under
    "replan": the join reads the flag and takes the merge probe."""
    merge = _count_calls(monkeypatch, "_merge_rank")
    rng = np.random.RandomState(6)
    build = np.concatenate([np.full(4 * 6000, 5, np.uint32),
                            np.arange(4 * 2192, dtype=np.uint32) + 10])
    rng.shuffle(build)
    bvals = np.arange(len(build), dtype=np.int32)
    probe = rng.randint(0, 4 * 2192 + 10, size=4 * 4096).astype(np.uint32)
    cnt, fv = parallel.dist_hash_join(build, bvals, probe, cpu_mesh(4),
                                      capacity_build=8192 * 4,
                                      capacity_probe=4096,
                                      unique_build=False)
    assert len(merge) > 0
    want = np.bincount(build, minlength=4 * 2192 + 10)[probe]
    np.testing.assert_array_equal(cnt.numpy(), want)
    mins = {k: bvals[build == k].min() for k in np.unique(probe[want > 0])}
    got = fv.numpy()
    assert all(got[i] == mins[p] for i, p in enumerate(probe) if want[i])


def test_dist_hash_join_defer_reports_overflow():
    out = parallel.dist_hash_join(
        np.arange(64, dtype=np.int32), np.zeros(64, np.int32),
        np.zeros(8 * 64, np.int32), cpu_mesh(), capacity_build=64,
        capacity_probe=4, check="defer")
    dropped_build, dropped_probe = out[-1]
    assert all(isinstance(s, torch.Tensor) for s in dropped_probe.shards)
    assert int(dropped_probe.numpy().sum()) > 0
    assert int(dropped_build.numpy().sum()) == 0


def test_dist_hash_join_rejects_bad_arguments():
    a = np.zeros(8, np.int32)
    with pytest.raises(ValueError):
        parallel.dist_hash_join(a, a, a, cpu_mesh(), capacity_build=8,
                                capacity_probe=8, check="nope")
    with pytest.raises(ValueError):
        parallel.dist_hash_join(a, a, a, cpu_mesh(), capacity_build=8,
                                capacity_probe=8, join_type="outer")
    with pytest.raises(ValueError):
        parallel.dist_hash_join_expand(a, a, a, cpu_mesh(),
                                       capacity_build=8, capacity_probe=8,
                                       capacity_out=8, check="nope")
    with pytest.raises(ValueError):
        parallel.dist_hash_join(a[:6], a[:6], a[:6], cpu_mesh(6),
                                capacity_build=8, capacity_probe=8)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_hash_join_fewer_shards(n_shards):
    found, vals = parallel.dist_hash_join(DIM, DIM_V, FACT,
                                          cpu_mesh(n_shards),
                                          capacity_build=len(DIM),
                                          capacity_probe=len(FACT))
    expect = np.isin(FACT, DIM)
    assert [s.numel() for s in found.shards] == [len(FACT) // n_shards] \
        * n_shards
    np.testing.assert_array_equal(found.numpy(), expect)
    np.testing.assert_array_equal(vals.numpy()[expect], FACT[expect] * 3 + 1)


# --- dist_hash_join_expand ---------------------------------------------------

def _expand_oracle(build, bvals, probe):
    return sorted((i, int(v)) for i, p in enumerate(probe)
                  for v in bvals[build == p])


@pytest.mark.parametrize("check", ["replan", "defer"])
def test_dist_hash_join_expand_matches_jax(jref, check):
    out = parallel.dist_hash_join_expand(
        EXP_B, EXP_V, EXP_P, cpu_mesh(), capacity_build=len(EXP_B),
        capacity_probe=len(EXP_P), capacity_out=EXP_CAP, check=check)
    if check == "defer":
        assert all(int(d.numpy().sum()) == 0 for d in out[3])
    want = jref("expand")
    np.testing.assert_array_equal(out[0].numpy(), want[0])
    got = expansion_pairs(*out[:3])
    assert got == expansion_pairs(*want)
    assert sorted(p for c in got for p in c) == _expand_oracle(EXP_B, EXP_V,
                                                                EXP_P)
    # past each position's total: -1
    t, p = out[0].numpy(), per_position(out[1])
    assert all((p[c, t[c]:] == -1).all() for c in range(8))
    # the pairs of one key come in probe-row order
    for c in range(8):
        rows = p[c, :t[c]]
        keys = EXP_P[rows]
        assert all((keys[1:] > keys[:-1]) | ((keys[1:] == keys[:-1])
                                              & (rows[1:] >= rows[:-1])))


def test_dist_hash_join_expand_truncation_reported():
    build = np.zeros(64, np.uint32)  # every probe matches all 64
    totals, pidx, _ = parallel.dist_hash_join_expand(
        build, np.arange(64, dtype=np.int32), np.zeros(64, np.uint32),
        cpu_mesh(), capacity_build=64, capacity_probe=64, capacity_out=128)
    t = totals.numpy()
    assert t.sum() == 64 * 64 and t.max() > 128
    assert (per_position(pidx) >= 0).sum() == 128


@pytest.mark.parametrize("check", ["replan", "defer"])
def test_dist_hash_join_expand_past_direct_max(check):
    rng = np.random.RandomState(7)
    nb = 4 * 8192
    build = np.repeat(np.arange(nb // 2, dtype=np.uint32), 2)
    bvals = np.arange(nb, dtype=np.int32)
    probe = rng.randint(0, nb // 2 + 100, size=4 * 2048).astype(np.uint32)
    out = parallel.dist_hash_join_expand(
        build, bvals, probe, cpu_mesh(4), capacity_build=2 * 8192,
        capacity_probe=4096, capacity_out=8192, check=check)
    got = sorted(p for c in expansion_pairs(*out[:3], n=4) for p in c)
    want = sorted((i, int(2 * p + j)) for i, p in enumerate(probe)
                  if p < nb // 2 for j in range(2))
    assert got == want and int(out[0].numpy().sum()) == len(want)


# --- dist_group_aggregate ----------------------------------------------------

@pytest.mark.parametrize("check", ["replan", "defer"])
def test_dist_group_aggregate_matches_jax(jref, check):
    out = parallel.dist_group_aggregate(AGG_K, AGG_V, cpu_mesh(),
                                        num_groups=256, capacity=AGG_CAP,
                                        check=check)
    gk, table, cnt = out[:3]
    want_gk, want_table, want_cnt = jref("aggregate")
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    c = cnt.numpy()
    for got, want in ((gk, want_gk), (table, want_table)):
        g, w = per_position(got), per_position(want)
        for p in range(8):
            np.testing.assert_array_equal(g[p, :c[p]], w[p, :c[p]])
    assert group_dict(gk, (table,), cnt) == {
        int(k): (int(AGG_V[AGG_K == k].sum()),) for k in np.unique(AGG_K)}
    if check == "defer":
        assert int(out[3].numpy().sum()) == 0


def test_dist_group_aggregate_sparse_matches_numpy():
    """Local rows past num_groups * 64 (JAX's one-step-short search): held
    to numpy."""
    got = parallel.dist_group_aggregate(AGG_K, AGG_V, cpu_mesh(),
                                        num_groups=256, capacity=N)
    assert group_dict(*got[:1], got[1:2], got[2]) == {
        int(k): (int(AGG_V[AGG_K == k].sum()),) for k in np.unique(AGG_K)}


@pytest.mark.parametrize("dt,keyset", [(np.int32, (-1, -5, 3, 7)),
                                       (np.uint32, (0xFFFFFFFF, 1, 2))])
def test_dist_group_aggregate_extreme_keys(dt, keyset):
    rng = np.random.RandomState(32)
    keys = rng.choice(np.array(keyset, dt), size=8 * 256)
    vals = rng.randint(1, 10, size=8 * 256).astype(np.int32)
    gk, table, cnt = parallel.dist_group_aggregate(
        keys, vals, cpu_mesh(), num_groups=64, capacity=8 * 256)
    assert group_dict(gk, (table,), cnt) == {
        int(k): (int(vals[keys == k].sum()),) for k in np.unique(keys)}


def test_dist_group_aggregate_zipf_replan():
    rng = np.random.default_rng(51)
    n = 8 * 1024
    keys = (rng.zipf(1.2, size=n) % 4096).astype(np.uint32)
    vals = rng.integers(1, 9, size=n).astype(np.int32)
    gk, table, cnt = parallel.dist_group_aggregate(
        keys, vals, cpu_mesh(), num_groups=4096, capacity=n // 64,
        samples_per_chip=64)
    assert group_dict(gk, (table,), cnt) == {
        int(k): (int(vals[keys == k].sum()),) for k in np.unique(keys)}


def test_dist_group_aggregate_cols_matches_jax(jref):
    gk, tables, cnt = parallel.dist_group_aggregate_cols(
        COLS_K, (COLS_V1, COLS_V1, COLS_V2, COLS_V2, COLS_V1), COLS_AGGS,
        cpu_mesh(), num_groups=128, capacity=N // 16)
    want_gk, want_tables, want_cnt = jref("aggregate cols")
    c = cnt.numpy()
    np.testing.assert_array_equal(c, np.asarray(want_cnt))
    for got, want in zip((gk, *tables), (want_gk, *want_tables)):
        g, w = per_position(got), per_position(want)
        assert g.dtype == w.dtype
        for p in range(8):
            np.testing.assert_array_equal(g[p, :c[p]], w[p, :c[p]])
    got = group_dict(gk, tables, cnt)
    for k in np.unique(COLS_K):
        m = COLS_K == k
        s, mn, mx, n, mean = got[int(k)]
        assert (s, mn, mx, n) == (COLS_V1[m].sum(), COLS_V1[m].min(),
                                  COLS_V2[m].max(), m.sum())
        assert abs(mean - COLS_V1[m].mean()) <= 1e-6 * np.abs(
            COLS_V1[m]).sum()


def test_dist_group_aggregate_cols_float_measures():
    """float32 sums (differences of a position's running sum) within 1e-6
    of the running sum of |x|; min over float32 and max and sum over
    uint64 exact."""
    rng = np.random.RandomState(85)
    keys = rng.randint(0, 30, size=N).astype(np.uint32)
    x = rng.standard_normal(N).astype(np.float32)
    x[:2] = [-0.0, 0.0]
    y = rng.randint(0, 2 ** 40, size=N).astype(np.uint64)
    gk, tables, cnt = parallel.dist_group_aggregate_cols(
        keys, (x, x, y, y), ("sum", "min", "max", "sum"), cpu_mesh(),
        num_groups=64, capacity=N // 8)
    got = group_dict(gk, tables, cnt)
    assert set(got) == set(np.unique(keys).tolist())
    tol = 1e-6 * np.abs(x.astype(np.float64)).sum()
    for k, (s, mn, mx, sy) in got.items():
        m = keys == k
        assert abs(s - x[m].astype(np.float64).sum()) <= tol
        assert mn == x[m].min() and mx == y[m].max() and sy == y[m].sum()


def test_dist_group_aggregate_rejects_bad_arguments():
    a = np.zeros(8, np.int32)
    with pytest.raises(ValueError):
        parallel.dist_group_aggregate(a, a, cpu_mesh(), num_groups=8,
                                      capacity=8, check="nope")
    with pytest.raises(ValueError, match="equal-length"):
        parallel.dist_group_aggregate_cols(a, (a,), ("sum", "min"),
                                           cpu_mesh(), num_groups=8,
                                           capacity=8)
    with pytest.raises(ValueError):
        parallel.dist_group_aggregate(a, a, cpu_mesh(), num_groups=8,
                                      capacity=8, agg="median")


def test_dist_group_aggregate_defer_reports_overflow():
    keys = np.zeros(8 * 64, np.uint32)
    *_, dropped = parallel.dist_group_aggregate(
        keys, np.ones(8 * 64, np.int32), cpu_mesh(), num_groups=8,
        capacity=4, check="defer")
    assert int(dropped.numpy().sum()) == 8 * 64 - 8 * 4


# --- dist_window_cols --------------------------------------------------------

def _single_card_window(keys, order, values, aggs, **kw):
    def t(a):
        return None if a is None else interop.to_torch(a, "cpu")
    out = window_cols(t(keys), t(order), tuple(t(v) for v in values), aggs,
                      **kw)
    if kw.get("sorted_output"):
        return [interop.to_numpy(c) for c in out[0]], \
            interop.to_numpy(out[1])
    return [interop.to_numpy(c) for c in out]


def test_dist_window_cols_matches_jax(jref):
    keys, order, vals = WIN
    values = tuple(None if a in _NO_MEASURE else vals for a in ALL_AGGS)
    got = parallel.dist_window_cols(keys, order, values, ALL_AGGS,
                                    cpu_mesh())
    for a, g, w in zip(ALL_AGGS, got, jref("window")):
        g = g.numpy()
        assert g.dtype == w.dtype, a
        if a == "mean":
            assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w) + 1e-6), a
        else:
            np.testing.assert_array_equal(g, w, err_msg=a)


@pytest.mark.parametrize("n,n_keys,n_shards", [(8 * 200, 1, 8),
                                               (8 * 125, 6, 2),
                                               (8 * 125, 6, 4)])
def test_dist_window_cols_matches_single_card(n, n_keys, n_shards):
    keys, order, vals = _window_case(n, n_keys, 3)
    values = tuple(None if a in _NO_MEASURE else vals for a in ALL_AGGS)
    got = parallel.dist_window_cols(keys, order, values, ALL_AGGS,
                                    cpu_mesh(n_shards))
    want = _single_card_window(keys, order, values, ALL_AGGS)
    for a, g, w in zip(ALL_AGGS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=a)


def test_dist_window_partition_straddles_positions():
    n = 8 * 64
    keys = np.zeros(n, np.uint32)
    keys[:n // 2] = 7  # one partition across positions 0..3
    order = np.arange(n, dtype=np.int32) % 13
    vals = np.arange(n, dtype=np.uint32) % 97
    aggs = ("sum", "row_number", "lag", "lead")
    values = (vals, None, vals, vals)
    got = parallel.dist_window_cols(keys, order, values, aggs, cpu_mesh())
    want = _single_card_window(keys, order, values, aggs)
    for a, g, w in zip(aggs, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=a)


def test_dist_window_exclusive_and_sorted_output():
    keys, order, vals = _window_case(8 * 40, 4, 11)
    aggs = ("sum", "count", "mean")
    values = (vals, None, vals)
    want = _single_card_window(keys, order, values, aggs, exclusive=True)
    got = parallel.dist_window_cols(keys, order, values, aggs, cpu_mesh(),
                                    exclusive=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    cols, row_src = parallel.dist_window_cols(
        keys, order, values, aggs, cpu_mesh(), exclusive=True,
        sorted_output=True)
    wcols, wsrc = _single_card_window(keys, order, values, aggs,
                                      exclusive=True, sorted_output=True)
    np.testing.assert_array_equal(row_src.numpy(), wsrc)
    for g, w in zip(cols, wcols):
        np.testing.assert_array_equal(g.numpy(), w)
    restored = np.zeros_like(cols[0].numpy())
    restored[row_src.numpy()] = cols[0].numpy()
    np.testing.assert_array_equal(restored, want[0])


def test_dist_window_u64_keys_and_scan():
    rng = np.random.RandomState(5)
    n = 8 * 32
    keys = (rng.randint(0, 3, size=n).astype(np.uint64) << np.uint64(40)
            | np.uint64(123))
    vals = rng.randint(0, 100, size=n).astype(np.int32)
    want = _single_card_window(keys, None, (vals,), ("sum",))[0]
    got = parallel.dist_window_scan(keys, vals, cpu_mesh())
    np.testing.assert_array_equal(got.numpy(), want)


def test_dist_window_many_measure_columns():
    """Measures and outputs wider than the fused sort's 8 columns ride
    further sorts under the same (key, order, position) prefix."""
    rng = np.random.RandomState(12)
    n = 8 * 64
    keys = rng.randint(0, 5, size=n).astype(np.uint64)
    order = rng.randint(0, 9, size=n).astype(np.int64)
    ms = [rng.randint(0, 2 ** 40, size=n).astype(np.uint64)
          for _ in range(3)]
    aggs = ("sum", "max", "lag", "row_number", "lead", "min")
    values = (ms[0], ms[1], ms[2], None, ms[0], ms[1])
    got = parallel.dist_window_cols(keys, order, values, aggs, cpu_mesh())
    want = _single_card_window(keys, order, values, aggs)
    for a, g, w in zip(aggs, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=a)


def test_dist_window_validation():
    keys, order, vals = _window_case(64, 3, 1)
    for args in (((vals,), ("bogus",)), ((None,), ("sum",)),
                 ((vals, vals), ("sum",))):
        with pytest.raises(ValueError):
            parallel.dist_window_cols(keys, order, *args, cpu_mesh())
    with pytest.raises(ValueError):
        parallel.dist_window_cols(keys, None, (None,), ("rank",), cpu_mesh())


# --- dist_top_k and dist_distinct --------------------------------------------

@pytest.mark.parametrize("largest", [False, True])
def test_dist_top_k_matches_single_card(jref, largest):
    tv, tp = parallel.dist_top_k(TOPK_V, 37, cpu_mesh(), TOPK_P,
                                 largest=largest)
    assert tv.layout == parallel.replicated(tv.mesh)
    order = np.argsort(-TOPK_V.astype(np.int64) if largest else TOPK_V,
                       kind="stable")[:37]
    np.testing.assert_array_equal(tv.numpy(), TOPK_V[order])
    np.testing.assert_array_equal(tp.numpy(), TOPK_P[order])
    ref = top_k(interop.to_torch(TOPK_V, "cpu"), 37,
                interop.to_torch(TOPK_P, "cpu"), largest=largest)
    np.testing.assert_array_equal(tv.numpy(), interop.to_numpy(ref[0]))
    if not largest:
        np.testing.assert_array_equal(tp.numpy(), jref("top_k")[1])


def test_dist_top_k_k_exceeds_shard_and_sampling_options():
    vals = np.random.RandomState(9).randint(0, 50, size=8 * 16).astype(
        np.uint32)
    (got,) = parallel.dist_top_k(vals, 40, cpu_mesh())
    np.testing.assert_array_equal(got.numpy(), np.sort(vals)[:40])
    big = np.random.RandomState(10).permutation(8 * 4096).astype(np.int32)
    (got,) = parallel.dist_top_k(big, 5, cpu_mesh(), oversample=8,
                                 sample_size=1024)
    np.testing.assert_array_equal(got.numpy(), np.arange(5))


def test_dist_top_k_positions_payload():
    n = 8 * 64
    vals = np.random.RandomState(4).randint(0, 1000, n).astype(np.uint32)
    mesh = cpu_mesh()
    tv, tp = parallel.dist_top_k(vals, 10, mesh, iota_sharded(n, mesh))
    order = np.argsort(vals, kind="stable")[:10]
    np.testing.assert_array_equal(tp.numpy(), order)
    np.testing.assert_array_equal(tv.numpy(), vals[order])


def test_dist_top_k_validation():
    vals = np.arange(16, dtype=np.uint32)
    for k in (0, 17):
        with pytest.raises(ValueError):
            parallel.dist_top_k(vals, k, cpu_mesh())
    with pytest.raises(ValueError):
        parallel.dist_top_k(np.arange(12, dtype=np.uint32), 3, cpu_mesh())


def test_dist_distinct():
    keys = np.random.RandomState(31).randint(0, 97, 8 * 250).astype(
        np.uint32)
    uniq, cnt = parallel.dist_distinct(keys, cpu_mesh(), capacity=128)
    expect = np.unique(keys)
    assert uniq.layout == parallel.replicated(uniq.mesh)
    assert int(cnt.numpy()) == len(expect)
    np.testing.assert_array_equal(uniq.numpy()[:len(expect)], expect)


def test_dist_distinct_skewed_to_one_value():
    uniq, cnt = parallel.dist_distinct(np.full(8 * 32, 42, np.uint32),
                                       cpu_mesh(), capacity=16)
    assert int(cnt.numpy()) == 1 and int(uniq.numpy()[0]) == 42
