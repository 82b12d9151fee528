"""The distributed layer of cl_ops_tpu_torch against cl_ops_tpu's.

The port runs on eight CPU shards (`make_mesh(devices=["cpu"] * 8)`), and
on two and four where the hypercube's depth matters; the JAX package runs
on tests/conftest.py's 8-device CPU mesh with use_pallas=False. Outputs
that JAX makes deterministic (sorted rows, exchange buffers, splitters,
integer scans) are held to it bit for bit; float32 scans within 1e-6 of
the running sum of |x|; the 32-bit `dist_scan` after the cast of JAX's
widened result (its own test pins that fault).

Each JAX result is computed once per module (`jref`), jitted: outside jit
`shard_map` runs op by op and compiles every op (7-15 s a sort). The JAX
dist_sort_sample and keyed_exchange_replan read counters on the host and
cannot be jitted whole; for them the JAX package's own partition_exchange
and plan_splitters are swapped for jitted calls of themselves.
"""

import functools

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import parallel
from cl_ops_tpu_torch.core.errors import CloOpsError
from cl_ops_tpu_torch.parallel import mesh as pmesh
from cl_ops_tpu_torch.parallel import splitters as tsp

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jpar = pytest.importorskip("cl_ops_tpu.parallel")
jsp = pytest.importorskip("cl_ops_tpu.parallel.splitters")
host_segmented_scan = pytest.importorskip(
    "tests.test_segmented").host_segmented_scan


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


# --- inputs, made from seeds -------------------------------------------------

N = 8 * 512


def _u32(seed, n=N, hi=2 ** 32):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


SCAN_U32 = _u32(0, hi=1000)
SCAN_I32 = np.random.default_rng(1).integers(-1000, 1000, N).astype(np.int32)
# sums pass 2^32 within every shard
SCAN_WRAP = _u32(2, hi=2 ** 32) | np.uint32(1 << 31)
SEG_X = np.random.RandomState(17).randint(0, 1000, N).astype(np.uint32)
SEG_FLAGS = (np.random.RandomState(18).rand(N) < 0.004).astype(np.int32)
SEG_FLAGS[512] = 1             # on a shard boundary
SEG_FLAGS[3 * 512:5 * 512] = 0  # a run over more than two shards
FLOATS = np.random.default_rng(3).standard_normal(N).astype(np.float32)
FLOATS[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0]
SORT_CASES = {
    "u32": (_u32(10), {}),
    "i32 descending": (_u32(11).view(np.int32), {"ascending": False}),
    "u64": (np.random.default_rng(12).integers(0, 2 ** 64, N,
                                               dtype=np.uint64), {}),
    "f32": (FLOATS, {}),
    "i32 8x1000": (np.random.default_rng(13).integers(
        -50, 50, 8 * 1000).astype(np.int32), {}),
}
KV_KEYS = _u32(14, n=8 * 256, hi=100)
KV_VALS = np.arange(8 * 256, dtype=np.int32)
COLS3 = tuple(np.random.default_rng(15 + i).integers(-4, 4, N).astype(
    np.int32) for i in range(3))
PE_DATA = _u32(20, hi=1 << 30)
PE_EXTRA = np.arange(N, dtype=np.int32) * 3
ZIPF = (np.random.default_rng(40).zipf(1.3, N) % (1 << 20)).astype(np.uint32)
SAMPLE_U32 = _u32(41, hi=1 << 30)
SAMPLE_I32 = np.random.RandomState(42).randint(-(1 << 20), 1 << 20,
                                               N).astype(np.int32)
# the replan case of tests/test_parallel.py: one zipf side that overflows,
# one that never does
HEAVY = (np.random.default_rng(70).zipf(1.1, N) % 256).astype(np.uint32)
LIGHT = np.arange(8 * 64, dtype=np.uint32)
REPLAN = dict(capacities=(len(LIGHT), N // 64), max_replan=6,
              samples_per_chip=16, splitter_side=1)
SEG_CASES = [("add", True), ("add", False), ("min", False), ("max", True)]
SCAN_CASES = [(x, sd, exclusive) for x, sd in ((SCAN_U32, np.uint64),
                                               (SCAN_I32, np.int64))
              for exclusive in (True, False)]


# --- the JAX side, each result computed once ---------------------------------

def _np(*arrays):
    out = tuple(np.asarray(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def _jit_splitters(monkeypatch, mesh):
    """Swap the JAX package's partition_exchange and plan_splitters (as
    dist_sort_sample and keyed_exchange_replan call them) for jitted calls
    of themselves, one per static argument set."""
    pe, ps = jsp.partition_exchange, jsp.plan_splitters

    @functools.cache
    def pe_fn(capacity, n_extra):
        return jax.jit(lambda d, p, *e: pe(d, p, mesh, capacity=capacity,
                                           extra_cols=e))

    @functools.cache
    def ps_fn(samples):
        return jax.jit(lambda k: ps(k, mesh, samples_per_chip=samples))

    monkeypatch.setattr(jsp, "partition_exchange",
                        lambda d, p, m, *, capacity, axis="data",
                        extra_cols=(): pe_fn(capacity, len(extra_cols))(
                            d, p, *extra_cols))
    monkeypatch.setattr(jsp, "plan_splitters",
                        lambda k, m, *, samples_per_chip=256, axis="data":
                        ps_fn(samples_per_chip)(k))


def _jax_cases(mesh):
    def jit(fn, *args):
        return jax.jit(fn)(*args)

    def scan(x, sd, exclusive):
        return _np(jit(lambda a: jpar.dist_scan(
            a, mesh, sum_dtype=sd, exclusive=exclusive, use_pallas=False), x))

    def seg(op, exclusive):
        return _np(jit(lambda a, f: jpar.dist_segmented_scan(
            a, f, mesh, op=op, exclusive=exclusive, use_pallas=False),
            SEG_X, SEG_FLAGS))

    def sort(x, kw):
        return _np(jit(lambda a: jpar.dist_sort(a, mesh, use_pallas=False,
                                                **kw), x))

    def with_fast_splitters(fn):
        def run():
            with pytest.MonkeyPatch.context() as mp:
                _jit_splitters(mp, mesh)
                return fn()
        return run

    def sample_sort(x):
        totals, buf, dropped = jsp.dist_sort_sample(jnp.asarray(x), mesh,
                                                    capacity_factor=4.0)
        return _np(totals, buf, dropped)

    def replan():
        res, caps = jsp.keyed_exchange_replan(
            [(jnp.asarray(LIGHT), ()), (jnp.asarray(HEAVY), ())], mesh,
            **REPLAN)
        return [_np(*r) for r in res], caps

    def once():
        res, drops = jit(lambda a, b: jsp.keyed_exchange_once(
            [(a, ()), (b, ())], mesh, capacities=(64, 64)), LIGHT, HEAVY)
        return [_np(*r) for r in res], [_np(d) for d in drops]

    cases = {
        **{f"scan {x.dtype} {sd.__name__} {exclusive}":
           functools.partial(scan, x, sd, exclusive)
           for x, sd, exclusive in SCAN_CASES},
        "scan u32 u32 wrap": lambda: scan(SCAN_WRAP, np.uint32, True),
        "sort kv": lambda: _np(*jit(lambda a, v: jpar.dist_sort(
            a, mesh, values=v, use_pallas=False), KV_KEYS, KV_VALS)),
        "sort cols3": lambda: _np(*jit(lambda *c: jpar.dist_sort_i32_cols(
            c, mesh, use_pallas=False), *COLS3)),
        "partition_exchange": lambda: _np(*jit(
            lambda d, p, e: jpar.partition_exchange(
                d, p, mesh, capacity=256, extra_cols=(e,)),
            PE_DATA, (PE_DATA % 8).astype(np.int32), PE_EXTRA)),
        "plan_splitters": lambda: _np(jit(
            lambda k: jpar.plan_splitters(k, mesh), ZIPF)),
        "range_partition_exchange": lambda: _np(*jit(
            lambda k: jpar.range_partition_exchange(
                k, jpar.plan_splitters(k, mesh), mesh, capacity=N // 64,
                extra_cols=(k,)), ZIPF)),
        "sample u32": with_fast_splitters(lambda: sample_sort(SAMPLE_U32)),
        "sample i32": with_fast_splitters(lambda: sample_sort(SAMPLE_I32)),
        "replan": with_fast_splitters(replan),
        "once": once,
    }
    for op, exclusive in SEG_CASES:
        cases[f"seg {op} {exclusive}"] = functools.partial(seg, op, exclusive)
    for name, (x, kw) in SORT_CASES.items():
        cases[f"sort {name}"] = functools.partial(sort, x, kw)
    return cases



@pytest.fixture(scope="module")
def jref():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    cases = _jax_cases(jpar.make_mesh(8))
    return functools.cache(lambda name: cases[name]())


# --- dist_scan ---------------------------------------------------------------

@pytest.mark.parametrize("x,sd,exclusive", SCAN_CASES)
def test_dist_scan_matches_jax(jref, x, sd, exclusive):
    out = parallel.dist_scan(x, cpu_mesh(), sum_dtype=sd, exclusive=exclusive)
    want = jref(f"scan {x.dtype} {sd.__name__} {exclusive}")
    assert out.dtype == (torch.int64 if sd == np.int64 else torch.uint64)
    np.testing.assert_array_equal(out.numpy(), want)


def test_dist_scan_u32_wraps_in_sum_dtype(jref):
    out = parallel.dist_scan(SCAN_WRAP, cpu_mesh(), sum_dtype=np.uint32)
    want = np.cumsum(SCAN_WRAP, dtype=np.uint32) - SCAN_WRAP
    assert out.dtype == torch.uint32
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(),
                                  jref("scan u32 u32 wrap").astype(np.uint32))


def test_dist_scan_jax_widens_32_bit_sum_dtype(jref):
    """The JAX fault the port does not copy: a uint32 sum_dtype comes back
    as uint64, with sums that were never reduced mod 2^32."""
    got = jref("scan u32 u32 wrap")
    assert got.dtype == np.uint64
    assert (got >= 1 << 32).any()


@pytest.mark.parametrize("exclusive", [True, False])
def test_dist_scan_float32_within_tolerance(exclusive):
    x = np.random.default_rng(4).uniform(-1, 1, N).astype(np.float32)
    out = parallel.dist_scan(x, cpu_mesh(), sum_dtype=np.float32,
                             exclusive=exclusive).numpy()
    x64 = x.astype(np.float64)
    want = np.cumsum(x64) - (x64 if exclusive else 0)
    tol = 1e-6 * np.cumsum(np.abs(x64)) + 1e-6
    assert out.dtype == np.float32
    assert (np.abs(out - want) <= tol).all()


def test_dist_scan_uneven_rejected():
    with pytest.raises(ValueError):
        parallel.dist_scan(np.arange(9, dtype=np.uint32), cpu_mesh(),
                           sum_dtype=np.uint64)


# --- dist_segmented_scan -----------------------------------------------------

@pytest.mark.parametrize("op,exclusive", SEG_CASES)
def test_dist_segmented_scan_matches_jax(jref, op, exclusive):
    out = parallel.dist_segmented_scan(SEG_X, SEG_FLAGS, cpu_mesh(), op=op,
                                       exclusive=exclusive)
    want = jref(f"seg {op} {exclusive}")
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), host_segmented_scan(
        SEG_X, SEG_FLAGS, np.uint32, exclusive, op))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_segmented_scan_fewer_shards(jref, n_shards):
    out = parallel.dist_segmented_scan(SEG_X, SEG_FLAGS, cpu_mesh(n_shards),
                                       op="max", exclusive=True)
    np.testing.assert_array_equal(out.numpy(), jref("seg max True"))


def test_dist_segmented_scan_no_flags():
    x = np.arange(N, dtype=np.uint32)
    out = parallel.dist_segmented_scan(x, np.zeros(N, np.int32), cpu_mesh(),
                                       exclusive=False)
    np.testing.assert_array_equal(out.numpy(),
                                  np.cumsum(x).astype(np.uint32))


def test_dist_segmented_scan_int64_add_wraps():
    x = np.random.default_rng(5).integers(-2 ** 63, 2 ** 63, N,
                                          dtype=np.int64)
    out = parallel.dist_segmented_scan(x, SEG_FLAGS, cpu_mesh(),
                                       exclusive=False).numpy()
    np.testing.assert_array_equal(out, host_segmented_scan(
        x, SEG_FLAGS, np.int64, False, "add"))


# --- dist_sort ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(SORT_CASES))
def test_dist_sort_matches_jax(jref, name):
    x, kw = SORT_CASES[name]
    out = parallel.dist_sort(x, cpu_mesh(), **kw).numpy()
    want = jref(f"sort {name}")
    assert out.dtype == want.dtype
    np.testing.assert_array_equal(out.view(f"u{out.itemsize}"),
                                  want.view(f"u{want.itemsize}"))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("name", ["u32", "u64", "i32 8x1000"])
def test_dist_sort_fewer_shards(jref, name, n_shards):
    x, kw = SORT_CASES[name]
    out = parallel.dist_sort(x, cpu_mesh(n_shards), **kw)
    assert [s.numel() for s in out.shards] == [len(x) // n_shards] * n_shards
    np.testing.assert_array_equal(out.numpy(), jref(f"sort {name}"))


def test_dist_sort_key_value_matches_jax(jref):
    out, vout = parallel.dist_sort(KV_KEYS, cpu_mesh(), values=KV_VALS)
    want, wvals = jref("sort kv")
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(vout.numpy(), wvals)
    np.testing.assert_array_equal(KV_KEYS[vout.numpy()], out.numpy())


@pytest.mark.parametrize("n_shards", [2, 8])
def test_dist_sort_i32_cols_matches_jax(jref, n_shards):
    out = parallel.dist_sort_i32_cols(COLS3, cpu_mesh(n_shards))
    for got, want in zip(out, jref("sort cols3")):
        np.testing.assert_array_equal(got.numpy(), want)


def test_dist_sort_rejects_uneven_and_non_po2_meshes():
    with pytest.raises(ValueError):
        parallel.dist_sort(np.arange(12, dtype=np.int32), cpu_mesh(8))
    with pytest.raises(ValueError):
        parallel.dist_sort(np.arange(12, dtype=np.int32), cpu_mesh(3))


# --- the exchange ------------------------------------------------------------

def test_partition_exchange_matches_jax(jref):
    out = parallel.partition_exchange(
        PE_DATA, (PE_DATA % 8).astype(np.int32), cpu_mesh(), capacity=256,
        extra_cols=(PE_EXTRA,))
    for got, want in zip(out, jref("partition_exchange")):
        np.testing.assert_array_equal(got.numpy(), want)
    counts = out[0].numpy().reshape(8, 8)  # [dst, src]
    buf = out[2].numpy().reshape(8, 8, 256)
    for dst in range(8):
        got = np.concatenate([buf[dst, s, :counts[dst, s]] for s in range(8)])
        # source order kept within each bucket
        np.testing.assert_array_equal(got, PE_DATA[PE_DATA % 8 == dst])


def test_partition_exchange_overflow():
    data = np.arange(8 * 64, dtype=np.uint32)
    counts, dropped, out = parallel.partition_exchange(
        data, np.zeros(len(data), np.int32), cpu_mesh(), capacity=16)
    assert int(dropped.numpy().sum()) == len(data) - 8 * 16
    np.testing.assert_array_equal(counts.numpy().reshape(8, 8)[0], 16)
    np.testing.assert_array_equal(out.numpy().reshape(8, 8, 16)[0],
                                  data.reshape(8, 64)[:, :16])


def test_plan_splitters_match_jax_and_balance(jref):
    spl = parallel.plan_splitters(ZIPF, cpu_mesh())
    assert spl.layout == parallel.replicated(spl.mesh)
    assert all(torch.equal(s, spl.shards[0]) for s in spl.shards)
    np.testing.assert_array_equal(spl.numpy(), jref("plan_splitters"))
    counts = np.bincount(np.searchsorted(spl.numpy(), ZIPF), minlength=8)
    assert counts.max() < 3 * (len(ZIPF) / 8)


@pytest.mark.parametrize("name,x", [("sample u32", SAMPLE_U32),
                                    ("sample i32", SAMPLE_I32)])
def test_dist_sort_sample_matches_jax(jref, name, x):
    totals, buf, dropped = parallel.dist_sort_sample(x, cpu_mesh(),
                                                     capacity_factor=4.0)
    wt, wbuf, wdrop = jref(name)
    assert int(dropped.numpy().sum()) == 0 == int(wdrop.sum())
    np.testing.assert_array_equal(totals.numpy(), wt)
    got, want = buf.numpy().reshape(8, -1), wbuf.reshape(8, -1)
    for c in range(8):
        np.testing.assert_array_equal(got[c, :wt[c]], want[c, :wt[c]])
    np.testing.assert_array_equal(
        np.concatenate([got[c, :wt[c]] for c in range(8)]), np.sort(x))


def test_range_partition_exchange_matches_jax(jref):
    """With the planned splitters (and the same keys given as a host
    array), and with some rows dropped past the capacity."""
    spl = parallel.plan_splitters(ZIPF, cpu_mesh())
    want = jref("range_partition_exchange")
    assert int(want[1].sum()) > 0
    for splitters in (spl, spl.numpy()):
        got = parallel.range_partition_exchange(
            ZIPF, splitters, cpu_mesh(), capacity=N // 64, extra_cols=(ZIPF,))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_chips", [1, 2, 8])
def test_hash_partition_ids_match_jax(n_chips):
    keys = np.concatenate([_u32(7), np.array([0, 2 ** 32 - 1], np.uint32)])
    got = tsp.hash_partition_ids(torch.from_numpy(keys.view(np.int32))
                                 .view(torch.uint32), n_chips)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsp.hash_partition_ids(jnp.asarray(keys),
                                                       n_chips)))


# --- keyed_exchange_replan and keyed_exchange_once ---------------------------

def test_keyed_exchange_replan_reuses_clean_sides(monkeypatch):
    """Capacity-doubling rounds keep the plan fixed: sides that did not
    overflow must not run their exchange again."""
    calls = []
    orig = tsp.partition_exchange

    def counting(data, pid, mesh, **kw):
        calls.append(data.shape[0])
        return orig(data, pid, mesh, **kw)

    monkeypatch.setattr(tsp, "partition_exchange", counting)
    _, caps = parallel.keyed_exchange_replan([(LIGHT, ()), (HEAVY, ())],
                                             cpu_mesh(), **REPLAN)
    light_calls = calls.count(len(LIGHT))
    assert light_calls <= 3, calls
    assert calls.count(N) >= light_calls
    assert caps[0] == len(LIGHT)


def test_keyed_exchange_replan_matches_jax(jref):
    (lres, hres), caps = parallel.keyed_exchange_replan(
        [(LIGHT, ()), (HEAVY, ())], cpu_mesh(), **REPLAN)
    wres, wcaps = jref("replan")
    assert caps == wcaps and caps[1] > REPLAN["capacities"][1]
    for got, want in zip((lres, hres), wres):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_keyed_exchange_replan_raises_after_max_replan():
    keys = np.zeros(N, np.uint32)  # one key: no plan splits it
    with pytest.raises(RuntimeError, match="overflow persists"):
        parallel.keyed_exchange_replan([(keys, ())], cpu_mesh(),
                                       capacities=(8,), max_replan=3)


def test_keyed_exchange_once_keeps_counters_on_device(jref):
    res, drops = parallel.keyed_exchange_once(
        [(LIGHT, ()), (HEAVY, ())], cpu_mesh(), capacities=(64, 64))
    wres, wdrops = jref("once")
    for d, w in zip(drops, wdrops):
        assert all(isinstance(s, torch.Tensor) for s in d.shards)
        np.testing.assert_array_equal(d.numpy(), w)
    assert int(drops[1].numpy().sum()) > 0 == int(drops[0].numpy().sum())
    for got, want in zip(res, wres):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_keyed_exchange_rejects_unknown_partition():
    with pytest.raises(ValueError):
        parallel.keyed_exchange_once([(LIGHT, ())], cpu_mesh(),
                                     capacities=(64,), partition="zorder")


# --- the mesh ----------------------------------------------------------------

def test_make_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CloOpsError):
        parallel.make_mesh()
    with pytest.raises(CloOpsError):
        parallel.make_mesh(4)
    with pytest.raises(CloOpsError):
        parallel.make_mesh(devices=["cuda:0"] * 4)


def test_make_mesh_devices_may_repeat():
    mesh = parallel.make_mesh(2, devices=["cpu"] * 8)
    assert mesh.size == 2 and mesh.shape == {parallel.DATA_AXIS: 2}
    assert mesh == cpu_mesh(2)


def test_put_sharded():
    mesh = cpu_mesh()
    x = np.arange(N, dtype=np.uint32)
    s = pmesh.put_sharded(x, mesh)
    assert pmesh.put_sharded(s, mesh) is s
    assert s.shape == (N,) and s.dtype == torch.uint32
    assert [t.numel() for t in s.shards] == [N // 8] * 8
    np.testing.assert_array_equal(s.numpy(), x)
    again = pmesh.put_sharded(s, cpu_mesh(4))
    np.testing.assert_array_equal(again.numpy(), x)
    with pytest.raises(ValueError):
        pmesh.put_sharded(np.arange(9), mesh)


def test_iota_sharded_and_replicated_sum_int():
    mesh = cpu_mesh()
    iota = pmesh.iota_sharded(N, mesh)
    np.testing.assert_array_equal(iota.numpy(), np.arange(N, dtype=np.int32))
    x = _u32(6)
    assert pmesh.replicated_sum_int(x, mesh) == int(x.astype(np.int64).sum())
    assert pmesh.replicated_sum_int(iota, mesh) == N * (N - 1) // 2


def test_collectives_copy_and_route():
    """No collective hands out the sender's memory, though every position
    lies on the same device; routing follows jax.lax's collectives."""
    mesh = cpu_mesh(4)
    per = [torch.full((3,), i + 1, dtype=torch.int32) for i in range(4)]
    buckets = [torch.full((4, 2), 10 * s, dtype=torch.int32)
               + torch.arange(4, dtype=torch.int32).view(4, 1)
               for s in range(4)]
    gathered = mesh.all_gather(per)
    perm = mesh.ppermute(per, [(0, 1), (1, 2), (2, 3)])
    a2a = mesh.all_to_all(buckets)
    ptrs = {t.data_ptr() for t in per + buckets}
    for out in (gathered, perm, a2a):
        assert not ptrs & {t.data_ptr() for t in out}
    assert gathered[2].tolist() == [1] * 3 + [2] * 3 + [3] * 3 + [4] * 3
    # a position that receives nothing gets zeros
    assert [t.tolist() for t in perm] == [[0] * 3, [1] * 3, [2] * 3, [3] * 3]
    # position d receives bucket d of every source, in source order
    assert a2a[1].tolist() == [1, 1, 11, 11, 21, 21, 31, 31]
    assert mesh.sum_to_host(per) == 3 * (1 + 2 + 3 + 4)
