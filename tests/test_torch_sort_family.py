"""sbitonic, abitonic's single_launch=1 and autotune=1, gselect and the
vendor sorter "xla" of cl_ops_tpu_torch against cl_ops_tpu's.

The JAX side runs its Pallas kernels in interpret mode (sbitonic at
block_rows=8, as tests/test_sort.py runs it). All comparisons are exact:
sorted keys bit for bit; values bit for bit where the sort is stable
(gselect, xla) or the keys have no ties. sbitonic and the single-launch
sort run the fused schedule's network step for step, so they also equal the
port's abitonic bit for bit, ties on a key prefix included.
"""

import json

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch.core.dtypes import type_by_name
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import psort as tps
from cl_ops_tpu_torch.ops.sort import autotune as tat
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as tbk
from cl_ops_tpu_torch.ops import sort as tsort

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jsort = pytest.importorskip("cl_ops_tpu.ops.sort")

from test_torch_sort import _rand  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_sort_names_match_jax():
    assert tsort.sort_names() == jsort.sort_names() == [
        "abitonic", "gselect", "satradix", "sbitonic", "xla"]


# --- sbitonic -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "duplicates and extremes"])
def test_sbitonic_matches_jax(case):
    if case == "random":
        x = _rand(np.uint32, 3000, 21)
    else:
        x = np.array([0, 0xFFFFFFFF, 5, 0xFFFFFFFF, 0, 7] * 200, np.uint32)
    want = jsort.sort_new("sbitonic", "block_rows=8").sort_with_host_data(x)
    got = tsort.sort_new("sbitonic", "block_elems=1024").sort_with_host_data(
        x, device="cpu")
    _bits_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("num_keys", [1, 2, 3, None])
def test_sbitonic_equals_fused_schedule(num_keys):
    """The same network as bitonic_sort_2d: bit for bit, ties included."""
    rng = np.random.default_rng(22)
    cols = [rng.integers(0, 4, 4096).astype(np.int32),
            rng.integers(0, 3, 4096).astype(np.int32),
            rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)]
    fused = tbk.bitonic_sort_2d([torch.from_numpy(c.copy()) for c in cols],
                                block_elems=256, merge_elems=1024,
                                num_keys=num_keys)
    tbk.reset_launches()
    steps = tbk.sbitonic_sort_2d([torch.from_numpy(c.copy()) for c in cols],
                                 num_keys=num_keys)
    for a, b in zip(steps, fused):
        assert torch.equal(a, b)
    assert tbk.launches["pair_cross"] == 0  # plain versions on the CPU
    assert tbk.sbitonic_steps(4096) == 78


def test_sbitonic_sorter_kv_and_options():
    x = _rand(np.uint64, 1500, 23)
    vals = np.arange(1500, dtype=np.int32)
    s = tsort.sort_new("sbitonic", elem_dtype="ulong")
    assert s.in_place and s.num_kernels == 1 and s.kernel_name(0) == \
        "pair_cross"
    k, v = s.sort_with_host_data(x, vals, device="cpu")
    np.testing.assert_array_equal(k, np.sort(x))
    np.testing.assert_array_equal(x[v], k)
    with pytest.raises(BadArgsError):
        tsort.sort_new("sbitonic", "block_elems=1000")


# --- single_launch=1 ----------------------------------------------------------

@pytest.mark.parametrize("dt", ["uint", "int", "ulong", "float"])
def test_single_launch_matches_jax(dt):
    x = _rand(type_by_name(dt).np_dtype, 5000, 11)
    want = jsort.sort_new("abitonic", "single_launch=1",
                          elem_dtype=dt).sort_with_host_data(x)
    tbk.reset_launches()
    got = tsort.sort_new("abitonic", "single_launch=1",
                         elem_dtype=dt).sort_with_host_data(x, device="cpu")
    _bits_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))
    assert sum(tbk.launches.values()) == 0


def test_single_launch_kv_matches_jax():
    x = _rand(np.uint32, 4096, 12)
    assert np.unique(x).size == x.size  # no ties: values are comparable
    vals = np.arange(4096, dtype=np.int32)
    wk, wv = jsort.sort_new("abitonic", "single_launch=1"
                            ).sort_with_host_data(x, vals)
    gk, gv = tsort.sort_new("abitonic", "single_launch=1"
                            ).sort_with_host_data(x, vals, device="cpu")
    _bits_equal(gk, wk)
    _bits_equal(gv, wv)


@pytest.mark.parametrize("n,n_cols,num_keys,hi", [
    (8192, 1, None, 2 ** 31), (4096, 3, 1, 3), (4096, 3, 2, 2),
    (2, 2, 1, 2), (1 << 14, 2, None, 5)])
def test_whole_sort_plain_equals_fused(n, n_cols, num_keys, hi):
    """whole_sort_ on CPU tensors against bitonic_sort_2d: bit for bit,
    rows tied on the key prefix included."""
    rng = np.random.default_rng(n + n_cols)
    cols = [rng.integers(-hi, hi, n).astype(np.int32) for _ in range(n_cols)]
    want = tbk.bitonic_sort_2d([torch.from_numpy(c.copy()) for c in cols],
                               block_elems=256, merge_elems=1024,
                               num_keys=num_keys)
    got = tbk.bitonic_sort_2d([torch.from_numpy(c.copy()) for c in cols],
                              block_elems=256, merge_elems=1024,
                              num_keys=num_keys, single_launch=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_whole_sort_capacity():
    # slices of n / 128 rows, so that the grid spreads over the SMs, and
    # at most 512 threads a block (256 blocks, two per SM, at the most rows)
    assert tbk.whole_slice(1 << 20, 1) == 1 << 13
    assert tbk.whole_slice(1 << 19, 3) == 1 << 11
    assert tbk.whole_slice(64, 8) == 64
    assert tbk.whole_geometry(1 << 20, 1) == (1 << 13, 16)
    assert tbk.whole_geometry(1 << 21, 1) == (1 << 13, 16)  # two per SM
    assert tbk.whole_geometry(1 << 18, 8) == (1 << 10, 2)
    assert tbk.whole_geometry(1 << 10, 1) == (1 << 9, 16)
    assert tbk.whole_geometry(256, 1) == (256, 1)  # under 32 warps' rows
    for nc in range(1, tbk.MAX_COLS + 1):
        n = 2
        while n * nc <= tbk.WHOLE_MAX:
            s, r = tbk.whole_geometry(n, nc)
            assert s <= n and s * s >= n and n // s <= 2 * tbk.WHOLE_BLOCKS
            assert r in (1, tbk.whole_rows(nc)) and s % r == 0
            assert 1 <= s // r <= tbk.WHOLE_THREADS
            assert nc * (s + s // 32) * 4 <= tbk.SMEM_MAX
            n *= 2
    cols = [torch.zeros(1 << 20, dtype=torch.int32)] * 3
    with pytest.raises(BadArgsError):  # 3 x 2^20 > 2^21
        tbk.whole_sort_(cols)
    s = tsort.sort_new("abitonic", "single_launch=1")
    with pytest.raises(BadArgsError):  # pads to 2^22 rows
        s.sort_with_host_data(np.arange((1 << 21) + 1, dtype=np.uint32),
                              device="cpu")
    assert tbk.fused_traffic_bytes(1 << 20, 1, 8192, 32768, True) == \
        2 * 4 * (1 << 20)


# --- autotune=1 ---------------------------------------------------------------

def test_autotune_on_cpu_takes_static_geometry(monkeypatch):
    def no_tuning(*args):
        raise AssertionError("CPU tensors must not be tuned")
    monkeypatch.setattr(tat, "tune_geometry", no_tuning)
    x = _rand(np.uint32, 3000, 24)
    got = tsort.sort_new("abitonic", "autotune=1").sort_with_host_data(
        x, device="cpu")
    _bits_equal(got, np.sort(x))
    monkeypatch.setenv("CL_OPS_PSORT_AUTOTUNE", "1")
    cols = (torch.from_numpy(x.view(np.int32)),)
    _bits_equal(tps.sort_i32_cols(cols)[0].numpy(), np.sort(x.view(np.int32)))
    for bad in ("autotune=2", "single_launch=yes"):
        with pytest.raises(BadArgsError):
            tsort.sort_new("abitonic", bad)


@pytest.mark.parametrize("n_padded,n_arrays", [(1 << 24, 1), (1 << 20, 3),
                                               (1 << 18, 8), (512, 2)])
def test_autotune_candidates_respect_shared_memory(n_padded, n_arrays):
    cands = tat.candidate_geometries(n_padded, n_arrays)
    fused = [(b, m) for b, m, sl in cands if not sl]
    assert len(fused) == len(set(fused)) >= 1
    for b, m in fused:
        assert 1 <= b <= m <= n_padded
        assert m * n_arrays * 4 <= tbk.SMEM_MAX
    whole = [c for c in cands if c[2]]
    assert len(whole) == int(n_padded * n_arrays <= tbk.WHOLE_MAX)


def test_autotune_cache_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tat.CACHE_ENV, str(path))
    monkeypatch.setattr(tat, "device_kind", lambda device: "Test Card")
    monkeypatch.setattr(tat, "_mem_cache", {})
    timed = []

    def fake_time(geo, src):
        timed.append((geo, len(src), src[0].numel()))
        b, m, sl = geo
        return 0.5 if sl else 1.0 + abs(b - 2048) + abs(m - 8192)
    monkeypatch.setattr(tat, "time_candidate", fake_time)
    dev = torch.device("cpu")
    assert tat.tune_geometry(1 << 16, 2, dev) == (8192, 16384, True)
    assert set(timed) == {(geo, 2, 1 << 16) for geo in
                          tat.candidate_geometries(1 << 16, 2)}
    assert json.loads(path.read_text()) == {
        "Test Card:65536x2": [8192, 16384, True]}
    monkeypatch.setattr(tat, "_mem_cache", {})
    timed.clear()
    assert tat.tune_geometry(1 << 16, 2, dev) == (8192, 16384, True)
    assert timed == []  # read back from the file, nothing timed
    assert tat.tune_geometry(1 << 10, 1, dev)[2] is True
    assert set(json.loads(path.read_text())) == {"Test Card:65536x2",
                                                 "Test Card:1024x1"}


# --- gselect and the vendor sorter --------------------------------------------

@pytest.mark.parametrize("impl", ["gselect", "xla"])
@pytest.mark.parametrize("dt", ["char", "ushort", "int", "uint", "long",
                                "ulong", "half", "float", "double"])
def test_stable_sorters_match_jax(impl, dt):
    x = _rand(type_by_name(dt).np_dtype, 800, 7)
    jopts, topts = ("chunk=512", "chunk=300") if impl == "gselect" else \
        (None, None)
    want = jsort.sort_new(impl, jopts, elem_dtype=dt).sort_with_host_data(x)
    got = tsort.sort_new(impl, topts, elem_dtype=dt).sort_with_host_data(
        x, device="cpu")
    _bits_equal(got, want)


@pytest.mark.parametrize("impl", ["gselect", "xla"])
@pytest.mark.parametrize("dt,vdt", [("uint", np.int32), ("ulong", np.float32),
                                    ("float", np.int64), ("short", np.uint16)])
def test_stable_sorters_kv_match_jax(impl, dt, vdt):
    """Tied keys: both packages keep input order, values bit for bit."""
    x = _rand(type_by_name(dt).np_dtype, 700, 8)
    x = x[np.random.RandomState(9).randint(0, 60, 700)]
    vals = _rand(vdt, 700, 10)
    jopts, topts = ("chunk=512", "chunk=256") if impl == "gselect" else \
        (None, None)
    wk, wv = jsort.sort_new(impl, jopts, elem_dtype=dt).sort_with_host_data(
        x, vals)
    gk, gv = tsort.sort_new(impl, topts, elem_dtype=dt).sort_with_host_data(
        x, vals, device="cpu")
    _bits_equal(gk, wk)
    _bits_equal(gv, wv)
    _bits_equal(gv, vals[np.argsort(x, kind="stable")])


def test_stable_sorters_descending_and_introspection():
    x = _rand(np.uint32, 640, 3)
    for impl in ("gselect", "xla"):
        s = tsort.sort_new(impl, ascending=False)
        assert not s.in_place
        want = jsort.sort_new(impl, ascending=False).sort_with_host_data(x)
        _bits_equal(s.sort_with_host_data(x, device="cpu"), want)
    assert tsort.sort_new("xla").kernel_name(0) == "torch_sort"
    assert tsort.sort_new("gselect").kernel_name(0) == "gselect_rank"
    with pytest.raises(BadArgsError):
        tsort.sort_new("gselect", "chunk=0")
