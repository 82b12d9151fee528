"""The abitonic Sorter of cl_ops_tpu_torch against cl_ops_tpu's.

Each case is the port's small-geometry counterpart of one in
tests/test_sort.py: the JAX side runs "block_rows=8,single_launch=0" (sort
block 1024, merge block 4096) in interpret mode, the port the same geometry
on the CPU. Sorted keys are bit-identical; where values ride a key with ties
(whose order the reference leaves unspecified) the keys are compared bit for
bit and the (key, value) rows as a multiset.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.dtypes import type_by_name
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError
from cl_ops_tpu_torch.ops import sort as tsort

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jsort = pytest.importorskip("cl_ops_tpu.ops.sort")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JOPTS = "block_rows=8,single_launch=0"
TOPTS = "block_elems=1024,merge_elems=4096"
ALL_TYPES = ["char", "uchar", "short", "ushort", "int", "uint", "long",
             "ulong", "half", "float", "double"]


def _rand(dt, n, seed):
    """The same draws as tests/test_sort.py's _rand."""
    rng = np.random.RandomState(seed)
    dt = np.dtype(dt)
    if dt.kind in "ui" and dt.itemsize == 8:
        lo = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        hi = rng.randint(0, 2 ** 32, size=n, dtype=np.uint64)
        w = lo | (hi << np.uint64(32))
        return w.astype(dt) if dt.kind == "u" else w.view(np.int64)
    if dt.kind == "u":
        return rng.randint(0, 2 ** (8 * dt.itemsize),
                           size=n, dtype=np.uint64).astype(dt)
    if dt.kind == "i":
        lim = 2 ** (8 * dt.itemsize - 1)
        return rng.randint(-lim, lim, size=n, dtype=np.int64).astype(dt)
    return (rng.randn(n) * 100).astype(dt)


def _both(x, values=None, elem_dtype="uint", key_fn=None,
          key_fn_torch=None, **kw):
    j = jsort.sort_new("abitonic", JOPTS, elem_dtype=elem_dtype,
                       key_fn=key_fn, **kw)
    t = tsort.sort_new("abitonic", TOPTS, elem_dtype=elem_dtype,
                       key_fn=key_fn_torch, **kw)
    if values is None:
        return j.sort_with_host_data(x), t.sort_with_host_data(x,
                                                               device="cpu")
    return (j.sort_with_host_data(x, values),
            t.sort_with_host_data(x, values, device="cpu"))


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [1, 100, 1024, 3000])
def test_sort_u32(n):
    x = _rand(np.uint32, n, 42 + n)
    want, got = _both(x)
    _bits_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("dt", ALL_TYPES)
def test_sort_all_dtypes(dt):
    x = _rand(type_by_name(dt).np_dtype, 800, 7)
    want, got = _both(x, elem_dtype=dt)
    _bits_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


def test_sort_bfloat16():
    """No JAX counterpart (its key module rejects bfloat16): held to the
    numpy sort of the float32 widening."""
    bits = (_rand(np.float32, 900, 8).view(np.uint32) >> 16).astype(np.uint16)
    s = tsort.sort_new("abitonic", TOPTS, elem_dtype="bfloat16")
    got = s.sort_with_host_data(bits, device="cpu")
    wide = (bits.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(
        (got.astype(np.uint32) << 16).view(np.float32), np.sort(wide))


@pytest.mark.parametrize("dt", ["uint", "long", "float"])
def test_sort_descending(dt):
    x = _rand(type_by_name(dt).np_dtype, 640, 3)
    want, got = _both(x, elem_dtype=dt, ascending=False)
    _bits_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x)[::-1])


def _rows_equal(got, want):
    _bits_equal(got[0], want[0])
    assert sorted(zip(got[0].tolist(), got[1].tolist())) == \
        sorted(zip(want[0].tolist(), want[1].tolist()))


@pytest.mark.parametrize("vdt", [np.int32, np.float32, np.uint32])
def test_sort_key_value_4byte_payload(vdt):
    x = _rand(np.uint32, 600, 5) % 50  # ties: values order unspecified
    vals = _rand(vdt, 600, 6)
    want, got = _both(x, vals)
    assert got[1].dtype == vdt
    _rows_equal(got, want)


@pytest.mark.parametrize("vdt", [np.int64, np.float64, np.uint16])
def test_sort_key_value_index_path(vdt):
    x = _rand(np.uint32, 700, 9) % 64
    vals = _rand(vdt, 700, 10)
    want, got = _both(x, vals)
    assert got[1].dtype == vdt
    _rows_equal(got, want)


def test_sort_key_value_unique_keys_bit_identical():
    x = np.random.RandomState(1).permutation(2000).astype(np.uint32)
    vals = np.arange(2000, dtype=np.int32)
    (wk, wv), (gk, gv) = _both(x, vals)
    _bits_equal(gk, wk)
    _bits_equal(gv, wv)
    np.testing.assert_array_equal(x[gv], gk)


def test_sort_key_value_u64_keys():
    x = _rand(np.uint64, 1500, 12)
    vals = np.arange(1500, dtype=np.int32)
    (wk, wv), (gk, gv) = _both(x, vals, elem_dtype="ulong")
    _bits_equal(gk, wk)
    _bits_equal(gv, wv)


def test_sort_key_value_duplicates():
    x = np.array([5, 1, 5, 1, 5, 1] * 100, np.uint32)
    vals = np.array([9, 9, 9, 9, 7, 7] * 100, np.int32)
    want, got = _both(x, vals)
    _rows_equal(got, want)


def test_sort_key_fn():
    """Sort by the low byte (CLO_SORT_KEY_GET analog)."""
    x = _rand(np.uint32, 500, 11)
    want, got = _both(
        x, key_dtype="uchar",
        key_fn=lambda d: (d & jnp.uint32(0xFF)).astype(jnp.uint8),
        key_fn_torch=lambda d: (d.view(torch.int32) & 0xFF).to(torch.uint8))
    np.testing.assert_array_equal(got & 0xFF, want & 0xFF)
    assert np.all(np.diff(got & 0xFF) >= 0)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))


def test_sort_with_duplicates_and_extremes():
    x = np.array([0, 0xFFFFFFFF, 5, 0xFFFFFFFF, 0, 7] * 200, np.uint32)
    want, got = _both(x)
    _bits_equal(got, want)


def test_sort_device_data_stays_on_device():
    x = _rand(np.int32, 300, 13)
    t = interop.to_torch(x, "cpu")
    s = tsort.sort_new("abitonic", TOPTS, elem_dtype="int")
    out = s(t)
    assert out.device == t.device and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.sort(x))
    np.testing.assert_array_equal(t.numpy(), x)  # input left untouched


def test_introspection():
    s = tsort.sort_new("abitonic")
    assert s.in_place and s.name == "abitonic"
    assert s.num_kernels == 4
    assert [s.kernel_name(i) for i in range(4)] == [
        "block_sort", "multi_stage", "pair_cross", "block_merge"]
    assert s.smem_usage("block_sort", 1 << 20) == (1 << 13) * 4
    assert s.smem_usage("block_merge", 1 << 20) == (1 << 15) * 4
    assert s.smem_usage("pair_cross", 1 << 20) == (1 << 14) * 4
    assert tsort.sort_new("abitonic", elem_dtype="ulong").smem_usage(
        "multi_stage", 1 << 20) == (1 << 14) * 4 * 2
    assert s.elem_dtype == s.key_dtype == torch.uint32
    assert tsort.sort_names() == jsort.sort_names()


def test_default_sorter_matches_jax():
    """sort_new() builds satradix in both packages: a stable sort, so the
    values of tied keys come out in input order in both."""
    assert tsort.sort_new().name == jsort.sort_new().name == "satradix"
    x = _rand(np.uint32, 600, 25) % 50
    vals = _rand(np.int32, 600, 26)
    wk, wv = jsort.sort_new(options="block_rows=8,scatter=xla"
                            ).sort_with_host_data(x, vals)
    gk, gv = tsort.sort_new(options="block_elems=1024").sort_with_host_data(
        x, vals, device="cpu")
    _bits_equal(gk, wk)
    _bits_equal(gv, wv)


def test_bad_args():
    with pytest.raises(CloOpsError):
        tsort.sort_new("nope")
    assert tsort.sort_new("sbitonic").name == "sbitonic"
    with pytest.raises(CloOpsError):
        tsort.sort_new("sbitonic", "block_elems=1000")
    with pytest.raises(CloOpsError):
        tsort.sort_new("abitonic", key_dtype="uchar")  # no key_fn
    for opt in ("single_launch=2", "autotune=on"):
        with pytest.raises(BadArgsError):
            tsort.sort_new("abitonic", opt)
    x = np.arange(10, dtype=np.uint32)[::-1].copy()
    for opt in ("single_launch=1", "autotune=1"):
        np.testing.assert_array_equal(tsort.sort_new("abitonic", opt)
                                      .sort_with_host_data(x, device="cpu"),
                                      np.sort(x))
    with pytest.raises(BadArgsError):
        tsort.sort_new("abitonic", "block_elems=1000").sort_with_host_data(
            x, device="cpu")
    s = tsort.sort_new("abitonic")
    with pytest.raises(CloOpsError):
        s.sort_with_device_data(torch.zeros((2, 2), dtype=torch.uint32))
    with pytest.raises(CloOpsError):
        s.sort_with_device_data(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(CloOpsError):
        s.sort_with_device_data(torch.zeros(4, dtype=torch.uint32),
                                torch.zeros(3, dtype=torch.int32))
