"""scan_new, Scan and default_sum_dtype of cl_ops_tpu_torch against
cl_ops_tpu's (`ops/scan/abstract.py`, Pallas kernels in interpret mode,
block_rows=8) and a serial numpy scan. Integer sums bit for bit; float32
sums within 1e-6 of the running sum of |x| from float64 sums, since the
port's tiles (4096 elements, float64 tile bases) and JAX's blocks (1024,
float32 bases) round differently."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize, default_sum_dtype
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError
from cl_ops_tpu_torch.ops import scan as tscan

jax = pytest.importorskip("jax")
jdt = pytest.importorskip("cl_ops_tpu.core.dtypes")
jscan = pytest.importorskip("cl_ops_tpu.ops.scan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IMPLS = ["blelloch", "lookback", "xla"]


def _jax_host(impl, x, exclusive, **kw):
    s = jscan.scan_new(impl, options="block_rows=8,interpret=1", **kw)
    return s.scan_with_host_data(x, exclusive=exclusive)


def test_registry_names():
    assert set(tscan.scan_names()) == set(jscan.scan_names()) == set(IMPLS)
    with pytest.raises(CloOpsError):
        tscan.scan_new("nope")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [1, 7, 4096, 9000])
@pytest.mark.parametrize("exclusive", [True, False])
def test_default_uint_to_ulong_matches_reference(impl, n, exclusive):
    """The reference library's default scan: uint elements, ulong sums."""
    x = np.random.default_rng(n).integers(0, 2 ** 32, n, dtype=np.uint32)
    s = tscan.scan_new(impl)
    assert s.sum_dtype == torch.uint64
    got = s.scan_with_host_data(x, exclusive=exclusive, device="cpu")
    want = _jax_host(impl, x, exclusive)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    inc = np.cumsum(x.astype(np.uint64))
    np.testing.assert_array_equal(got, inc - x if exclusive else inc)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("elem,sum_", [("uchar", "uint"), ("int", "long"),
                                       ("int", "int"), ("uint", "uint")])
def test_dtype_pairs_match_reference(impl, elem, sum_):
    ed = canonicalize(elem)
    info = np.iinfo(np.dtype(str(ed).removeprefix("torch.")))
    x = np.random.default_rng(7).integers(info.min, info.max, 5000,
                                          endpoint=True, dtype=info.dtype)
    s = tscan.scan_new(impl, elem_dtype=elem, sum_dtype=sum_)
    got = s.scan_with_host_data(x, device="cpu")
    want = _jax_host(impl, x, True, elem_dtype=elem, sum_dtype=sum_)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_float_sums_within_tolerance(impl):
    x = np.random.default_rng(9).uniform(-1, 1, 9000).astype(np.float32)
    s = tscan.scan_new(impl, elem_dtype="float")
    assert s.sum_dtype == torch.float32
    got = s.scan_with_host_data(x, device="cpu")
    want = _jax_host(impl, x, True, elem_dtype="float")
    x64 = x.astype(np.float64)
    exact = np.cumsum(x64) - x64
    tol = 1e-6 * np.cumsum(np.abs(x64)) + 1e-6
    assert (np.abs(got - exact) <= tol).all()
    assert (np.abs(want - exact) <= tol).all()


@pytest.mark.parametrize("elem", ["char", "uchar", "short", "ushort", "int",
                                  "uint", "long", "ulong", "half", "float",
                                  "double"])
def test_default_sum_dtype_matches_reference(elem):
    got = default_sum_dtype(elem)
    want = jdt.default_sum_dtype(elem)
    assert str(got).removeprefix("torch.") == want.name


def test_device_data_and_introspection():
    x = torch.arange(10, dtype=torch.int32).view(torch.uint32)
    for impl, kernels in [("blelloch", ("block_sums", "block_sums_scan",
                                        "block_scan_base_add")),
                          ("lookback", ("carry_scan",)),
                          ("xla", ("cumsum",))]:
        s = tscan.scan_new(impl)
        j = jscan.scan_new(impl)
        assert s.num_kernels == j.num_kernels == len(kernels)
        assert tuple(s.kernel_name(i) for i in range(s.num_kernels)) == \
            tuple(j.kernel_name(i) for i in range(j.num_kernels)) == kernels
        assert s(x).tolist() == [i * (i - 1) // 2 for i in range(10)]
        with pytest.raises(BadArgsError):
            s.scan_with_device_data(x.view(2, 5))
        with pytest.raises(BadArgsError):
            s.scan_with_device_data(x.view(torch.int32))
        with pytest.raises(BadArgsError):
            s.vmem_usage("nope", 1 << 20)
    s = tscan.scan_new("blelloch")
    # the block scan keeps one 8-byte warp total per warp in shared memory
    assert s.vmem_usage("block_scan_base_add", 1 << 20) == 16 * 8
    assert s.vmem_usage("block_sums", 1 << 20) == 0
    assert tscan.scan_new("lookback").vmem_usage("carry_scan", 1 << 20) > 0
    assert tscan.scan_new("xla").vmem_usage("cumsum", 1 << 20) == 0
