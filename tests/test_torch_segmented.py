"""segmented_scan_1d of cl_ops_tpu_torch against cl_ops_tpu's: the Pallas
`_seg_carry_kernel` (interpret mode, block_rows=8, so 1024-element blocks)
for <=32-bit values, its XLA formulation for 64-bit ones. Integer results
and float min/max are compared exactly; float32 sums, taken in another
order, within a stated tolerance."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.scan import flags_from_segment_ids
from cl_ops_tpu_torch.ops.scan import segmented as tseg
from cl_ops_tpu_torch.ops.scan import segmented_scan_1d

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jseg = pytest.importorskip("cl_ops_tpu.ops.scan.segmented")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 1024 * 5 + 7


def _flags(n, seed):
    """Sparse segment starts (runs of ~700 rows cross the 1024-row blocks)
    plus starts right at and after a block edge."""
    rng = np.random.default_rng(seed)
    f = (rng.random(n) < 1 / 700).astype(np.int32)
    f[[1023, 1024, min(3072, n - 1)]] = 1
    return f


def _values(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "f32":
        return rng.uniform(-1, 1, n).astype(np.float32)
    if kind == "f64":
        return rng.integers(-1000, 1000, n).astype(np.float64)
    dt = {"i32": np.int32, "u32": np.uint32, "i64": np.int64,
          "u64": np.uint64}[kind]
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, endpoint=True, dtype=dt)


def _both(x, f, op, exclusive, **kw):
    want = np.asarray(jseg.segmented_scan_1d(
        jnp.asarray(x), jnp.asarray(f), op=op, exclusive=exclusive,
        block_rows=8, **kw))
    got = interop.to_numpy(segmented_scan_1d(
        interop.to_torch(x, "cpu"), interop.to_torch(f, "cpu"), op=op,
        exclusive=exclusive, **kw))
    return want, got


def _f32_sum_tolerance(x, f):
    """|port - JAX| allowed for float32 segmented sums: both are exact sums
    rounded in different orders, each within a few tens of ulps of the
    running sum of |x| in its segment; 1e-5 (about 84 ulps) of that, plus
    1e-6 near zero."""
    absx = torch.from_numpy(np.abs(x))
    return 1e-5 * tseg.seg_scan_carry_plain(
        absx, torch.from_numpy(f), "add", False).numpy() + 1e-6


@pytest.mark.parametrize("kind", ["i32", "u32", "f32"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("exclusive", [False, True])
def test_segmented_matches_reference(kind, op, exclusive):
    x = _values(kind, N, 1)
    f = _flags(N, 2)
    want, got = _both(x, f, op, exclusive)
    assert got.dtype == want.dtype
    if kind == "f32" and op == "add":
        assert (np.abs(got - want) <= _f32_sum_tolerance(x, f)).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["i64", "u64", "f64"])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segmented_64bit_fallback_matches_reference(kind, op):
    x = _values(kind, 3000, 3)
    f = _flags(3000, 4)
    for exclusive in (False, True):
        want, got = _both(x, f, op, exclusive)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_segmented_widened_sum_dtype():
    x = _values("u32", 3000, 5)
    f = _flags(3000, 6)
    want, got = _both(x, f, "add", True, sum_dtype=jnp.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segmented_f32_nan_and_signed_zero(op):
    x = _values("f32", N, 7)
    x[[5, 2000, 4096]] = np.nan
    x[[9, 10, 3000]] = [-0.0, 0.0, -0.0]
    f = _flags(N, 8)
    want, got = _both(x, f, op, False)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)  # NaN == NaN, +0 == -0


def test_flags_from_segment_ids():
    ids = np.repeat(np.array([3, 3, 7, 1, 1, 1, 9], np.uint32),
                    [1, 4, 2, 3, 1, 5, 2])
    want = np.asarray(jseg.flags_from_segment_ids(jnp.asarray(ids)))
    got = flags_from_segment_ids(interop.to_torch(ids, "cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_zero_always_starts_a_segment():
    x = torch.tensor([5, 1, 2], dtype=torch.int32)
    f = torch.zeros(3, dtype=torch.int32)
    assert segmented_scan_1d(x, f, op="max", exclusive=True).tolist() == \
        [-2 ** 31, 5, 5]


def test_segmented_rejects_bad_arguments():
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(BadArgsError):
        segmented_scan_1d(x, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(BadArgsError):
        segmented_scan_1d(x, torch.zeros(4, dtype=torch.int32), op="mul")
    with pytest.raises(BadArgsError):
        tseg.seg_scan_carry(x, torch.zeros(4, dtype=torch.int32), "min",
                            exclusive=True)
