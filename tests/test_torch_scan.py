"""scan_1d of cl_ops_tpu_torch against cl_ops_tpu's single-pass Pallas
carry kernels (`_scan_carry_kernel`, `_wide_scan_carry_kernel`, interpret
mode, block_rows=8), bit for bit. The CPU runs the port's plain version of
its scan_carry kernel; full-range inputs make every sum wrap."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.scan import kernels as tsk
from cl_ops_tpu_torch.ops.scan import scan_1d

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jsk = pytest.importorskip("cl_ops_tpu.ops.scan.kernels")

LENGTHS = [1, 1023, 1024 * 5 + 7]


def _data(dtype, n, seed=0):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(
        info.min, info.max, n, endpoint=True, dtype=dtype)


def _both(x, sum_dtype, exclusive):
    want = np.asarray(jsk.scan_1d(jnp.asarray(x), sum_dtype=sum_dtype,
                                  exclusive=exclusive, single_pass=True,
                                  interpret=True, block_rows=8))
    got = interop.to_numpy(scan_1d(interop.to_torch(x, "cpu"),
                                   sum_dtype=sum_dtype, exclusive=exclusive,
                                   single_pass=True))
    return want, got


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_scan_lengths_match_reference(n, exclusive, dtype):
    want, got = _both(_data(dtype, n), dtype, exclusive)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("elem,sum_dtype", [
    (np.uint32, np.uint32), (np.int8, np.int32), (np.int8, np.int8),
    (np.uint64, np.uint64), (np.uint32, np.uint64), (np.int32, np.int64),
    (np.uint8, np.uint16)])
def test_scan_dtypes_match_reference(exclusive, elem, sum_dtype):
    want, got = _both(_data(elem, 1024 * 5 + 7, seed=1), sum_dtype,
                      exclusive)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_scan_wraps_at_the_sum_width():
    x = np.array([2 ** 31 - 1, 1, 2 ** 31, 5], np.int64)
    got = scan_1d(torch.from_numpy(x.astype(np.int32)), sum_dtype="int",
                  exclusive=False, single_pass=True)
    assert got.tolist() == [2 ** 31 - 1, -2 ** 31, 0, 5]
    big = np.array([2 ** 63 - 1, 2, -1], np.int64)
    got = scan_1d(torch.from_numpy(big), sum_dtype="long", exclusive=False,
                  single_pass=True)
    assert got.tolist() == [2 ** 63 - 1, -2 ** 63 + 1, -2 ** 63]


def test_scan_float64_is_a_cumsum():
    x = np.random.default_rng(2).integers(-50, 50, 3000).astype(np.float64)
    for exclusive in (False, True):
        want = np.asarray(jsk.scan_1d(jnp.asarray(x), sum_dtype=jnp.float64,
                                      exclusive=exclusive))
        got = scan_1d(torch.from_numpy(x), sum_dtype=torch.float64,
                      exclusive=exclusive)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sum_dtype", ["int", "long", "float"])
def test_three_phase_scan_raises(sum_dtype):
    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(BadArgsError, match="not ported"):
        scan_1d(x, sum_dtype=sum_dtype, single_pass=False)
    if sum_dtype == "float":
        with pytest.raises(BadArgsError, match="_scan_block_kernel"):
            scan_1d(x.float(), sum_dtype=sum_dtype, single_pass=True)


def test_scan_carry_checks_and_counts():
    with pytest.raises(BadArgsError):
        tsk.scan_carry(torch.zeros(4, dtype=torch.int16))
    with pytest.raises(BadArgsError):
        tsk.scan_carry(torch.zeros(8, dtype=torch.int32)[::2])
    tsk.reset_launches()
    tsk.scan_carry(torch.arange(5, dtype=torch.int32))
    assert tsk.launches == {"scan_carry": 0, "scan_carry_wide": 0}
    assert tsk.scan_traffic_bytes(1 << 20, "uint") == 8 << 20
    assert tsk.scan_traffic_bytes(1 << 20, "ulong") == 16 << 20
