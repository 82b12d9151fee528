"""scan_1d of cl_ops_tpu_torch against cl_ops_tpu's Pallas scan kernels
(interpret mode, block_rows=8): the single-pass carry kernels
(`_scan_carry_kernel`, `_wide_scan_carry_kernel`) and the 3-phase block
kernels (`_scan_block_kernel`, `_wide_scan_block_kernel`), bit for bit for
integer sums. The CPU runs the port's plain versions of its scan_carry and
scan_block kernels; full-range inputs make every sum wrap."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.ops.scan import kernels as tsk
from cl_ops_tpu_torch.ops.scan import scan_1d

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jsk = pytest.importorskip("cl_ops_tpu.ops.scan.kernels")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The 3-phase path rejects what it cannot scan: 2-D input, float input
    under integer sums, and a block scan whose bases do not match its
    tiles."""
    x = torch.arange(10, dtype=torch.int32)
    with pytest.raises(BadArgsError):
        scan_1d(x.view(2, 5), sum_dtype=sum_dtype, single_pass=False)
    if sum_dtype == "float":
        with pytest.raises(BadArgsError):
            tsk.scan_block(x.float(), torch.zeros(2))
        return
    with pytest.raises(BadDtypeError):
        scan_1d(x.float(), sum_dtype=sum_dtype, single_pass=False)
    with pytest.raises(BadArgsError):
        tsk.scan_block_wide(x, torch.zeros(1, dtype=torch.int32))


# Three-phase cases: (elem, sum). Lengths are not multiples of the port's
# 4096-element tile nor of the JAX block (block_rows=8: 1024 elements).
THREE_PHASE = [(np.int32, np.int32), (np.uint32, np.uint64),
               (np.int32, np.int64), (np.uint8, np.uint32),
               (np.float32, np.float32)]


@pytest.mark.parametrize("n", [1, 4095, 2 * 4096 + 5])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("elem,sum_dtype", THREE_PHASE)
def test_three_phase_scan_matches_reference(n, exclusive, elem, sum_dtype):
    """scan_1d(single_pass=False) against JAX's 3-phase scan
    (`_scan_block_kernel`, `_wide_scan_block_kernel`, interpret mode).
    Integer sums bit for bit (full-range inputs, so they wrap). float32:
    the port sums tiles of 4096 with float64 tile bases, JAX blocks of
    1024 with float32 bases, so the two round differently; both stay
    within 1e-6 of the running sum of |x| from the float64 sums."""
    if np.dtype(elem).kind == "f":
        x = np.random.default_rng(n).uniform(-1, 1, n).astype(elem)
    else:
        x = _data(elem, n, seed=n)
    want = np.asarray(jsk.scan_1d(jnp.asarray(x), sum_dtype=sum_dtype,
                                  exclusive=exclusive, single_pass=False,
                                  interpret=True, block_rows=8))
    got = interop.to_numpy(scan_1d(interop.to_torch(x, "cpu"),
                                   sum_dtype=sum_dtype, exclusive=exclusive,
                                   single_pass=False))
    assert got.dtype == want.dtype
    if np.dtype(elem).kind != "f":
        np.testing.assert_array_equal(got, want)
        return
    x64 = x.astype(np.float64)
    exact = np.cumsum(x64) - (x64 if exclusive else 0)
    tol = 1e-6 * np.cumsum(np.abs(x64)) + 1e-6
    assert (np.abs(got - exact) <= tol).all()
    assert (np.abs(want - exact) <= tol).all()


def test_float_sums_take_the_three_phase_path():
    """As in JAX, float32 sums asked for single_pass run the block scan."""
    x = np.random.default_rng(4).uniform(-1, 1, 5000).astype(np.float32)
    tsk.reset_launches()
    a = scan_1d(torch.from_numpy(x), sum_dtype="float", single_pass=True)
    b = scan_1d(torch.from_numpy(x), sum_dtype="float", single_pass=False)
    assert torch.equal(a, b)
    assert tsk.scan_traffic_bytes(1 << 20, "float", single_pass=True) == \
        12 << 20  # the 3-phase path: x read twice, sums written once
    assert tsk.scan_traffic_bytes(1 << 20, "ulong", single_pass=False,
                                  elem_dtype="uint") == 16 << 20


def test_scan_carry_checks_and_counts():
    with pytest.raises(BadArgsError):
        tsk.scan_carry(torch.zeros(4, dtype=torch.int16))
    with pytest.raises(BadArgsError):
        tsk.scan_carry(torch.zeros(8, dtype=torch.int32)[::2])
    tsk.reset_launches()
    tsk.scan_carry(torch.arange(5, dtype=torch.int32))
    tsk.scan_block(torch.arange(5, dtype=torch.int32),
                   torch.zeros(1, dtype=torch.int32))
    assert set(tsk.launches.values()) == {0}
    assert tsk.scan_traffic_bytes(1 << 20, "uint") == 8 << 20
    assert tsk.scan_traffic_bytes(1 << 20, "ulong") == 16 << 20


def test_seg_scan_carry_smem_and_status_bytes():
    """The segmented kernel's shared memory per block: the tile ticket,
    8 warps' value and flag, and the tile's values and flags (dynamic);
    its status: a 16-byte ticket, then 8 bytes per SEG_TILE elements."""
    assert (tsk.SEG_THREADS, tsk.SEG_TILE) == (256, 8192)
    assert tsk.smem_bytes("seg_scan_carry", 4) == 4 + 8 * 8 + 8192 * 8
    assert [tsk.seg_status_bytes(n) for n in (1, 8192, 8193, 1 << 24)] == \
        [24, 24, 32, 16 + 8 * 2048]
    with pytest.raises(BadArgsError):
        tsk.smem_bytes("seg_tiles", 4)
