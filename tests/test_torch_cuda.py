"""The CUDA kernels against their plain versions, on the card.

Small and odd geometries that chip_smoke.py does not reach: up to MAX_COLS
columns, key prefixes shorter than the row, tied prefixes, single-block
arrays and the k = 0 merge; scans of odd lengths, all ops and dtypes, with
dense and nearly absent segment flags. Skips without CUDA. On a machine without JAX
run it with `python -m pytest --noconftest tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.exec import filter_compact, group_aggregate_cols
from cl_ops_tpu_torch.ops.scan import kernels as sk
from cl_ops_tpu_torch.ops.scan import segmented as seg
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import sort_new

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(n, n_cols, seed, hi=2 ** 31):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-hi, hi, n).astype(np.int32))
            for _ in range(n_cols)]


def _run_both(cols, fn_kernel, fn_plain, dev):
    a = [c.to(dev) for c in cols]
    b = [c.clone() for c in cols]
    fn_kernel(a)
    fn_plain(b)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("n_cols,num_keys,hi", [
    (1, 1, 2 ** 31), (3, 1, 4), (3, 2, 2 ** 31), (8, 3, 2), (8, 8, 2 ** 31)])
def test_sort_kernels_match_plain(cuda, n_cols, num_keys, hi):
    n = 1 << 14
    cols = _cols(n, n_cols, 7, hi)
    geoms = [(256, 1024), (1024, 4096), (1, 1024)]  # 1: a no-op block_sort
    if n_cols <= 3:
        geoms.append((1 << 14, 1 << 14))  # one block: block_sort alone
    for b, m in geoms:
        _run_both(cols,
                  lambda c: bk.bitonic_sort_2d(c, block_elems=b,
                                               merge_elems=m,
                                               num_keys=num_keys),
                  lambda c: bk.bitonic_sort_2d(c, block_elems=b,
                                               merge_elems=m,
                                               num_keys=num_keys), cuda)


def test_each_kernel_matches_plain(cuda):
    cols = _cols(1 << 13, 3, 3, 8)
    cases = [
        (lambda c: bk.block_sort_(c, 512, 2),
         lambda c: bk.block_sort_plain(c, 512, 2)),
        (lambda c: bk.multi_stage_(c, 256, 2048, 2),
         lambda c: bk.multi_stage_plain(c, 256, 2048, 2)),
        (lambda c: bk.pair_cross_(c, 4096, 1024, 2),
         lambda c: bk.pair_cross_plain(c, 4096, 1024, 2)),
        (lambda c: bk.pair_cross_(c, 0, 2048, 2),
         lambda c: bk.pair_cross_plain(c, 0, 2048, 2)),
        (lambda c: bk.block_merge_(c, 1024, 0, 2),
         lambda c: bk.block_merge_plain(c, 1024, 0, 2)),
        (lambda c: bk.block_merge_(c, 1024, 4096, 2),
         lambda c: bk.block_merge_plain(c, 1024, 4096, 2)),
    ]
    for kern, plain in cases:
        _run_both(cols, kern, plain, cuda)


def test_launch_counts_and_sorter(cuda):
    x = np.random.default_rng(1).integers(0, 2 ** 32, 100_000,
                                          dtype=np.uint32)
    bk.reset_launches()
    s = sort_new("abitonic", "block_elems=1024,merge_elems=4096")
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x))
    assert all(bk.launches[k] > 0 for k in bk.KERNELS)


def test_filter_on_card(cuda):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2 ** 32, 70_000, dtype=np.uint32)
    p = rng.integers(-2 ** 63, 2 ** 63, 70_000, dtype=np.int64)
    c, fx, fp = filter_compact(interop.to_torch(x, cuda),
                               lambda v: interop.widen_u32(v) < 2 ** 30,
                               interop.to_torch(p, cuda))
    m = x < 2 ** 30
    c = int(c)
    assert c == int(m.sum())
    np.testing.assert_array_equal(interop.to_numpy(fx)[:c], x[m])
    np.testing.assert_array_equal(interop.to_numpy(fp)[:c], p[m])


# --- the scan kernels (csrc/scan.cu) ------------------------------------------

SCAN_LENGTHS = [1, 1025, (1 << 20) + 3]


def _f32_add_tolerance(x, flags):
    """Allowed |kernel - plain| for a float32 segmented sum: the two sum in
    different orders, so each may be off by a few hundred ulps of the
    running sum of |x| in the segment; 1e-5 (about 84 ulps) of it, plus
    1e-6 for sums near zero."""
    return 1e-5 * seg.seg_scan_carry_plain(x.abs(), flags, "add", False) \
        + 1e-6


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_carry_matches_plain(cuda, n, dtype, exclusive):
    rng = np.random.default_rng(n)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    x = torch.from_numpy(rng.integers(info.min, info.max, n, endpoint=True,
                                      dtype=info.dtype))
    sk.reset_launches()
    got = sk.scan_carry(x.to(cuda), exclusive)
    torch.cuda.synchronize()
    name = "scan_carry" if dtype == torch.int32 else "scan_carry_wide"
    assert sk.launches[name] == 1
    assert torch.equal(got.cpu(), sk.scan_carry_plain(x, exclusive))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("density", [1 / 256, 1e-6])
def test_seg_scan_carry_matches_plain(cuda, n, dtype, op, density):
    rng = np.random.default_rng(n + 1)
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n,
                                          dtype=np.int32))
    else:
        xs = rng.uniform(-1, 1, n).astype(np.float32)
        if op != "add":
            xs[rng.random(n) < 1e-3] = np.nan
            xs[rng.random(n) < 1e-3] = -0.0
        x = torch.from_numpy(xs)
    flags = torch.from_numpy((rng.random(n) < density).astype(np.int32))
    for exclusive in ([False, True] if op == "add" else [False]):
        seg.reset_launches()
        got = seg.seg_scan_carry(x.to(cuda), flags.to(cuda), op,
                                 exclusive).cpu()
        torch.cuda.synchronize()
        assert seg.launches["seg_scan_carry"] == 1
        want = seg.seg_scan_carry_plain(x, flags, op, exclusive)
        if dtype == torch.float32 and op == "add":
            assert bool(((got - want).abs()
                         <= _f32_add_tolerance(x, flags)).all())
        else:
            assert torch.equal(got.isnan(), want.isnan())
            ok = got.isnan()
            assert torch.equal(got[~ok], want[~ok])  # +0 == -0


def test_group_aggregate_cols_on_card(cuda):
    rng = np.random.default_rng(5)
    n, g = 300_000, 4096
    keys = rng.integers(0, g, n).astype(np.int32)
    v64 = rng.integers(-2 ** 63, 2 ** 63, n, dtype=np.int64)
    v32 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32)
    gk, (s, c, mn), cnt = group_aggregate_cols(
        interop.to_torch(keys, cuda),
        (interop.to_torch(v64, cuda), interop.to_torch(v64, cuda),
         interop.to_torch(v32, cuda)), ("sum", "count", "min"),
        num_groups=g)
    uniq = np.unique(keys)
    want_s = np.zeros(g, np.int64)
    np.add.at(want_s, keys, v64)  # wraps mod 2^64
    want_min = np.full(g, 2 ** 31 - 1, np.int32)
    np.minimum.at(want_min, keys, v32)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(interop.to_numpy(gk)[:len(uniq)], uniq)
    np.testing.assert_array_equal(interop.to_numpy(s)[:len(uniq)],
                                  want_s[uniq])
    np.testing.assert_array_equal(interop.to_numpy(c)[:len(uniq)],
                                  np.bincount(keys)[uniq])
    np.testing.assert_array_equal(interop.to_numpy(mn)[:len(uniq)],
                                  want_min[uniq])
