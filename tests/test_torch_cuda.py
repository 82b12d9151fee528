"""The CUDA kernels against their plain versions, on the card.

Small and odd geometries that chip_smoke.py does not reach: up to MAX_COLS
columns, key prefixes shorter than the row, tied prefixes, single-block
arrays and the k = 0 merge. Skips without CUDA. On a machine without JAX
run it with `python -m pytest --noconftest tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.exec import filter_compact
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
