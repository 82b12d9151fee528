"""The four bitonic kernels' plain versions and the fused schedule of
cl_ops_tpu_torch against cl_ops_tpu's Pallas kernels in interpret mode.

Geometry: n = 8192, sort block B = 1024 (8 rows of 128 on the JAX side),
merge block M = 2048 (16 rows). With a total comparator (every column
compared) the outputs are bit-identical. With a `num_keys` prefix, rows tied
on it come out in unspecified order, so the prefix columns are compared bit
for bit and the rows as a multiset.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.exec import psort as tps
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as tbk

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jbk = pytest.importorskip("cl_ops_tpu.ops.sort.bitonic_kernels")
jps = pytest.importorskip("cl_ops_tpu.ops.exec.psort")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, B, M = 8192, 1024, 2048
BR, MR = B // 128, M // 128


def _cols(n_cols, seed, hi=2 ** 31, n=N):
    rng = np.random.default_rng(seed)
    return [rng.integers(-hi, hi, n).astype(np.int32) for _ in range(n_cols)]


def _jax(cols):
    return tuple(jnp.asarray(c.reshape(-1, 128)) for c in cols)


def _torch(cols):
    return [torch.from_numpy(c.copy()) for c in cols]


def _np(out):
    return [np.asarray(a).reshape(-1) for a in out]


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy() if hasattr(g, "numpy")
                                      else g, w)


def _same_prefix_and_rows(got, want, num_keys):
    got = [g.numpy() for g in got]
    for g, w in zip(got[:num_keys], want[:num_keys]):
        np.testing.assert_array_equal(g, w)
    rows = lambda cs: sorted(zip(*[c.tolist() for c in cs]))  # noqa: E731
    assert rows(got) == rows(want)


@pytest.mark.parametrize("n_cols,hi", [(1, 2 ** 31), (2, 16), (3, 4)])
def test_block_sort_plain_matches_pallas(n_cols, hi):
    cols = _cols(n_cols, 1, hi)
    want = _np(jbk._call_per_block(jbk._block_sort_kernel, _jax(cols),
                                   N // B, BR, True, multi_block=True,
                                   unroll_lanes=False))
    _same(tbk.block_sort_(_torch(cols), B), want)


def test_block_sort_single_block_matches_pallas():
    cols = _cols(2, 2, 8, n=1024)
    want = _np(jbk._call_per_block(jbk._block_sort_kernel, _jax(cols), 1, 8,
                                   True, multi_block=False,
                                   unroll_lanes=False))
    _same(tbk.block_sort_(_torch(cols), 1024), want)


@pytest.mark.parametrize("n_cols,hi", [(1, 2 ** 31), (3, 8)])
def test_multi_stage_plain_matches_pallas(n_cols, hi):
    cols = _cols(n_cols, 3, hi)
    want = _np(jbk._call_per_block(jbk._multi_stage_kernel, _jax(cols),
                                   N // M, MR, True, start_k=2 * B,
                                   multi_block=True, unroll_lanes=False))
    _same(tbk.multi_stage_(_torch(cols), B, M), want)


@pytest.mark.parametrize("j,k", [(2048, 4096), (1024, 8192), (4096, 8192),
                                 (1024, 0), (4096, 0)])
def test_pair_cross_plain_matches_pallas(j, k):
    cols = _cols(2, 4, 64)
    c_rows = 8  # half-merge granularity, as bitonic_sort_2d uses it
    want = _np(jbk._call_pair_cross(_jax(cols), c_rows, j // 1024,
                                    k // 1024, True))
    _same(tbk.pair_cross_(_torch(cols), k, j), want)


@pytest.mark.parametrize("j,k", [(1, 2), (2, 8), (16, 64), (32, 8192),
                                 (512, 1024)])
def test_pair_cross_below_block_matches_single_step_kernel(j, k):
    """sbitonic's steps J < its block: pair_cross against JAX's
    _single_step_kernel (one step, J < B = 1024)."""
    cols = _cols(2, 19, 64)
    want = _np(jbk._call_single_step(_jax(cols), N // B, BR, k, j, True))
    _same(tbk.pair_cross_(_torch(cols), k, j), want)


@pytest.mark.parametrize("j,k", [(1024, 2048), (2048, 8192), (4096, 8192)])
def test_pair_cross_above_block_matches_cross_kernel(j, k):
    """sbitonic's steps J >= its block: pair_cross against JAX's
    _cross_kernel (each block writes only itself)."""
    cols = _cols(2, 20, 64)
    want = _np(jbk._call_cross(_jax(cols), N // B, BR, j // B, k // B, True))
    _same(tbk.pair_cross_(_torch(cols), k, j), want)


@pytest.mark.parametrize("n_cols,hi", [(1, 2 ** 31), (3, 5)])
def test_whole_sort_plain_matches_vmem_kernel(n_cols, hi):
    """single_launch=1: whole_sort_ against JAX's _vmem_sort_kernel."""
    cols = _cols(n_cols, 21, hi)
    want = _np(jbk._call_per_block(jbk._vmem_sort_kernel, _jax(cols), 1,
                                   N // 128, True))
    tbk.reset_launches()
    _same(tbk.whole_sort_(_torch(cols)), want)
    assert tbk.launches["whole_sort"] == 0


@pytest.mark.parametrize("k", [0, 2 * M, 4 * M])
def test_block_merge_plain_matches_pallas(k):
    cols = _cols(2, 5, 2 ** 31)
    want = _np(jbk._call_merge(_jax(cols), N // M, MR, k // M, True))
    _same(tbk.block_merge_(_torch(cols), M, k), want)


@pytest.mark.parametrize("kernel", ["block_sort", "pair_cross",
                                    "block_merge"])
def test_kernels_with_key_prefix(kernel):
    """num_keys=1 on a column of heavy ties: prefix identical, rows kept."""
    cols = _cols(1, 6, 3) + [np.arange(N, dtype=np.int32)]
    jc, tc = _jax(cols), _torch(cols)
    if kernel == "block_sort":
        want = jbk._call_per_block(jbk._block_sort_kernel, jc, N // B, BR,
                                   True, multi_block=True,
                                   unroll_lanes=False, num_keys=1)
        got = tbk.block_sort_(tc, B, num_keys=1)
    elif kernel == "pair_cross":
        want = jbk._call_pair_cross(jc, 8, 2, 4, True, num_keys=1)
        got = tbk.pair_cross_(tc, 4096, 2048, num_keys=1)
    else:
        want = jbk._call_merge(jc, N // M, MR, 2, True, num_keys=1)
        got = tbk.block_merge_(tc, M, 2 * M, num_keys=1)
    _same_prefix_and_rows(got, _np(want), 1)


@pytest.mark.parametrize("n_cols,hi", [(1, 2 ** 31), (3, 5)])
def test_bitonic_sort_2d_matches_pallas(n_cols, hi):
    cols = _cols(n_cols, 7, hi)
    want = _np(jbk.bitonic_sort_2d(_jax(cols), block_rows=BR, fused=True,
                                   interpret=True, merge_rows=MR,
                                   single_launch=False))
    tbk.reset_launches()
    got = tbk.bitonic_sort_2d(_torch(cols), block_elems=B, merge_elems=M)
    _same(got, want)
    order = np.lexsort(cols[::-1])
    _same(got, [c[order] for c in cols])
    # CPU tensors take the plain versions: no kernel launches
    assert all(v == 0 for v in tbk.launches.values())


def test_bitonic_sort_2d_key_prefix_multi_stage():
    """num_keys through all four steps; the JAX multi-stage tier compares
    every column, so only the prefix order and the rows are comparable."""
    cols = _cols(1, 8, 4) + _cols(2, 9)
    want = _np(jbk.bitonic_sort_2d(_jax(cols), block_rows=BR, fused=True,
                                   interpret=True, merge_rows=MR,
                                   single_launch=False, num_keys=1))
    got = tbk.bitonic_sort_2d(_torch(cols), block_elems=B, merge_elems=M,
                              num_keys=1)
    _same_prefix_and_rows(got, want, 1)


def test_bitonic_merge_2d_matches_pallas():
    a, b = np.sort(_cols(1, 10)[0][:N // 2]), np.sort(_cols(1, 11)[0][:N // 2])
    seq = [np.concatenate([a, b[::-1]]).astype(np.int32)]
    want = _np(jbk.bitonic_merge_2d(_jax(seq), block_rows=8, interpret=True))
    got = tbk.bitonic_merge_2d(_torch(seq), merge_elems=1024)
    _same(got, want)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(seq[0]))


def test_all_rows_tied_keep_every_row():
    cols = [np.full(N, 7, np.int32), np.arange(N, dtype=np.int32)[::-1].copy()]
    want = _np(jps.sort_i32_cols(tuple(jnp.asarray(c) for c in cols),
                                 num_keys=1, interpret=True))
    got = tps.sort_i32_cols(_torch(cols), num_keys=1, block_elems=B,
                            merge_elems=M)
    _same_prefix_and_rows(got, want, 1)


def test_prefix_at_i32_max_with_padding():
    """Real rows whose prefix equals the pad value: without pad_safe the pad
    fallback (total comparator) keeps them, identically in both packages."""
    n = 5000
    key = np.where(np.arange(n) % 3 == 0, 2 ** 31 - 1,
                   _cols(1, 12, 100, n)[0]).astype(np.int32)
    cols = [key, _cols(1, 13, 2 ** 31, n)[0]]
    want = _np(jps.sort_i32_cols(tuple(jnp.asarray(c) for c in cols),
                                 num_keys=1, interpret=True))
    got = tps.sort_i32_cols(_torch(cols), num_keys=1, block_elems=B,
                            merge_elems=M)
    _same(got, want)
    assert (got[0].numpy() == 2 ** 31 - 1).sum() == (key == 2 ** 31 - 1).sum()


def test_pad_safe_unique_prefix():
    n = 3000
    rank = np.random.default_rng(14).permutation(n).astype(np.int32)
    cols = [rank, _cols(1, 15, 2 ** 31, n)[0], _cols(1, 16, 2 ** 31, n)[0]]
    want = _np(jps.sort_i32_cols(tuple(jnp.asarray(c) for c in cols),
                                 num_keys=1, pad_safe=True, interpret=True))
    got = tps.sort_i32_cols(_torch(cols), num_keys=1, pad_safe=True,
                            block_elems=256, merge_elems=1024)
    _same(got, want)


def test_traffic_and_launch_model():
    # 9 stages above the merge block, 1..9 cross steps: one pair_cross
    # launch each at one column's span of 9
    s = tbk.sweeps(1 << 24, 1 << 13, 1 << 15)
    assert s == {"block_sort": 1, "multi_stage": 1, "pair_cross": 9,
                 "block_merge": 9}
    assert tbk.fused_traffic_bytes(1 << 24, 1, 1 << 13, 1 << 15) == \
        20 * 2 * 4 * (1 << 24)
    # KV 16M (3 columns, span 8): 10 stages; GROUP BY 256M (2 columns,
    # span 8): 14 stages
    assert tbk.sweeps(1 << 24, 1 << 12, 1 << 14, 3)["pair_cross"] == 12
    assert tbk.sweeps(1 << 28, 1 << 12, 1 << 14, 2)["pair_cross"] == 20
    assert tbk.merge_traffic_bytes(1 << 12, 1, 1 << 10) == 2 * 2 * 4 * 4096


def test_psort_column_helpers_match_reference():
    rng = np.random.default_rng(18)
    cols = [rng.integers(-2 ** 63, 2 ** 63, 500, dtype=np.int64),
            rng.standard_normal(500).astype(np.float16),
            rng.integers(0, 256, 500, dtype=np.uint8),
            rng.integers(0, 2 ** 32, 500, dtype=np.uint32),
            rng.standard_normal(500)]
    jenc, _ = jps.cols_to_i32(tuple(jnp.asarray(c) for c in cols))
    tcols = tuple(interop.to_torch(c, "cpu") for c in cols)
    tenc, spec = tps.cols_to_i32(tcols)
    _same(tenc, _np(jenc))
    for back, c in zip(tps.cols_from_i32(tenc, spec), cols):
        got = interop.to_numpy(back)
        assert got.dtype == c.dtype and got.tobytes() == c.tobytes()
    assert tps.cols_sortable(tcols[3], tenc[0])
    assert not tps.cols_sortable(tcols[3], tcols[0])
    assert tps.cols_encodable(*tcols)
    assert not tps.cols_encodable(torch.zeros(4, dtype=torch.bool))
    flag = (cols[3] & 1).astype(np.int32)
    np.testing.assert_array_equal(
        tps.flag_pos_key(torch.from_numpy(flag), 500).numpy(),
        np.asarray(jps.flag_pos_key(jnp.asarray(flag), 500)))
    # 20 sweeps of one 16M column, plus the padded copy
    assert tps.sort_traffic_bytes(1 << 24, 1) == 21 * 2 * 4 * (1 << 24)


def test_wrapper_argument_checks():
    from cl_ops_tpu_torch.core.errors import BadArgsError
    c = _torch(_cols(1, 17, n=1024))
    with pytest.raises(BadArgsError):
        tbk.block_sort_([c[0][:1000].contiguous()], 8)  # not a power of 2
    with pytest.raises(BadArgsError):
        tbk.block_sort_([c[0].to(torch.int64)], 8)
    with pytest.raises(BadArgsError):
        tbk.block_sort_(c * 9, 8)  # more than MAX_COLS
    with pytest.raises(BadArgsError):
        tbk.pair_cross_(c, 256, 256)  # stage below 2 * distance
    with pytest.raises(BadArgsError):
        tbk.block_merge_(c, 1024, 0, num_keys=2)
    big = [torch.zeros(1 << 16, dtype=torch.int32)] * 2
    with pytest.raises(BadArgsError):  # 2 x 32768 rows exceed shared memory
        tbk.block_sort_(big, 1 << 15)
