"""pair_cross's runs of cross steps: the tile-form plain version against
cl_ops_tpu's Pallas pair-cross kernel (interpret mode) applied one step at a
time, the host schedule that cuts a stage's cross steps into runs
(`cross_passes`), and the fused sort and merge with the span cut down so
that stages split into several runs, against the JAX package's.

n = 8192 rows of two int32 columns with heavy ties. With a total
comparator (num_keys None) the outputs are bit-identical; with a num_keys
prefix, the JAX kernel exchanges tied rows that the port leaves in place,
so the prefix column is compared bit for bit and the rows as a multiset.
"""

import functools

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as tbk

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jbk = pytest.importorskip("cl_ops_tpu.ops.sort.bitonic_kernels")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 8192
LANES = 128  # the JAX kernels' rows are 128 lanes wide


def _cols(seed, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(-hi, hi, N).astype(np.int32) for _ in range(2)]


def _jax(cols):
    return tuple(jnp.asarray(c.reshape(-1, LANES)) for c in cols)


def _np(out):
    return [np.asarray(a).reshape(-1) for a in out]


def _check(got, want, num_keys):
    got = [g.numpy() for g in got]
    if num_keys is None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    np.testing.assert_array_equal(got[0], want[0])
    rows = lambda cs: sorted(zip(*[c.tolist() for c in cs]))  # noqa: E731
    assert rows(got) == rows(want)


@pytest.mark.parametrize("num_keys", [None, 1])
@pytest.mark.parametrize("k,j,span", [
    (N, N // 2, 1), (N, N // 2, 2), (N, N // 2, 3), (2048, 1024, 3),
    (0, N // 2, 3), (0, 512, 2)])
def test_tile_form_matches_pallas_steps(k, j, span, num_keys):
    """pair_cross_plain over a run of `span` steps equals JAX's
    _call_pair_cross run once per step (distances in 128-element rows)."""
    cols = _cols(31, 4)
    jl = j >> (span - 1)
    want = _jax(cols)
    for jj in (j >> i for i in range(span)):
        want = jbk._call_pair_cross(want, 1, jj // LANES, k // LANES, True,
                                    num_keys=num_keys)
    got = tbk.pair_cross_([torch.from_numpy(c.copy()) for c in cols], k, j,
                          num_keys, j_last=jl)
    _check(got, _np(want), num_keys)


@pytest.mark.parametrize("steps,span,runs", [
    (9, 9, 1), (9, 2, 5), (10, 8, 2), (14, 8, 2), (5, 1, 5), (3, 7, 1)])
def test_cross_passes_cover_every_step_once(steps, span, runs):
    m = 1 << 15
    j_hi = m << (steps - 1)
    passes = tbk.cross_passes(2 * j_hi, j_hi, m, span)
    assert len(passes) == runs == -(-steps // span)
    covered = [jj for j, jl in passes for jj in
               (j >> i for i in range(j.bit_length() - jl.bit_length() + 1))]
    assert covered == [j_hi >> i for i in range(steps)]  # descending, once
    assert all(j.bit_length() - jl.bit_length() < span for j, jl in passes)


def test_cross_passes_of_the_16m_sort():
    """16M u32 at the default geometry (M = 2^15, span 9): 9 stages above
    the merge block, one pass each, equal to sweeps()."""
    n, m, span = 1 << 24, 1 << 15, tbk.cross_span(1)
    assert span == 9
    passes = [p for sk in range(16, 25)
              for p in tbk.cross_passes(1 << sk, 1 << (sk - 1), m, span)]
    assert len(passes) == 9 == tbk.sweeps(n, 1 << 13, m)["pair_cross"]
    assert tbk.cross_passes(0, m // 2, m, span) == []
    with pytest.raises(BadArgsError):
        tbk.cross_passes(1 << 16, 1 << 16, m, span)  # stage below 2 x j


def _counting(monkeypatch):
    """Record the (j, j_last) of every pair_cross_ call."""
    calls, inner = [], tbk.pair_cross_

    def counted(cols, k, j, num_keys=None, *, j_last=None):
        calls.append((j, j if j_last is None else j_last))
        return inner(cols, k, j, num_keys, j_last=j_last)
    monkeypatch.setattr(tbk, "pair_cross_", counted)
    return calls


@functools.cache
def _jax_fused_sort(hi, num_keys):
    """JAX's fused sort of _cols(32, hi) at B = 512, M = 1024 (4 and 8
    rows of 128), computed once for both spans."""
    return _np(jbk.bitonic_sort_2d(_jax(_cols(32, hi)), block_rows=4,
                                   fused=True, interpret=True, merge_rows=8,
                                   single_launch=False, num_keys=num_keys))


@pytest.mark.parametrize("span", [1, 2])
@pytest.mark.parametrize("hi,num_keys", [(2 ** 31, None), (4, None), (4, 1)])
def test_split_stages_match_fused_pallas_sort(monkeypatch, span, hi,
                                              num_keys):
    """bitonic_sort_2d with the span cut to 1 and 2 (B = 512, M = 1024:
    stages of 1, 2 and 3 cross steps) equals JAX's fused bitonic_sort_2d,
    in sweeps() launches of at most `span` steps."""
    monkeypatch.setattr(tbk, "cross_span", lambda n_cols: span)
    calls = _counting(monkeypatch)
    cols = _cols(32, hi)
    want = _jax_fused_sort(hi, num_keys)
    got = tbk.bitonic_sort_2d([torch.from_numpy(c.copy()) for c in cols],
                              block_elems=512, merge_elems=1024,
                              num_keys=num_keys)
    _check(got, want, num_keys)
    assert len(calls) == tbk.sweeps(N, 512, 1024, 2)["pair_cross"] == \
        (6 if span == 1 else 4)
    assert all(j.bit_length() - jl.bit_length() < span for j, jl in calls)


@pytest.mark.parametrize("span", [1, 2])
def test_split_merge_matches_pallas_merge(monkeypatch, span):
    """bitonic_merge_2d (stage K = 0) with its 3 cross steps cut into runs
    equals JAX's merge of the same bitonic sequence."""
    monkeypatch.setattr(tbk, "cross_span", lambda n_cols: span)
    calls = _counting(monkeypatch)
    rng = np.random.default_rng(33)
    a = np.sort(rng.integers(-50, 50, N // 2)).astype(np.int32)
    b = np.sort(rng.integers(-50, 50, N // 2)).astype(np.int32)
    seq = [np.concatenate([a, b[::-1]])]
    want = _np(jbk.bitonic_merge_2d(_jax(seq), block_rows=8, interpret=True))
    got = tbk.bitonic_merge_2d([torch.from_numpy(seq[0].copy())],
                               merge_elems=1024)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[0].numpy(), np.sort(seq[0]))
    assert len(calls) == -(-3 // span)


def test_pair_cross_run_limits():
    c = [torch.zeros(1 << 16, dtype=torch.int32)]
    span = tbk.cross_span(1)
    tbk.pair_cross_(c, 0, 1 << 15, j_last=1 << (16 - span))  # span steps
    with pytest.raises(BadArgsError):  # one step more than a launch takes
        tbk.pair_cross_(c, 0, 1 << 15, j_last=1 << (15 - span))
    with pytest.raises(BadArgsError):
        tbk.pair_cross_(c, 0, 1 << 10, j_last=1 << 11)  # j_last above j
    with pytest.raises(BadArgsError):
        tbk.pair_cross_(c, 0, 1 << 10, j_last=3)  # not a power of two
    assert [tbk.cross_span(n) for n in range(1, 9)] == [9, 8, 8, 7, 7, 7, 6,
                                                        6]
