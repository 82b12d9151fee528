"""GROUP BY of cl_ops_tpu_torch against cl_ops_tpu (use_pallas=False, its
plain reference), whole outputs: group keys, tables and their padding, the
count, and every dtype.

The JAX package's sparse group-ends search (`_searchsorted_2level`) stops
one step early once n > 4096, so sparse cases against JAX keep n < 4096 and
larger sparse cases are held to numpy (test_sparse_groups_match_numpy shows
one input where JAX is wrong and the port is right). Float measures hold
small integers, so their sums are exact in any order."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import aggregate as tagg
from cl_ops_tpu_torch.ops.sort import sort_new

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jagg = pytest.importorskip("cl_ops_tpu.ops.exec.aggregate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 3000        # < 4096: JAX's sparse search is exact here
SPARSE_G = 40   # 40 * 64 < N: the searchsorted form
DENSE_G = 64    # 64 * 64 >= N: the sorted-end-positions form
AGGS = ["sum", "count", "min", "max", "mean"]


def _t(a):
    return interop.to_torch(a, "cpu")


def _cmp(want, got):
    """Whole-output equality of (group_keys, table or tables, count)."""
    assert int(got[-1]) == int(want[-1])
    w_tabs = want[1] if isinstance(want[1], tuple) else (want[1],)
    g_tabs = got[1] if isinstance(got[1], tuple) else (got[1],)
    assert len(w_tabs) == len(g_tabs)
    for w, g in zip((want[0], *w_tabs), (got[0], *g_tabs)):
        w, g = np.asarray(w), interop.to_numpy(g)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _keys(n, g, seed, dtype=np.int32):
    return np.random.default_rng(seed).integers(0, g, n).astype(dtype)


def _vals(n, seed, dtype=np.int32, lo=-1000, hi=1000):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.integers(lo, hi, n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(lo, info.min), min(hi, info.max), n,
                        dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("num_groups", [SPARSE_G, DENSE_G])
def test_sorted_matches_reference(agg, num_groups):
    k, v = _keys(N, num_groups - 3, 1), _vals(N, 2)
    want = jagg.group_aggregate_sorted(jnp.asarray(k), jnp.asarray(v),
                                       num_groups=num_groups, agg=agg,
                                       use_pallas=False)
    got = tagg.group_aggregate_sorted(_t(k), _t(v), num_groups=num_groups,
                                      agg=agg)
    _cmp(want, got)


@pytest.mark.parametrize("kdt,vdt,agg,lo,hi", [
    (np.uint64, np.int64, "sum", -2 ** 63, 2 ** 63 - 1),
    (np.uint64, np.uint64, "mean", 0, 2 ** 63),
    (np.uint32, np.float32, "mean", -50, 50),
    (np.uint32, np.float32, "min", -50, 50),
    (np.int64, np.int64, "min", -2 ** 63, 2 ** 63 - 1),
    (np.int32, np.int64, "max", -2 ** 63, 2 ** 63 - 1),
    (np.int16, np.float16, "max", -500, 500),
    (np.int32, np.uint32, "max", 0, 2 ** 32 - 1),
    (np.int32, np.int8, "sum", -128, 127),
    (np.uint8, np.uint16, "mean", 0, 2 ** 16 - 1),
])
def test_sorted_dtypes_match_reference(kdt, vdt, agg, lo, hi):
    k = _keys(N, SPARSE_G - 1, 3, kdt)
    if kdt in (np.uint64, np.int64):  # keys far apart in the 64-bit range
        k = (k.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)).astype(kdt)
    v = _vals(N, 4, vdt, lo, hi)
    want = jagg.group_aggregate_sorted(jnp.asarray(k), jnp.asarray(v),
                                       num_groups=SPARSE_G, agg=agg,
                                       use_pallas=False)
    got = tagg.group_aggregate_sorted(_t(k), _t(v), num_groups=SPARSE_G,
                                      agg=agg)
    _cmp(want, got)


@pytest.mark.parametrize("agg", ["sum", "min"])
def test_sorted_keys_sorted_and_sorter_paths(agg):
    k, v = _keys(N, SPARSE_G, 5, np.uint32), _vals(N, 6)
    want = jagg.group_aggregate_sorted(jnp.asarray(k), jnp.asarray(v),
                                       num_groups=SPARSE_G, agg=agg,
                                       use_pallas=False)
    sorter = sort_new("abitonic", elem_dtype="uint")
    _cmp(want, tagg.group_aggregate_sorted(_t(k), _t(v), num_groups=SPARSE_G,
                                           agg=agg, sorter=sorter))
    order = np.argsort(k, kind="stable")
    _cmp(want, tagg.group_aggregate_sorted(
        _t(k[order]), _t(v[order]), num_groups=SPARSE_G, agg=agg,
        keys_sorted=True))


@pytest.mark.parametrize("key_bits", [None, 6])
@pytest.mark.parametrize("agg", ["sum", "max"])
def test_prefix_matches_reference(key_bits, agg):
    k, v = _keys(N, DENSE_G, 7), _vals(N, 8, np.uint32, 0, 2 ** 32 - 1)
    n_valid = 2222
    want = jagg.group_aggregate_prefix(
        jnp.asarray(k), jnp.asarray(v), jnp.int32(n_valid),
        num_groups=DENSE_G, agg=agg, key_bits=key_bits, use_pallas=False)
    got = tagg.group_aggregate_prefix(
        _t(k), _t(v), torch.tensor(n_valid), num_groups=DENSE_G, agg=agg,
        key_bits=key_bits)
    _cmp(want, got)


def _cols_case(case):
    k = _keys(N, SPARSE_G, 9)
    a = _vals(N, 10)
    b = _vals(N, 11, np.int64, -2 ** 63, 2 ** 63 - 1)
    c = _vals(N, 12, np.float32, -50, 50)
    mask = np.random.default_rng(13).random(N) < 0.6
    if case == "valid_mask+key_bits":
        return k, (a, b, a, c, a, c), ("sum", "sum", "min", "max", "count",
                                       "mean"), dict(valid_mask=mask,
                                                     key_bits=6)
    if case == "n_valid":
        return k, (c, b, a), ("sum", "min", "mean"), dict(n_valid=1777)
    if case == "first_in_prefix":  # an int64 min leads: key-ordered gathers
        return k, (b, b, a), ("min", "max", "count"), {}
    order = np.argsort(k, kind="stable")
    return k[order], (a[order], c[order]), ("max", "mean"), \
        dict(keys_sorted=True)


@pytest.mark.parametrize("case", ["valid_mask+key_bits", "n_valid",
                                  "first_in_prefix", "keys_sorted"])
def test_cols_matches_reference(case):
    k, vals, aggs, kw = _cols_case(case)
    jvals = [jnp.asarray(v) for v in vals]
    tvals = [_t(v) for v in vals]
    # one tensor object per distinct column, as a caller passes them
    jcols = tuple(jvals[[id(w) for w in vals].index(id(v))] for v in vals)
    tcols = tuple(tvals[[id(w) for w in vals].index(id(v))] for v in vals)
    jkw = {key: (jnp.asarray(x) if key == "valid_mask" else x)
           for key, x in kw.items()}
    tkw = {key: (_t(x) if key == "valid_mask" else x)
           for key, x in kw.items()}
    want = jagg.group_aggregate_cols(jnp.asarray(k), jcols, aggs,
                                     num_groups=SPARSE_G, use_pallas=False,
                                     **jkw)
    got = tagg.group_aggregate_cols(_t(k), tcols, aggs, num_groups=SPARSE_G,
                                    **tkw)
    _cmp(want, got)


@pytest.mark.parametrize("agg", AGGS)
def test_direct_matches_reference(agg):
    rng = np.random.default_rng(14)
    ids = rng.integers(-70, 70, N).astype(np.int32)  # some drop, some wrap
    v = _vals(N, 15, np.uint32, 0, 2 ** 32 - 1) if agg in ("min", "max") \
        else _vals(N, 15)
    want = jagg.group_aggregate_direct(jnp.asarray(ids), jnp.asarray(v),
                                       num_groups=50, agg=agg)
    got = tagg.group_aggregate_direct(_t(ids), _t(v), num_groups=50, agg=agg)
    assert interop.to_numpy(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(want))


def test_empty_input_matches_reference():
    k = np.zeros(0, np.uint32)
    vals = (np.zeros(0, np.int32), np.zeros(0, np.uint32),
            np.zeros(0, np.float32), np.zeros(0, np.int64))
    for v in vals:
        for agg in AGGS:
            _cmp(jagg.group_aggregate_sorted(jnp.asarray(k), jnp.asarray(v),
                                             num_groups=8, agg=agg),
                 tagg.group_aggregate_sorted(_t(k), _t(v), num_groups=8,
                                             agg=agg))
    aggs = ("sum", "mean", "count", "max")
    _cmp(jagg.group_aggregate_cols(jnp.asarray(k),
                                   tuple(jnp.asarray(v) for v in vals), aggs,
                                   num_groups=8),
         tagg.group_aggregate_cols(_t(k), tuple(_t(v) for v in vals), aggs,
                                   num_groups=8))


def _numpy_groupby(k, v, num_groups):
    """(group keys, sums, counts, mins, maxs) over the distinct keys."""
    uniq, inv = np.unique(k, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv, v)
    mins = np.full(len(uniq), np.iinfo(v.dtype).max, v.dtype)
    maxs = np.full(len(uniq), np.iinfo(v.dtype).min, v.dtype)
    np.minimum.at(mins, inv, v)
    np.maximum.at(maxs, inv, v)
    return uniq, sums, np.bincount(inv), mins, maxs


def test_sparse_groups_match_numpy():
    """The input on which the JAX package's group ends land one row early:
    the port agrees with numpy, JAX does not."""
    rng = np.random.RandomState(10)
    k = rng.randint(0, 109, 12288).astype(np.int32)
    v = rng.randint(0, 100, 12288).astype(np.int32)
    uniq, sums, _, _, _ = _numpy_groupby(k, v, 109)
    jgk, jtab, _ = jagg.group_aggregate_sorted(
        jnp.asarray(k), jnp.asarray(v), num_groups=109, use_pallas=False)
    assert (np.asarray(jtab) != sums).sum() == 2  # the reference's fault
    gk, tab, cnt = tagg.group_aggregate_sorted(_t(k), _t(v), num_groups=109)
    assert int(cnt) == len(uniq) == 109
    np.testing.assert_array_equal(gk.numpy(), uniq)
    np.testing.assert_array_equal(tab.numpy(), sums.astype(np.int32))


def test_sparse_cols_match_numpy():
    n, g = 40_000, 300  # 300 * 64 < n: sparse, n > 4096
    k = _keys(n, g, 16, np.uint32)
    v = _vals(n, 17, np.int32, -2 ** 31, 2 ** 31 - 1)
    mask = np.random.default_rng(18).random(n) < 0.5
    gk, (s, c, mn, mx, me), cnt = tagg.group_aggregate_cols(
        _t(k), (_t(v),) * 5, ("sum", "count", "min", "max", "mean"),
        num_groups=g + 5, valid_mask=_t(mask), key_bits=9)
    uniq, sums, counts, mins, maxs = _numpy_groupby(k[mask], v[mask], g)
    m = len(uniq)
    assert int(cnt) == m
    np.testing.assert_array_equal(interop.to_numpy(gk)[:m], uniq)
    wrapped = ((sums + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    np.testing.assert_array_equal(s.numpy()[:m], wrapped)
    np.testing.assert_array_equal(c.numpy()[:m], counts)
    np.testing.assert_array_equal(mn.numpy()[:m], mins)
    np.testing.assert_array_equal(mx.numpy()[:m], maxs)
    np.testing.assert_array_equal(
        me.numpy()[:m], wrapped.astype(np.float32) / counts.astype(np.float32))
    # padding: sums and counts 0, min/max their init, keys skeys[n-1]
    assert (s.numpy()[m:] == 0).all() and (c.numpy()[m:] == 0).all()
    assert (mn.numpy()[m:] == 2 ** 31 - 1).all()
    assert (mx.numpy()[m:] == -2 ** 31).all()


def test_rejects_bad_arguments():
    k, v = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    with pytest.raises(BadArgsError):
        tagg.group_aggregate_sorted(k, v, num_groups=4, agg="median")
    with pytest.raises(BadArgsError):
        tagg.group_aggregate_cols(k, (v,), ("sum", "min"), num_groups=4)
    with pytest.raises(BadArgsError):
        tagg.group_aggregate_cols(k, (v,), ("sum",), num_groups=4,
                                  n_valid=2, keys_sorted=True)
    with pytest.raises(BadArgsError):
        tagg.group_aggregate_prefix(k.to(torch.int64), v, 2, num_groups=4,
                                    key_bits=4)
    with pytest.raises(BadArgsError):
        tagg.group_aggregate_cols(k, (v,), ("sum",), num_groups=4,
                                  n_valid=2, valid_mask=k > 0)
