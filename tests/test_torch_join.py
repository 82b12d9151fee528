"""hash_join, hash_join_expand, hash_u32 and verify_deferred of
cl_ops_tpu_torch against cl_ops_tpu (use_pallas=False: its lax.sort merge
probe) and numpy. The CPU runs the port's plain versions of its kernels.

Values where a probe is not found are undefined in both packages and are
not compared. With sorted_output, rows with equal probe keys come out in an
unspecified order on the JAX merge path (an unstable lax.sort), so those
comparisons sort each equal-key group by probe row first; the port's own
orders are stable.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError, ErrorCode
from cl_ops_tpu_torch.defer import DeferredOverflowError, verify_deferred
from cl_ops_tpu_torch.ops.exec import bandprobe as bp
from cl_ops_tpu_torch.ops.exec import hash_join, hash_join_expand, hash_u32
from cl_ops_tpu_torch.ops.exec import join as tjoin

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jex = pytest.importorskip("cl_ops_tpu.ops.exec")
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


IMPLS = ["auto", "direct", "banded", "merge"]


def _t(a):
    return interop.to_torch(np.ascontiguousarray(a), "cpu")


def _n(t):
    if isinstance(t, tuple):
        return tuple(_n(x) for x in t)
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jax(bk, bv, pk, **kw):
    out = jex.hash_join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                        use_pallas=False, **kw)
    return _n(out if isinstance(out, tuple) else (out,))


def _port(bk, bv, pk, **kw):
    out = hash_join(_t(bk), _t(bv), _t(pk), **kw)
    return _n(out if isinstance(out, tuple) else (out,))


def _dim(rng, n_dim=800, dtype=np.uint32, hi=1 << 20):
    dim = np.unique(rng.randint(0, hi, size=n_dim)).astype(dtype)
    probe = np.concatenate([dim[rng.randint(0, len(dim), size=2000)],
                            (rng.randint(0, 500, size=500) + hi)
                            .astype(dtype)])
    rng.shuffle(probe)
    return dim, probe


@pytest.mark.parametrize("impl", IMPLS)
def test_unique_build_every_impl(impl):
    rng = np.random.RandomState(21)
    dim, probe = _dim(rng)
    dv = (dim * 3 + 7).astype(np.int32)
    found, vals = _port(dim, dv, probe, build_sorted=True, probe_impl=impl)
    wf, wv = _jax(dim, dv, probe, build_sorted=True)
    np.testing.assert_array_equal(found, wf)
    np.testing.assert_array_equal(found, np.isin(probe, dim))
    np.testing.assert_array_equal(vals[found], wv[wf])
    np.testing.assert_array_equal(vals[found],
                                  (probe[found] * 3 + 7).astype(np.int32))


@pytest.mark.parametrize("impl", ["direct", "banded", "merge"])
def test_non_unique_build_every_impl(impl):
    """Counts and the first match in build order, against JAX on the same
    stably sorted build side."""
    rng = np.random.RandomState(24)
    build = rng.randint(0, 64, size=600).astype(np.uint32)
    bvals = np.arange(600, dtype=np.int32)
    order = np.argsort(build, kind="stable")
    sb, sv = build[order], bvals[order]
    probe = rng.randint(0, 80, size=900).astype(np.uint32)
    probe[:3] = 0  # the key minimum's lower bound short-circuits
    count, fv = _port(sb, sv, probe, build_sorted=True, unique_build=False,
                      probe_impl=impl)
    wc, wv = _jax(sb, sv, probe, build_sorted=True, unique_build=False)
    np.testing.assert_array_equal(count, wc)
    hit = count > 0
    np.testing.assert_array_equal(fv[hit], wv[hit])
    np.testing.assert_array_equal(count, [(sb == p).sum() for p in probe])
    np.testing.assert_array_equal(
        fv[hit], [sv[np.searchsorted(sb, p)] for p in probe[hit]])


def test_default_build_sort_matches_reference_sorter():
    """Unsorted 4-byte keys go through the abitonic Sorter, which orders
    equal keys as the JAX package's abitonic does: first matches agree
    bit for bit with JAX on its abitonic-sorted build."""
    rng = np.random.RandomState(25)
    build = rng.randint(0, 64, size=600).astype(np.uint32)
    bvals = rng.randint(-1000, 1000, size=600).astype(np.int32)
    probe = rng.randint(0, 80, size=900).astype(np.uint32)
    jk, jv = jsort.sort_new("abitonic", elem_dtype="uint") \
        .sort_with_device_data(jnp.asarray(build), jnp.asarray(bvals))
    wc, wv = _jax(np.asarray(jk), np.asarray(jv), probe, build_sorted=True,
                  unique_build=False)
    count, fv = _port(build, bvals, probe, unique_build=False)
    np.testing.assert_array_equal(count, wc)
    np.testing.assert_array_equal(fv[count > 0], wv[wc > 0])


@pytest.mark.parametrize("join_type", ["semi", "anti"])
@pytest.mark.parametrize("impl", ["direct", "banded", "merge"])
def test_semi_anti(join_type, impl):
    rng = np.random.RandomState(26)
    dim, probe = _dim(rng, 300)
    dv = np.arange(len(dim), dtype=np.int32)
    got = _port(dim, dv, probe, build_sorted=True, join_type=join_type,
                probe_impl=impl)
    want = _jax(dim, dv, probe, build_sorted=True, join_type=join_type)
    np.testing.assert_array_equal(got[0], want[0])
    isin = np.isin(probe, dim)
    np.testing.assert_array_equal(got[0], isin if join_type == "semi"
                                  else ~isin)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("unique_build", [True, False])
def test_u64_keys_and_values(impl, unique_build):
    """Two key limbs and 8-byte values (two value columns) on every
    strategy; unsorted 8-byte keys take the stable build sort, as JAX's."""
    rng = np.random.RandomState(27)
    nb = 1000
    hi = rng.randint(0, 4, size=nb).astype(np.uint64) << np.uint64(33)
    bk = hi + rng.randint(0, 300, size=nb).astype(np.uint64)
    if unique_build:
        bk = np.unique(bk)
        rng.shuffle(bk)
    bv = rng.randint(0, 2 ** 62, size=len(bk), dtype=np.int64) \
        .astype(np.uint64) + np.uint64(2 ** 63)
    pk = np.concatenate([bk[rng.randint(0, len(bk), size=1500)],
                         rng.randint(0, 2 ** 40, size=500).astype(np.uint64)])
    got = _port(bk, bv, pk, unique_build=unique_build, probe_impl=impl)
    want = _jax(bk, bv, pk, unique_build=unique_build)
    np.testing.assert_array_equal(got[0], want[0])
    hit = got[0] > 0 if not unique_build else got[0]
    assert got[1].dtype == np.uint64
    np.testing.assert_array_equal(got[1][hit], want[1][hit])


def _group_rows(keys, rows, *cols):
    """Sort output rows by (probe key, probe row): the JAX merge path's
    order inside equal-key groups is unspecified."""
    order = np.lexsort((rows, keys))
    return [c[order] for c in (rows, *cols)]


@pytest.mark.parametrize("impl", ["auto", "banded", "merge"])
@pytest.mark.parametrize("unique_build", [True, False])
def test_sorted_output_with_probe_cols(impl, unique_build):
    rng = np.random.RandomState(60)
    nb = 1 << 11
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 3
    else:
        bk = np.sort(rng.randint(0, 3 * nb, size=nb).astype(np.uint32))
    bv = np.arange(nb, dtype=np.int32) + 7
    pk = rng.randint(0, 3 * nb, size=1 << 12).astype(np.uint32)
    meas = rng.randint(-2 ** 62, 2 ** 62, size=len(pk)).astype(np.int64)
    kw = dict(build_sorted=True, unique_build=unique_build,
              sorted_output=True)
    hit, vals, rows, (pm, pkc) = _port(bk, bv, pk, probe_impl=impl,
                                       probe_cols=(_t(meas), _t(pk)), **kw)
    whit, wvals, wrows, (wm, wpk) = _jax(
        bk, bv, pk, probe_cols=(jnp.asarray(meas), jnp.asarray(pk)), **kw)
    assert sorted(rows) == list(range(len(pk)))
    assert np.all(np.diff(pk[rows].astype(np.int64)) >= 0)  # grouped
    np.testing.assert_array_equal(pm, meas[rows])
    np.testing.assert_array_equal(pkc, pk[rows])
    # the port's grouping is stable: equal keys keep their probe order
    np.testing.assert_array_equal(rows, np.lexsort((np.arange(len(pk)), pk)))
    got = _group_rows(pk[rows], rows, hit, vals, pm)
    want = _group_rows(pk[wrows], wrows, whit, wvals, wm)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    found = got[1] > 0
    np.testing.assert_array_equal(got[2][found], want[2][found])
    np.testing.assert_array_equal(got[3], want[3])


def test_sorted_output_rejects_direct_and_probe_cols_needs_it():
    bk = np.arange(100, dtype=np.uint32)
    pk = bk[::-1].copy()
    with pytest.raises(BadArgsError, match="direct"):
        hash_join(_t(bk), _t(bk), _t(pk), build_sorted=True,
                  sorted_output=True, probe_impl="direct")
    with pytest.raises(BadArgsError, match="sorted_output"):
        hash_join(_t(bk), _t(bk), _t(pk), probe_cols=(_t(pk),))
    with pytest.raises(BadArgsError):
        hash_join(_t(bk), _t(bk), _t(pk), probe_impl="hashed")
    big = np.arange(bp.DIRECT_MAX + 1, dtype=np.uint32)
    with pytest.raises(BadArgsError, match="too large"):
        hash_join(_t(big), _t(big), _t(pk), probe_impl="direct")


@pytest.mark.parametrize("unique_build,sorted_output",
                         [(True, False), (True, True), (False, False)])
def test_defer_overflow_matches_the_host_synced_form(unique_build,
                                                     sorted_output):
    rng = np.random.RandomState(64)
    nb = 1 << 11
    if unique_build:
        bk = np.arange(nb, dtype=np.uint32) * 2
    else:
        bk = np.sort(rng.randint(0, nb, size=nb).astype(np.uint32))
    bv = np.arange(nb, dtype=np.int32) + 3
    pk = rng.randint(0, 2 * nb, size=1 << 13).astype(np.uint32)
    kw = dict(build_sorted=True, unique_build=unique_build,
              probe_impl="banded", sorted_output=sorted_output)
    out = hash_join(_t(bk), _t(bv), _t(pk), defer_overflow=True, **kw)
    assert out[-1].dtype == torch.bool and not bool(out[-1])
    verify_deferred(out[-1], op_name="join")
    ref = hash_join(_t(bk), _t(bv), _t(pk), **kw)
    for got, want in zip(out[:-1], ref):
        np.testing.assert_array_equal(_n(got), _n(want))
    want = _jax(bk, bv, pk, build_sorted=True, unique_build=unique_build)
    if not sorted_output:
        np.testing.assert_array_equal(_n(out[0]), want[0])


def test_defer_overflow_flags_extreme_skew():
    """A probe block spanning more build rows than its window: the deferred
    form returns True (results garbage) and verify_deferred raises; the
    default form falls back to the merge probe and stays exact."""
    nb = bp.DIRECT_MAX * 8
    bk = np.arange(nb, dtype=np.uint32)
    bv = np.arange(nb, dtype=np.int32)
    pk = np.linspace(0, nb - 1, 1 << 14).astype(np.uint32)
    out = hash_join(_t(bk), _t(bv), _t(pk), build_sorted=True,
                    probe_impl="banded", defer_overflow=True)
    assert bool(out[-1])
    with pytest.raises(DeferredOverflowError, match="join"):
        verify_deferred(out, op_name="join")
    found, vals = _port(bk, bv, pk, build_sorted=True, probe_impl="banded")
    assert found.all()
    np.testing.assert_array_equal(vals, pk.astype(np.int32))
    # direct and merge never overflow: a constant False
    out = hash_join(_t(bk), _t(bv), _t(pk), build_sorted=True,
                    probe_impl="merge", defer_overflow=True)
    assert not bool(out[-1])


@pytest.mark.parametrize("impl", ["banded", "merge"])
@pytest.mark.parametrize("unique_build", [True, False])
def test_two_column_restore_past_pack_max(monkeypatch, impl, unique_build):
    rng = np.random.RandomState(82)
    nb = 1 << 12
    bk = np.arange(nb, dtype=np.uint32) * 3
    bv = np.arange(nb, dtype=np.int32) + 5
    pk = rng.randint(0, 3 * nb, size=4096).astype(np.uint32)
    monkeypatch.setattr(tjoin, "_PACK_MAX", 64)
    hit, vals = _port(bk, bv, pk, build_sorted=True, probe_impl=impl,
                      unique_build=unique_build)
    expect = pk % 3 == 0
    np.testing.assert_array_equal(hit > 0, expect)
    np.testing.assert_array_equal(vals[expect],
                                  (pk[expect] // 3 + 5).astype(np.int32))


@pytest.mark.parametrize("sorted_output", [False, True])
@pytest.mark.parametrize("unique_build", [True, False])
def test_empty_inputs(sorted_output, unique_build):
    e = np.array([], np.uint32)
    ev = np.array([], np.int32)
    bk = np.array([3, 7], np.uint32)
    pk = np.array([7, 1, 3], np.uint32)
    for b, v, p in [(bk, np.array([1, 2], np.int32), e), (e, ev, pk)]:
        out = _port(b, v, p, build_sorted=True, unique_build=unique_build,
                    sorted_output=sorted_output, defer_overflow=True)
        assert len(out[0]) == len(p) and not (out[0] > 0).any()
        assert len(out[1]) == len(p)
        if sorted_output:
            np.testing.assert_array_equal(out[2], np.argsort(p,
                                                             kind="stable"))
        assert not out[-1]


@pytest.mark.parametrize("impl", IMPLS)
def test_expand_matches_reference(impl):
    """All pairs, in (probe key, probe row) order with matches in build
    order, bit for bit with JAX on the same sorted build side."""
    rng = np.random.RandomState(30)
    build = np.sort(rng.randint(0, 50, size=300).astype(np.uint32))
    bvals = rng.randint(-1000, 1000, size=300).astype(np.int32)
    probe = rng.randint(0, 60, size=400).astype(np.uint32)
    cap = 4096
    total, pidx, vals = hash_join_expand(_t(build), _t(bvals), _t(probe),
                                         capacity=cap, build_sorted=True,
                                         probe_impl=impl)
    wt, wp, wv = jex.hash_join_expand(
        jnp.asarray(build), jnp.asarray(bvals), jnp.asarray(probe),
        capacity=cap, build_sorted=True, use_pallas=False)
    t = int(total)
    assert t == int(wt) and total.dtype == torch.int32
    np.testing.assert_array_equal(_n(pidx), np.asarray(wp))
    np.testing.assert_array_equal(_n(vals)[:t], np.asarray(wv)[:t])
    assert (_n(pidx)[t:] == -1).all()


def test_expand_unsorted_build_and_truncation():
    build = np.array([5, 9, 5, 5], np.uint32)
    bvals = np.array([10, 13, 11, 12], np.int32)
    probe = np.array([5, 7, 5], np.uint32)
    total, pidx, vals = hash_join_expand(_t(build), _t(bvals), _t(probe),
                                         capacity=4)
    assert int(total) == 6  # truncated: 2 probes x 3 matches
    np.testing.assert_array_equal(_n(pidx), [0, 0, 0, 2])
    assert sorted(_n(vals)[:3]) == [10, 11, 12]
    total, pidx, _ = hash_join_expand(_t(build), _t(bvals),
                                      _t(np.array([1, 2], np.uint32)),
                                      capacity=4)
    assert int(total) == 0 and (_n(pidx) == -1).all()
    for b, v, p in [(build, bvals, probe[:0]), (build[:0], bvals[:0], probe)]:
        total, pidx, vals = hash_join_expand(_t(b), _t(v), _t(p), capacity=8)
        assert int(total) == 0 and (_n(pidx) == -1).all() and len(vals) == 8
    with pytest.raises(BadArgsError):
        hash_join_expand(_t(build), _t(bvals), _t(probe), capacity=0)


def test_expand_duplicate_probes_dip_across_a_window_boundary(monkeypatch):
    """Duplicate probe keys make pass 2's build positions non-monotone; a
    2-match key straddles build rows 32767-32768 (a build-block boundary)
    with the straddle at output 16384 (a probe-block boundary), and its
    duplicate's dip lands at output 16385. The band path must produce this
    itself, without the fallback."""
    runs = np.array([1] * 20480 + [2] + [2] * 6142 + [1] + [2]
                    + [2] * 4095 + [1] + [1] * (65536 - 40960))
    bk = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    assert len(bk) == 65536
    bv = np.arange(len(bk), dtype=np.int32) + 100
    pk = np.concatenate([
        np.full(2049, bk[20480], np.int32), bk[20482:32766:2], [bk[32766]],
        [bk[32767]], [bk[32767]], np.repeat(bk[32769:40959:2], 2),
        [bk[40959]]]).astype(np.int32)
    calls = []
    monkeypatch.setattr(tjoin, "_expand_from_ranges",
                        lambda *a: calls.append(1))
    total, pidx, vals = hash_join_expand(_t(bk), _t(bv), _t(pk),
                                         capacity=32768, build_sorted=True)
    assert not calls
    order = np.argsort(pk, kind="stable")
    lo = np.searchsorted(bk, pk[order], "left")
    hi = np.searchsorted(bk, pk[order], "right")
    exp_v = np.concatenate([bv[a:b] for a, b in zip(lo, hi)])
    exp_p = np.repeat(order, hi - lo)
    assert int(total) == len(exp_v) == 32768
    np.testing.assert_array_equal(_n(vals), exp_v)
    np.testing.assert_array_equal(_n(pidx), exp_p)


def test_expand_fallbacks_match_numpy(monkeypatch):
    """Two matches per probe on every fourth build key: an output block of
    pass 2 spans four windows of build rows (its overflow flag fires and
    the values are gathered directly). One match per 1000 distinct probes:
    pass 1's window of match-count prefixes overflows (the fallback
    without band passes)."""
    flags = []
    real_band = tjoin.bandprobe.probe_banded_sorted

    def band(*a, **kw):
        out = real_band(*a, **kw)
        flags.append(bool(out[-1]))
        return out

    monkeypatch.setattr(tjoin.bandprobe, "probe_banded_sorted", band)
    calls = []
    real = tjoin._expand_from_ranges
    monkeypatch.setattr(tjoin, "_expand_from_ranges",
                        lambda *a: calls.append(1) or real(*a))
    m = 10000
    build = np.repeat(np.arange(4 * m, dtype=np.uint32), 2)
    bvals = np.arange(8 * m, dtype=np.int32) * 3 + 1
    total, pidx, vals = hash_join_expand(_t(build), _t(bvals),
                                         _t(np.arange(0, 4 * m, 4,
                                                      dtype=np.uint32)),
                                         capacity=2 * m, build_sorted=True)
    assert flags[-2:] == [False, True] and not calls  # pass 2 overflowed
    assert int(total) == 2 * m
    np.testing.assert_array_equal(_n(pidx), np.repeat(np.arange(m), 2))
    rows = (np.arange(m)[:, None] * 8 + [0, 1]).reshape(-1)
    np.testing.assert_array_equal(_n(vals), bvals[rows])
    flags.clear()
    build = np.arange(0, 70000, 1000, dtype=np.uint32)
    bvals = (build * 2 + 1).astype(np.int32)
    probe = np.arange(70000, dtype=np.uint32)
    total, pidx, vals = hash_join_expand(_t(build), _t(bvals), _t(probe),
                                         capacity=100, build_sorted=True)
    assert flags[-1] and calls and int(total) == 70
    np.testing.assert_array_equal(_n(pidx)[:70], build)
    np.testing.assert_array_equal(_n(vals)[:70], bvals)
    assert (_n(pidx)[70:] == -1).all()


def test_expand_u64_keys_and_values():
    rng = np.random.RandomState(84)
    bk = np.sort(rng.randint(0, 300, size=2000).astype(np.uint64)
                 << np.uint64(35))
    bv = rng.randint(0, 1 << 62, size=2000, dtype=np.int64).astype(np.uint64)
    pk = rng.randint(0, 320, size=700).astype(np.uint64) << np.uint64(35)
    total, pidx, vals = hash_join_expand(_t(bk), _t(bv), _t(pk),
                                         capacity=8192, build_sorted=True)
    wt, wp, wv = jex.hash_join_expand(
        jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), capacity=8192,
        build_sorted=True, use_pallas=False)
    t = int(total)
    assert t == int(wt) and vals.dtype == torch.uint64
    np.testing.assert_array_equal(_n(pidx), np.asarray(wp))
    np.testing.assert_array_equal(_n(vals)[:t], np.asarray(wv)[:t])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_hash_u32_bit_for_bit(dtype):
    info = np.iinfo(dtype)
    keys = np.random.default_rng(5).integers(info.min, info.max, 5000,
                                             endpoint=True, dtype=dtype)
    keys[:2] = (info.min, info.max)
    for bits in (1, 10, 16, 31):
        want = np.asarray(jex.hash_u32(jnp.asarray(keys), bits))
        got = hash_u32(_t(keys), bits)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert ((want >= 0) & (want < 2 ** bits)).all()


def test_verify_deferred():
    verify_deferred(torch.tensor(False), np.int32(0), (torch.zeros(3),))
    verify_deferred([torch.zeros(2, dtype=torch.bool)], op_name="x")
    with pytest.raises(DeferredOverflowError, match="overflow flag"):
        verify_deferred(torch.tensor([False, True, True]))
    with pytest.raises(DeferredOverflowError, match="5 dropped rows"):
        verify_deferred(False, torch.tensor([2, 3], dtype=torch.int64))
    with pytest.raises(ValueError):
        verify_deferred()
    err = DeferredOverflowError("x")
    assert isinstance(err, CloOpsError)
    assert err.code == ErrorCode.OUT_OF_RESOURCES


def test_expand_one_match_per_probe_overflows_pass_one(monkeypatch):
    """One match per probe over 40000 probes: window starts fall on
    4096-row build blocks, so a 16384-output block of pass 1 spans more
    than its window and the expansion takes the fallback without band
    passes, as the JAX package does on the same input (ROADMAP queue 3).
    The result stays exact."""
    calls = []
    real = tjoin._expand_from_ranges
    monkeypatch.setattr(tjoin, "_expand_from_ranges",
                        lambda *a: calls.append(1) or real(*a))
    m = 40000
    build = np.arange(m, dtype=np.uint32) * 2
    bvals = np.arange(m, dtype=np.int32) + 9
    probe = build[::-1].copy()
    total, pidx, vals = hash_join_expand(_t(build), _t(bvals), _t(probe),
                                         capacity=m, build_sorted=True)
    assert calls and int(total) == m
    np.testing.assert_array_equal(_n(pidx), np.arange(m)[::-1])
    np.testing.assert_array_equal(_n(vals), bvals)
