"""The band probe of cl_ops_tpu_torch (`ops/exec/bandprobe.py`) against
cl_ops_tpu's `_probe_band_kernel` (interpret mode), numpy's searchsorted
and, at the kernel's edge cases (`torch_band_cases.py`), a numpy oracle of
the windowed definition. The CPU runs the port's plain version of its
probe_band kernel. Against JAX, val_next is compared only where count <
nb: both packages leave it undefined at count == nb; the port's definition
fixes it (vals[nb - 1]), and the oracle checks it."""

import numpy as np
import pytest
import torch

import torch_band_cases as cases
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import bandprobe as bp

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jbp = pytest.importorskip("cl_ops_tpu.ops.exec.bandprobe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(res):
    count, eq, vp, vn = (r if isinstance(r, tuple) else (r,)
                         for r in res[:4])
    return (count[0].numpy(), eq[0].numpy(), [v.numpy() for v in vp],
            [v.numpy() for v in vn])


def _assert_same(got, want, nb):
    count, eq, vp, vn = got
    np.testing.assert_array_equal(count, np.asarray(want[0]))
    np.testing.assert_array_equal(eq, np.asarray(want[1]))
    wvp = want[2] if isinstance(want[2], tuple) else (want[2],)
    wvn = want[3] if isinstance(want[3], tuple) else (want[3],)
    live = count < nb
    for g, w in zip(vp, wvp):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(vn, wvn):
        np.testing.assert_array_equal(g[live], np.asarray(w)[live])


def _assert_searchsorted(got, build_key, vals, probe_key):
    count, eq, vp, vn = got
    nb = len(build_key)
    exp = np.searchsorted(build_key, probe_key, side="right")
    np.testing.assert_array_equal(count, exp)
    np.testing.assert_array_equal(eq, np.isin(probe_key, build_key))
    live = exp < nb
    for g_p, g_n, v in zip(vp, vn, vals):
        np.testing.assert_array_equal(g_p, v[np.maximum(exp - 1, 0)])
        np.testing.assert_array_equal(g_n[live], v[exp[live]])


def test_probe_direct_matches_reference_one_limb():
    rng = np.random.RandomState(22)
    build = np.sort(rng.randint(0, 1 << 31, size=700).astype(np.int32))
    nb = len(build)
    vals = (np.arange(nb) * 5 + 2).astype(np.int32)
    probe = rng.randint(0, 1 << 31, size=3000).astype(np.int32)
    probe[:40] = build[rng.randint(0, nb, size=40)]
    probe[40] = 0x7FFFFFFF  # the i32-max probe: the JAX pad sentinel
    want = jbp.probe_direct((jnp.asarray(build),), jnp.asarray(vals),
                            (jnp.asarray(probe),), interpret=True)
    got = _np(bp.probe_direct((_t(build),), _t(vals), (_t(probe),)))
    _assert_same(got, want, nb)
    _assert_searchsorted(got, build, [vals], probe)


def test_probe_direct_matches_reference_two_limbs():
    rng = np.random.RandomState(23)
    hi = rng.randint(-5, 5, size=400).astype(np.int32)
    lo = rng.randint(-9, 9, size=400).astype(np.int32)
    pairs = np.unique(np.stack([hi, lo], 1), axis=0)  # lex-sorted rows
    nb = len(pairs)
    vals = (np.arange(nb) * 3 + 1).astype(np.int32)
    ph = rng.randint(-6, 6, size=1500).astype(np.int32)
    plo = rng.randint(-10, 10, size=1500).astype(np.int32)
    want = jbp.probe_direct(
        (jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])),
        jnp.asarray(vals), (jnp.asarray(ph), jnp.asarray(plo)),
        interpret=True)
    got = _np(bp.probe_direct((_t(pairs[:, 0]), _t(pairs[:, 1])), _t(vals),
                              (_t(ph), _t(plo))))
    _assert_same(got, want, nb)
    key = pairs[:, 0].astype(np.int64) * 100 + pairs[:, 1]
    _assert_searchsorted(got, key, [vals], ph.astype(np.int64) * 100 + plo)


@pytest.mark.parametrize("n_vals", [1, 2, 3])
def test_probe_direct_value_columns_match_numpy(n_vals):
    rng = np.random.RandomState(24 + n_vals)
    build = np.sort(rng.randint(-2 ** 31, 2 ** 31, size=16384)
                    .astype(np.int32))
    vals = tuple(rng.randint(-2 ** 31, 2 ** 31, size=16384).astype(np.int32)
                 for _ in range(n_vals))
    probe = np.concatenate([build[rng.randint(0, 16384, size=3000)],
                            rng.randint(-2 ** 31, 2 ** 31, size=3000)
                            .astype(np.int32)])
    got = _np(bp.probe_direct((_t(build),), tuple(_t(v) for v in vals),
                              (_t(probe),)))
    assert len(got[2]) == len(got[3]) == n_vals
    _assert_searchsorted(got, build, vals, probe)


def test_probe_banded_matches_reference_window_start_and_flag():
    """One 16K-probe block whose window starts past the first build block,
    and the overflow flag, against the Pallas kernel."""
    rng = np.random.RandomState(26)
    nb = 40_000
    build = np.sort(rng.choice(1 << 26, size=nb, replace=False)
                    .astype(np.int32))
    vals = (np.arange(nb) * 3 + 1).astype(np.int32)
    probe = np.sort(rng.randint(1 << 24, (1 << 24) + (1 << 21), size=16384)
                    .astype(np.int32))
    want = jbp.probe_banded_sorted((jnp.asarray(build),), jnp.asarray(vals),
                                   (jnp.asarray(probe),), interpret=True,
                                   probe_rows=128)
    got = bp.probe_banded_sorted((_t(build),), _t(vals), (_t(probe),),
                                 probe_rows=128)
    assert bool(got[4]) == bool(want[4]) is False
    _assert_same(_np(got), want, nb)
    _assert_searchsorted(_np(got), build, [vals], probe)


def test_probe_banded_clustered_blocks_match_numpy():
    """Three full probe blocks, each clustered on a narrow slice of the
    build key range, so each block's span fits its window while the three
    windows start at different build blocks."""
    rng = np.random.RandomState(25)
    nb = bp.DIRECT_MAX * 3 + 777
    build = np.sort(rng.choice(1 << 26, size=nb, replace=False)
                    .astype(np.int32))
    vals = (np.arange(nb) * 3 + 1).astype(np.int32)
    block = bp.PROBE_ROWS * bp.ROW
    lo, mid, hi = (1 << 26) // 4, (1 << 26) // 2, (1 << 26) * 3 // 4
    probe = np.sort(np.concatenate([
        rng.randint(0, lo // 2, size=block),
        rng.randint(mid, mid + lo // 2, size=block),
        rng.randint(hi, hi + lo // 2, size=block)]).astype(np.int32))
    starts, ovf = bp.window_starts(
        (_t(build),), [_t(probe[::block])], [_t(probe[block - 1::block])])
    assert not bool(ovf) and len(set(starts.tolist())) == 3
    got = bp.probe_banded_sorted((_t(build),), _t(vals), (_t(probe),))
    assert not bool(got[4])
    _assert_searchsorted(_np(got), build, [vals], probe)


@pytest.mark.parametrize("n_vals", [1, 2, 3])
def test_probe_banded_block_bounds_match_numpy(n_vals):
    """Non-monotone queries (dips inside each block, across build-block
    boundaries) are exact when the exact per-block bounds are passed."""
    rng = np.random.RandomState(27 + n_vals)
    nb = 5 * bp.BUILD_BLOCK + 123
    build = np.sort(rng.randint(0, 1 << 20, size=nb).astype(np.int32))
    vals = tuple(rng.randint(-2 ** 31, 2 ** 31, size=nb).astype(np.int32)
                 for _ in range(n_vals))
    block = 128 * bp.ROW
    base = np.sort(rng.randint(0, 1 << 20, size=3 * block)).astype(np.int32)
    q = base.reshape(3, block).copy()
    for r in q:  # reverse short runs: the queries dip back inside a block
        for s in range(0, block - 64, 512):
            r[s:s + 64] = r[s:s + 64][::-1]
    q = q.reshape(-1)
    bounds = ((_t(q.reshape(3, block).min(1)),),
              (_t(q.reshape(3, block).max(1)),))
    got = bp.probe_banded_sorted((_t(build),), tuple(_t(v) for v in vals),
                                 (_t(q),), probe_rows=128,
                                 block_bounds=bounds)
    assert not bool(got[4])
    _assert_searchsorted(_np(got), build, vals, q)


def test_overflow_flags_a_block_wider_than_its_window():
    nb = bp.DIRECT_MAX * 4
    build = np.arange(nb, dtype=np.int32)
    probe = np.sort(np.linspace(0, nb - 1, 70000).astype(np.int32))
    *_, ovf = bp.probe_banded_sorted((_t(build),), _t(build), (_t(probe),))
    assert ovf.dtype == torch.bool and ovf.dim() == 0 and bool(ovf)
    # the same span cut into 16K-probe blocks fits each window
    *_, ovf = bp.probe_banded_sorted((_t(build),), _t(build),
                                     (_t(probe[:16384]),), probe_rows=128)
    assert not bool(ovf)


def test_empty_sides_and_checks():
    e = torch.zeros(0, dtype=torch.int32)
    p = torch.tensor([5, -3, 2 ** 31 - 1], dtype=torch.int32)
    count, eq, vp, vn = bp.probe_direct((e,), e, (p,))
    assert count.tolist() == [0, 0, 0] and not eq.any()
    assert vp.tolist() == vn.tolist() == [0, 0, 0]
    out = bp.probe_banded_sorted((p.sort().values,), p, (e,))
    assert out[0].numel() == 0 and not bool(out[4])
    bp.reset_launches()
    with pytest.raises(BadArgsError):
        bp.probe_direct((p.to(torch.int64),), p, (p,))
    with pytest.raises(BadArgsError):
        bp.probe_direct((torch.arange(bp.DIRECT_MAX + 1, dtype=torch.int32),),
                        torch.zeros(bp.DIRECT_MAX + 1, dtype=torch.int32),
                        (p,))
    with pytest.raises(BadArgsError):  # four value columns
        bp.probe_direct((p,), (p,) * 4, (p,))
    assert bp.launches == {"probe_band": 0}  # the CPU ran the plain version


def test_band_pass_traffic_bytes():
    # 256M probes x 16M build, one limb and one value column: 4096 probe
    # blocks each read a 16K-row window of limb and value
    m, nb = 1 << 28, 1 << 24
    assert bp.band_pass_traffic_bytes(m, 1, nb) == \
        4 * m + 13 * m + 4096 * 16384 * 2 * 4
    # a small build side is read whole, once per probe block
    assert bp.band_pass_traffic_bytes(70000, 2, 1000, n_vals=3) == \
        8 * 70000 + 29 * 70000 + 2 * 1000 * 5 * 4


@pytest.mark.parametrize("name", cases.NAMES)
def test_band_edge_cases_match_the_definition(name):
    """The row before the window, probes below every window row, nb = 0
    and 1, windows clamped at nb, equal high limbs, a short last probe
    block, equal runs across chunk edges and an unsorted chunk among
    sorted ones: count, eq and both values by the definition."""
    build, vals, probes, starts, block = cases.case(name)
    got = bp.probe_band(*cases.as_torch(build, vals, probes, starts), block)
    count, eq, vp, vn = cases.oracle(build, vals, probes, starts, block)
    np.testing.assert_array_equal(got[0].numpy(), count)
    np.testing.assert_array_equal(got[1].numpy(), eq)
    for g, w in zip(got[2] + got[3], vp + vn):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ["nb = 1", "equal high limbs",
                                  "equal runs across chunk edges"])
def test_band_edge_cases_match_reference(name):
    """The cases that the JAX entry points reach (probe_direct for the
    one-row build side; probe_banded_sorted at 16K-probe blocks, whose
    window starts the sorted cases use): the Pallas kernel agrees."""
    build, vals, probes, starts, block = cases.case(name)
    j = [[jnp.asarray(np.ascontiguousarray(c)) for c in a.T]
         for a in (build, vals, probes)]
    t = [tuple(_t(c) for c in a.T) for a in (build, vals, probes)]
    if name == "nb = 1":
        want = jbp.probe_direct(tuple(j[0]), tuple(j[1]), tuple(j[2]),
                                interpret=True)
        got = bp.probe_direct(*t)
    else:
        want = jbp.probe_banded_sorted(tuple(j[0]), tuple(j[1]),
                                       tuple(j[2]), interpret=True,
                                       probe_rows=block // bp.ROW)
        got = bp.probe_banded_sorted(*t, probe_rows=block // bp.ROW)
        assert bool(got[4]) == bool(want[4]) is False
    _assert_same(_np(got), want, len(build))


def test_band_geometry():
    """The kernel's launch geometry (band_geometry, which the loader checks
    against csrc/bandprobe.cu): a build side of one window is staged whole
    by 512-thread blocks in whole 32-row lines, its values too where keys
    and values fit one block's shared memory; larger sides stage nothing."""
    whole = bp.WHOLE_THREADS
    assert bp.band_geometry(bp.DIRECT_MAX, 1, 1) == \
        (1, whole, bp.DIRECT_MAX, 2 * bp.DIRECT_MAX * 4)
    assert bp.band_geometry(bp.DIRECT_MAX, 2, 3) == \
        (1, whole, bp.DIRECT_MAX, 2 * bp.DIRECT_MAX * 4)  # values: device
    assert bp.band_geometry(0, 1, 1) == (1, whole, 0, 0)
    assert bp.band_geometry(1000, 2, 1) == (1, whole, 1024, 3 * 1024 * 4)
    for nb in (bp.WINDOW + 1, 1 << 20, 1 << 24):
        assert bp.band_geometry(nb, 2, 3) == (0, bp.SUB_THREADS, 0, 0)
    for nb in range(0, bp.WINDOW + 1, 1000):
        for nl in (1, 2):
            for nv in range(1, bp.MAX_VALS + 1):
                _, _, cap, smem = bp.band_geometry(nb, nl, nv)
                assert cap % 32 == 0 and nb <= cap < nb + 32
                assert nl * cap * 4 <= smem <= bp.SMEM_MAX
