"""The slices as a whole: generate_table, sort_pipeline and a filter over a
generated table, cl_ops_tpu_torch against cl_ops_tpu (Pallas kernels in
interpret mode), bit for bit; analytics_query, q1_query, star_query and
rollup_query against cl_ops_tpu (use_pallas=False) and against numpy."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import CloOpsError
from cl_ops_tpu_torch.models import pipeline as tpl
from cl_ops_tpu_torch.ops.exec import filter_compact
from cl_ops_tpu_torch.ops.rng import threefry

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jpl = pytest.importorskip("cl_ops_tpu.models.pipeline")
jflt = pytest.importorskip("cl_ops_tpu.ops.exec.filter")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 7, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spaces", [(1 << 20, 1 << 10), (1000, 7)])
def test_generate_table_matches_reference(seed, spaces):
    ks, vs = spaces
    wk, wv = jpl.generate_table(3000, seed, key_space=ks, value_space=vs)
    gk, gv = tpl.generate_table(3000, seed, key_space=ks, value_space=vs,
                                device="cpu")
    assert gk.dtype == gv.dtype == torch.uint32
    np.testing.assert_array_equal(interop.to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(interop.to_numpy(gv), np.asarray(wv))


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_pipeline_matches_reference(seed):
    wk, wok = jpl.sort_pipeline(4096, seed, use_pallas=True)
    gk, gok = tpl.sort_pipeline(4096, seed, device="cpu")
    assert bool(wok) and bool(gok)
    np.testing.assert_array_equal(interop.to_numpy(gk), np.asarray(wk))


def test_filter_over_generated_table():
    wk, wv = jpl.generate_table(5000, 3)
    want = jflt.filter_compact(wv, lambda v: v < jnp.uint32(512), wk,
                               use_pallas=True)
    gk, gv = tpl.generate_table(5000, 3, device="cpu")
    got = filter_compact(gv, lambda v: interop.widen_u32(v) < 512, gk)
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(w))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CloOpsError):
        tpl.generate_table(16)
    with pytest.raises(CloOpsError):
        interop.to_torch(np.arange(4))


def test_analytics_query_matches_reference_and_numpy():
    n, g, threshold = 8192, 64, 300
    wc, wt = jpl.analytics_query(n, num_groups=g, seed=4,
                                 threshold=threshold, use_pallas=False)
    gc, gt = tpl.analytics_query(n, num_groups=g, seed=4,
                                 threshold=threshold, device="cpu")
    assert int(gc) == int(wc)
    assert gt.dtype == torch.uint32
    np.testing.assert_array_equal(interop.to_numpy(gt), np.asarray(wt))
    keys, vals = (interop.to_numpy(t) for t in
                  tpl.generate_table(n, 4, device="cpu"))
    m = vals < threshold
    assert int(gc) == int(m.sum())
    want = np.bincount(keys[m] % g, weights=vals[m], minlength=g)
    np.testing.assert_array_equal(interop.to_numpy(gt), want)


@pytest.mark.parametrize("num_groups", [64, 2048])  # sparse, dense
def test_q1_query_matches_reference_and_numpy(num_groups):
    n = 8192
    want = jpl.q1_query(n, num_groups=num_groups, seed=5, use_pallas=False)
    got = tpl.q1_query(n, num_groups=num_groups, seed=5, device="cpu")
    assert int(got[0]) == int(want[0]) and int(got[3]) == int(want[3])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for w, g in zip(want[2], got[2]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # numpy over the same generated columns
    ids = torch.arange(n, dtype=torch.int32)
    cols = [interop.widen_u32(threefry.random_bits(5, ids, c)).numpy() % m
            for c, m in ((0, num_groups), (1, 1024), (2, 10000))]
    keys, qty, price = cols
    mask = qty < 768
    k, q, p = keys[mask], qty[mask], price[mask]
    uniq = np.unique(k)
    cnt = np.bincount(k, minlength=num_groups)[uniq]
    mn = np.full(num_groups, 2 ** 31 - 1)
    mx = np.full(num_groups, -2 ** 31)
    np.minimum.at(mn, k, q)
    np.maximum.at(mx, k, p)
    sp = np.bincount(k, weights=p, minlength=num_groups)[uniq]
    m = len(uniq)
    assert int(got[0]) == int(mask.sum()) and int(got[3]) == m
    np.testing.assert_array_equal(got[1].numpy()[:m], uniq)
    tabs = [t.numpy()[:m] for t in got[2]]
    np.testing.assert_array_equal(
        tabs[0], np.bincount(k, weights=q, minlength=num_groups)[uniq])
    np.testing.assert_array_equal(tabs[1], sp)
    np.testing.assert_array_equal(tabs[2], mn[uniq])
    np.testing.assert_array_equal(tabs[3], mx[uniq])
    np.testing.assert_array_equal(tabs[4], cnt)
    np.testing.assert_allclose(tabs[5], sp / cnt, rtol=2 ** -23)


def test_star_query_matches_reference_and_numpy():
    n, dim_rows, cats = 1 << 14, 1 << 10, 32
    wc, wt = jpl.star_query(n, dim_rows=dim_rows, num_cats=cats, seed=3,
                            threshold=512, use_pallas=False)
    gc, gt = tpl.star_query(n, dim_rows=dim_rows, num_cats=cats, seed=3,
                            threshold=512, device="cpu")
    assert int(gc) == int(wc)
    assert gt.dtype == torch.uint32
    np.testing.assert_array_equal(interop.to_numpy(gt), np.asarray(wt))
    keys, vals = (interop.to_numpy(t) for t in
                  tpl.generate_table(n, 3, key_space=dim_rows, device="cpu"))
    ids = torch.arange(dim_rows, dtype=torch.int32)
    dim_cat = interop.widen_u32(threefry.random_bits(4, ids, 2)).numpy() % cats
    keep = vals < 512
    assert int(gc) == int(keep.sum())
    want = np.zeros(cats, np.uint32)
    np.add.at(want, dim_cat[keys[keep]], vals[keep])
    np.testing.assert_array_equal(interop.to_numpy(gt), want)


def _rollup_numpy(n, dim_rows, seed=0):
    keys, meas = (interop.to_numpy(t) for t in tpl.generate_table(
        n, seed, key_space=2 * dim_rows, device="cpu"))
    uniq = np.unique(keys)
    contrib = np.where(keys % 2 == 0, meas.astype(np.int64), 0)
    return uniq, np.bincount(keys, weights=contrib,
                             minlength=2 * dim_rows)[uniq]


def test_rollup_query_matches_reference_and_numpy():
    n, dim_rows = 1 << 13, 1 << 9
    wk, wt, wc = jpl.rollup_query(n, dim_rows=dim_rows, use_pallas=False)
    gk, gt, gc, ovf = tpl.rollup_query(n, dim_rows=dim_rows, defer=True,
                                       device="cpu")
    assert not bool(ovf) and int(gc) == int(wc)
    k = int(gc)
    np.testing.assert_array_equal(gk.numpy()[:k], np.asarray(wk)[:k])
    np.testing.assert_array_equal(gt.numpy()[:k], np.asarray(wt)[:k])
    uniq, sums = _rollup_numpy(n, dim_rows)
    assert k == len(uniq)
    np.testing.assert_array_equal(gk.numpy()[:k], uniq)
    np.testing.assert_array_equal(gt.numpy()[:k], sums)


def test_rollup_query_overflow_reruns_through_merge():
    """A dimension of two windows that one probe block spans: the deferred
    form returns the flag set, and the default form re-runs through the
    merge probe and stays exact."""
    n, dim_rows = 1 << 13, 1 << 15
    *_, ovf = tpl.rollup_query(n, dim_rows=dim_rows, defer=True,
                               device="cpu")
    assert bool(ovf)
    gk, gt, gc = tpl.rollup_query(n, dim_rows=dim_rows, device="cpu")
    uniq, sums = _rollup_numpy(n, dim_rows)
    k = int(gc)
    assert k == len(uniq)
    np.testing.assert_array_equal(gk.numpy()[:k], uniq)
    np.testing.assert_array_equal(gt.numpy()[:k], sums)


def test_models_export_every_pipeline():
    """models exports the six pipelines, JAX's five among them."""
    from cl_ops_tpu import models as jmodels

    from cl_ops_tpu_torch import models
    assert set(jmodels.__all__) <= set(models.__all__)
    for name in models.__all__:
        assert getattr(models, name) is getattr(tpl, name)
    assert models.star_query is tpl.star_query
    assert models.rollup_query is tpl.rollup_query


@pytest.mark.parametrize("call", [
    lambda: tpl.rollup_query(64, 16, 0, False),
    lambda: tpl.rollup_query(64, 16, 0, False, True),
    lambda: tpl.star_query(64, 16, 4, 0, 512, False),
    lambda: tpl.analytics_query(64, 16, 0, 512, False),
    lambda: tpl.q1_query(64, 16, 0, 768, False),
    lambda: tpl.sort_pipeline(64, 0, False),
    lambda: tpl.generate_table(64, 0, 16, 16, "cpu"),
])
def test_jax_positional_use_pallas_raises(call):
    """JAX's pipelines take use_pallas by position after their shared
    arguments; the port's device and defer are keyword-only, so such a
    call raises before any work instead of changing meaning."""
    with pytest.raises(TypeError):
        call()
