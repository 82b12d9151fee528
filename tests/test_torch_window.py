"""Window functions of cl_ops_tpu_torch against cl_ops_tpu, whole outputs.

The same numpy inputs go through JAX's window_cols (use_pallas=False: its
lax.sort and XLA segmented scans; the sort's (key, order, position) prefix
is unique, so both packages put the rows in one order) and the port's.
Integer outputs agree bit for bit. Float32 running sums and means are
taken in another order by each package's segmented scan, so they are held
to 1e-5 of the running sum of |x| in the partition plus 1e-6 (about 84
float32 ulps of that sum); their measures are small integers scaled by
0.25, whose sums are exact in float32 at these sizes, so in practice they
agree exactly too.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import WINDOW_AGGS, window_cols, window_scan

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jwin = pytest.importorskip("cl_ops_tpu.ops.exec.window")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NO_MEASURE = ("count", "row_number", "rank", "dense_rank")


def _case(n, n_keys, seed, val_dtype=np.uint32):
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, n_keys, n).astype(np.uint32)
    order = rng.randint(0, 50, n).astype(np.int32)  # ties likely
    if np.issubdtype(val_dtype, np.floating):
        vals = (rng.randint(-400, 400, n) * 0.25).astype(val_dtype)
    else:
        vals = rng.randint(0, 1000, n).astype(val_dtype)
    return keys, order, vals


def _abs_running_sums(keys, order, vals):
    """Per row, the running sum of |x| over its partition in window order
    (the float tolerance's scale)."""
    n = len(keys)
    idx = np.lexsort((np.arange(n), order, keys))
    out = np.zeros(n)
    run, prev = 0.0, None
    for i in idx:
        run = abs(float(vals[i])) + (run if keys[i] == prev else 0.0)
        prev = keys[i]
        out[i] = run
    return out


def _check(want, got, tol_scale=None):
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w, g = np.asarray(w), interop.to_numpy(g)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if w.dtype.kind == "f" and tol_scale is not None:
            # identities of exclusive min/max (+-inf) equal exactly
            fin = np.isfinite(w)
            np.testing.assert_array_equal(g[~fin], w[~fin])
            np.testing.assert_array_less(
                np.abs(g[fin].astype(np.float64) - w[fin]),
                1e-5 * tol_scale[fin] + 1e-6)
        else:
            np.testing.assert_array_equal(g, w)


def _run(keys, order, vals, aggs, **kw):
    """JAX and the port on the same arrays (one measure object for every
    slot that takes one)."""
    jv, tv = jnp.asarray(vals), interop.to_torch(vals, "cpu")
    want = jwin.window_cols(
        jnp.asarray(keys), None if order is None else jnp.asarray(order),
        tuple(None if a in NO_MEASURE else jv for a in aggs), aggs,
        use_pallas=False, **kw)
    got = window_cols(
        interop.to_torch(keys, "cpu"),
        None if order is None else interop.to_torch(order, "cpu"),
        tuple(None if a in NO_MEASURE else tv for a in aggs), aggs, **kw)
    return want, got


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("n,n_keys", [(300, 7), (3000, 1), (2000, 300)])
def test_every_agg_matches_reference(n, n_keys, exclusive):
    keys, order, vals = _case(n, n_keys, n + n_keys)
    want, got = _run(keys, order, vals, WINDOW_AGGS, exclusive=exclusive)
    _check(want, got)


@pytest.mark.parametrize("aggs", [("sum", "mean", "min", "max", "lag"),
                                  ("lead", "count", "row_number")])
def test_unordered_partitions(aggs):
    keys, _, vals = _case(1000, 9, 4)
    want, got = _run(keys, None, vals, aggs)
    _check(want, got)
    want, got = _run(keys, None, vals, aggs, exclusive=True)
    _check(want, got)


@pytest.mark.parametrize("n_keys", [5, 400])
def test_sorted_output_matches_reference(n_keys):
    keys, order, vals = _case(1500, n_keys, 6)
    aggs = ("sum", "row_number", "rank", "lead")
    (want, wsrc), (got, gsrc) = _run(keys, order, vals, aggs,
                                     sorted_output=True)
    _check(want, got)
    np.testing.assert_array_equal(interop.to_numpy(gsrc), np.asarray(wsrc))
    assert sorted(interop.to_numpy(gsrc).tolist()) == list(range(1500))
    # the restore form is the sorted form put back by row_src
    restored = window_cols(interop.to_torch(keys, "cpu"),
                           interop.to_torch(order, "cpu"),
                           tuple(None if a in NO_MEASURE else
                                 interop.to_torch(vals, "cpu")
                                 for a in aggs), aggs)
    src = interop.to_numpy(gsrc)
    for r, s in zip(restored, got):
        np.testing.assert_array_equal(interop.to_numpy(r)[src],
                                      interop.to_numpy(s))


@pytest.mark.parametrize("exclusive", [False, True])
def test_float32_measure(exclusive):
    keys, order, vals = _case(2500, 13, 8, np.float32)
    aggs = ("sum", "mean", "min", "max", "lag", "lead")
    want, got = _run(keys, order, vals, aggs, exclusive=exclusive)
    _check(want, got, _abs_running_sums(keys, order, vals))


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.int16])
def test_other_measure_dtypes(dtype):
    """8-byte measures take the wide segmented scans; int16 is widened."""
    keys, order, vals = _case(1200, 11, 9, dtype)
    aggs = ("sum", "min", "max", "lag", "lead", "mean")
    want, got = _run(keys, order, vals, aggs)
    _check(want, got)


def test_window_scan_and_signed_keys():
    rng = np.random.RandomState(12)
    keys = rng.randint(-5, 5, 900).astype(np.int64)
    order = rng.randn(900).astype(np.float32)
    vals = rng.randint(-100, 100, 900).astype(np.int32)
    for agg in ("sum", "rank", "dense_rank", "max"):
        v = None if agg in NO_MEASURE else vals
        want = jwin.window_scan(jnp.asarray(keys), None if v is None else
                                jnp.asarray(v), jnp.asarray(order), agg=agg,
                                use_pallas=False)
        got = window_scan(interop.to_torch(keys, "cpu"),
                          None if v is None else interop.to_torch(v, "cpu"),
                          interop.to_torch(order, "cpu"), agg=agg)
        _check((want,), (got,))


def test_bad_arguments():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(BadArgsError, match="order column"):
        window_cols(k, None, (None,), ("rank",))
    with pytest.raises(BadArgsError, match="needs a measure"):
        window_cols(k, k, (None,), ("sum",))
    with pytest.raises(BadArgsError, match="unknown window agg"):
        window_cols(k, k, (k,), ("median",))
    with pytest.raises(BadArgsError, match="equal-length"):
        window_cols(k, k, (k, k), ("sum",))
