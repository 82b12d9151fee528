"""top_k and distinct of cl_ops_tpu_torch against cl_ops_tpu, whole outputs.

The same numpy inputs go through JAX (use_pallas=False: lax.sort in place
of its bitonic kernels; both sorts are exact and their keys unique, so the
order is the same) and through the port; every output agrees bit for bit
and equals numpy's stable order. `topk.last_branch` shows which branch the
port took: the fast threshold extraction, its exact fallback, or the small
path that sorts everything.

JAX's sparse group-ends search stops one step short when capacity * 64 < n
and n > 4096; distinct reaches it through the GROUP BY boundary reduce, so
the cases against JAX stay outside that region and a larger sparse case is
held to np.unique alone.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import distinct, top_k
from cl_ops_tpu_torch.ops.exec import topk as ttopk

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jtopk = pytest.importorskip("cl_ops_tpu.ops.exec.topk")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(values, k, largest):
    """Indices of numpy's stable order; for largest, descending by value
    and ascending by position among equal values."""
    if not largest:
        return np.argsort(values, kind="stable")[:k]
    rank = np.unique(values, return_inverse=True)[1]
    return np.lexsort((np.arange(len(values)), -rank))[:k]


def _both(values, k, payloads, largest=False, **kw):
    want = jtopk.top_k(jnp.asarray(values), k,
                       *(jnp.asarray(p) for p in payloads), largest=largest,
                       use_pallas=False, **kw)
    got = top_k(interop.to_torch(values, "cpu"), k,
                *(interop.to_torch(p, "cpu") for p in payloads),
                largest=largest, **kw)
    assert len(got) == len(want) == 1 + len(payloads)
    idx = _oracle(values, k, largest)
    for w, g, ref in zip(want, got, (values, *payloads)):
        w, g = np.asarray(w), interop.to_numpy(g)
        assert g.dtype == w.dtype
        assert g.tobytes() == w.tobytes()
        assert g.tobytes() == ref[idx].tobytes()
    return ttopk.last_branch


def _spread(n):
    """A permutation of 0..n-1 whose small and large values spread evenly
    over the 1024-row blocks (a Weyl sequence), so that no block holds more
    than the extraction's 4 survivors and the fast branch is taken."""
    return np.arange(n, dtype=np.int64) * 7919 % n


@pytest.mark.parametrize("largest", [False, True])
def test_topk_fast_branch(largest):
    n, k = 200_000, 37
    vals = (_spread(n) * 5000).astype(np.uint32)
    pay = np.arange(n, dtype=np.int32)
    wide = np.random.RandomState(0).randint(-2 ** 62, 2 ** 62, n)
    assert _both(vals, k, (pay, wide), largest, sample_size=4096) == "fast"


@pytest.mark.parametrize("largest", [False, True])
def test_topk_duplicate_flood_takes_exact_branch(largest):
    """90% of the rows share the extreme value: the blocks overflow their
    survivor budget and the exact sort runs."""
    rng = np.random.RandomState(1)
    n, k = 32_768, 8
    vals = np.zeros(n, np.uint32) if not largest else \
        np.full(n, 1 << 21, np.uint32)
    vals[: n // 10] = rng.randint(1, 1 << 20, n // 10)
    rng.shuffle(vals)
    pay = np.arange(n, dtype=np.int32)
    assert _both(vals, k, (pay,), largest, sample_size=1024) == "exact"


def test_topk_missed_threshold_takes_exact_branch():
    """The strided sample holds the smallest values, so its quantile cuts
    fewer than k survivors."""
    n, k = 1 << 17, 40
    vals = np.arange(n, dtype=np.int32) + 5000
    vals[::128] = np.arange(1024)  # the rows a 1024-row sample reads
    assert _both(vals, k, (np.arange(n, dtype=np.int32),),
                 sample_size=1024) == "exact"


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.int16,
                                   np.int64, np.uint64, np.float64])
@pytest.mark.parametrize("largest", [False, True])
def test_topk_signed_float_and_wide(dtype, largest):
    """Signed, float and int16 values (with ties) take the fast branch;
    8-byte values (two limbs) the small path."""
    n = 200_000
    base = _spread(n)
    vals = {np.int32: base * 5000 - 500_000_000,
            np.float32: base * 0.001 - 100.0,
            np.int16: base % 65536 - 32768,
            np.int64: base * (1 << 40) - (1 << 60),
            np.uint64: base * (1 << 44),
            np.float64: base * 1e-3 - 100.0}[dtype].astype(dtype)
    pay = np.random.RandomState(3).randint(0, 1 << 16, n).astype(np.uint16)
    branch = _both(vals, 10, (pay,), largest, sample_size=2048)
    assert branch == ("small" if np.dtype(dtype).itemsize == 8 else "fast")


@pytest.mark.parametrize("n,k", [(5, 3), (3, 3), (3, 7), (20_000, 5000)])
def test_topk_small_path(n, k):
    vals = np.random.RandomState(n).randint(-50, 50, n).astype(np.int32)
    kk = min(k, n)
    if k > n:  # JAX slices to the rows it has
        want = jtopk.top_k(jnp.asarray(vals), k, use_pallas=False)
        got = top_k(interop.to_torch(vals, "cpu"), k)
        np.testing.assert_array_equal(interop.to_numpy(got[0]),
                                      np.asarray(want[0]))
        assert ttopk.last_branch == "small"
        return
    assert _both(vals, kk, ()) == "small"


def test_topk_bad_k():
    with pytest.raises(BadArgsError, match="positive"):
        top_k(torch.zeros(8, dtype=torch.int32), 0)


@pytest.mark.parametrize("n,capacity,dtype", [
    (3000, 64, np.uint32), (20_000, 512, np.int32),
    (4000, 4000, np.float32), (2000, 2000, np.uint64)])
def test_distinct_matches_reference(n, capacity, dtype):
    """Dense group ends (capacity * 64 >= n) or n <= 4096: JAX is exact."""
    rng = np.random.RandomState(n)
    hi = min(capacity, 1 << 30)
    vals = rng.randint(0, hi, n).astype(dtype)
    if dtype == np.float32:
        vals = (vals * 0.5 - 100).astype(np.float32)
    want = jtopk.distinct(jnp.asarray(vals), capacity=capacity,
                          use_pallas=False)
    got = distinct(interop.to_torch(vals, "cpu"), capacity=capacity)
    assert int(got[1]) == int(want[1]) == len(np.unique(vals))
    w, g = np.asarray(want[0]), interop.to_numpy(got[0])
    assert g.dtype == w.dtype
    assert g.tobytes() == w.tobytes()


def test_distinct_sparse_matches_numpy():
    """capacity * 64 < n and n > 4096: held to np.unique (JAX's group-ends
    search is one step short here)."""
    rng = np.random.RandomState(21)
    vals = rng.randint(0, 1 << 31, 9000).astype(np.uint32)
    vals[::3] = vals[1::3]  # duplicates
    uniq = np.unique(vals)
    got, cnt = distinct(interop.to_torch(vals, "cpu"), capacity=120)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(interop.to_numpy(got), uniq[:120])
