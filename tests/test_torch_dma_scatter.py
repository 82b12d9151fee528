"""The blocked run copy of cl_ops_tpu_torch against cl_ops_tpu.

plan_run_chunks must give JAX's (5, n_chunks) int32 table bit for bit, and
chunk_copy (its plain version, on CPU tensors) the same outputs as JAX's
Pallas kernel in interpret mode. JAX's kernel reads two aligned source
blocks per chunk and clamps the second one to the last block; that differs
from a flat read only for reads past the end of the source, which no table
of plan_run_chunks asks for, so the port is held to JAX on such tables
only (and its own past-the-end rule, the sentinel, is checked alone).
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import dma_scatter as tds

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jds = pytest.importorskip("cl_ops_tpu.ops.sort.dma_scatter")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(n, n_cuts, seed, empty_runs=False):
    """Runs covering 0..n-1 cut at random points (some of length 0 with
    empty_runs), their chunk-aligned destinations and the chunk bound."""
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=n_cuts,
                              replace=empty_runs))
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    lengths = (np.concatenate([cuts, [n]]) - starts).astype(np.int32)
    qlen = (lengths + tds.CHUNK - 1) // tds.CHUNK * tds.CHUNK
    qstarts = (np.cumsum(qlen) - qlen).astype(np.int32)
    return starts, qstarts, lengths, n // tds.CHUNK + len(lengths)


def _plan_both(starts, qstarts, lengths, n_chunks):
    want = jds.plan_run_chunks(jnp.asarray(starts), jnp.asarray(qstarts),
                               jnp.asarray(lengths), n_chunks_static=n_chunks)
    got = tds.plan_run_chunks(torch.from_numpy(starts),
                              torch.from_numpy(qstarts),
                              torch.from_numpy(lengths),
                              n_chunks_static=n_chunks)
    assert got.dtype == torch.int32 and got.shape == (5, n_chunks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return want, got


@pytest.mark.parametrize("n,n_cuts,empty,extra", [
    (32 * 1024, 21, False, 0), (5000 * 3, 40, True, 7), (1024, 0, False, 2),
    (777, 5, False, 3)])
def test_plan_run_chunks_matches_reference(n, n_cuts, empty, extra):
    """Random cuts, zero-length runs, one whole run, a source shorter
    than a chunk; `extra` unused chunk slots become whole-sentinel
    chunks."""
    starts, qstarts, lengths, n_chunks = _runs(n, n_cuts, n, empty)
    _plan_both(starts, qstarts, lengths, n_chunks + extra)


def test_chunk_copy_matches_reference():
    """The JAX package's own case (tests/test_sort.py)."""
    rng = np.random.RandomState(70)
    n = 32 * tds.CHUNK
    x = rng.randint(0, 1 << 30, size=n).astype(np.int32)
    starts, qstarts, lengths, n_chunks = _runs(n, 21, 70)
    want_p, got_p = _plan_both(starts, qstarts, lengths, n_chunks)
    (want,) = jds.chunk_copy((jnp.asarray(x).reshape(-1, 128),), want_p,
                             n_chunks=n_chunks, interpret=True)
    (got,) = tds.chunk_copy((torch.from_numpy(x),), got_p, n_chunks=n_chunks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))
    for s, q, ln in zip(starts, qstarts, lengths):
        np.testing.assert_array_equal(got.numpy()[q:q + ln], x[s:s + ln])


def test_chunk_copy_three_arrays_unused_slots():
    """Three arrays in one call, with 5 unused chunk slots (whole-sentinel
    chunks at the leftover destinations) and zero-length runs."""
    rng = np.random.RandomState(71)
    n = 12 * tds.CHUNK
    xs = [rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
          for _ in range(3)]
    starts, qstarts, lengths, n_chunks = _runs(n, 9, 72, True)
    n_chunks += 5
    want_p, got_p = _plan_both(starts, qstarts, lengths, n_chunks)
    want = jds.chunk_copy(tuple(jnp.asarray(x).reshape(-1, 128) for x in xs),
                          want_p, n_chunks=n_chunks, interpret=True)
    got = tds.chunk_copy(tuple(torch.from_numpy(x) for x in xs), got_p,
                         n_chunks=n_chunks)
    assert len(got) == 3
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(-1))
    tail = int(qstarts[-1]) + int(-(-lengths[-1] // tds.CHUNK)) * tds.CHUNK
    assert (got[0].numpy()[tail:] == tds._SENT).all()


def test_chunk_copy_reads_past_the_source_give_sentinel():
    """The port's own rule for a table no plan produces: a chunk reaching
    past the source copies what exists and pads with the sentinel."""
    x = torch.arange(1500, dtype=torch.int32)
    params = torch.tensor([[1], [0], [300 - 256], [1024], [0]],
                          dtype=torch.int32)  # src_elem 1068, rem 1024
    (out,) = tds.chunk_copy((x,), params, n_chunks=1)
    np.testing.assert_array_equal(out[:432].numpy(), np.arange(1068, 1500))
    assert (out[432:] == tds._SENT).all()


def test_chunk_copy_bad_arguments():
    x = torch.zeros(2048, dtype=torch.int32)
    p = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(BadArgsError, match="params"):
        tds.chunk_copy((x,), p, n_chunks=3)
    with pytest.raises(BadArgsError, match="int32"):
        tds.chunk_copy((x.to(torch.int64),), p, n_chunks=2)
    with pytest.raises(BadArgsError, match="length"):
        tds.chunk_copy((x, x[:1024]), p, n_chunks=2)
    with pytest.raises(BadArgsError, match="at least one"):
        tds.chunk_copy((), p, n_chunks=2)
