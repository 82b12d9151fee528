"""Threefry-2x32 of cl_ops_tpu_torch bit-identical to cl_ops_tpu's."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.rng import threefry as tf

jax = pytest.importorskip("jax")
jtf = pytest.importorskip("cl_ops_tpu.ops.rng.threefry")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 42, 2 ** 31 + 3, 2 ** 32 + 7, 2 ** 64 - 1, -5]


def _inputs():
    ids = np.concatenate([np.arange(512), 2 ** 32 - 1 - np.arange(256),
                          2 ** 31 - 128 + np.arange(256)]).astype(np.uint32)
    ctr = np.concatenate([np.zeros(512), 2 ** 32 - 1 - np.arange(256),
                          np.arange(256) * 977]).astype(np.uint32)
    return ids, ctr


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_matches_reference(seed):
    ids, ctr = _inputs()
    want = np.asarray(jtf.random_bits(seed, ids, ctr))
    got = tf.random_bits(seed, interop.to_torch(ids, "cpu"),
                         interop.to_torch(ctr, "cpu"))
    np.testing.assert_array_equal(interop.to_numpy(got, np.uint32), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_2x_matches_reference(seed):
    ids, ctr = _inputs()
    w0, w1 = (np.asarray(w) for w in jtf.random_bits_2x(seed, ids, ctr))
    g0, g1 = tf.random_bits_2x(seed, torch.from_numpy(ids.astype(np.int64)),
                               torch.from_numpy(ctr.astype(np.int64)))
    np.testing.assert_array_equal(interop.to_numpy(g0, np.uint32), w0)
    np.testing.assert_array_equal(interop.to_numpy(g1, np.uint32), w1)


def test_scalar_counter_broadcasts():
    ids = np.arange(300, dtype=np.uint32)
    want = np.asarray(jtf.random_bits(9, ids, np.uint32(2 ** 32 - 2)))
    got = tf.random_bits(9, torch.arange(300, dtype=torch.int32),
                         2 ** 32 - 2)
    np.testing.assert_array_equal(interop.to_numpy(got, np.uint32), want)


def test_known_answer():
    # Random123 known-answer vector for threefry2x32_20, key = ctr = 0.
    y0, y1 = tf.threefry2x32(0, 0, 0, 0)
    assert (int(y0) & 0xFFFFFFFF, int(y1) & 0xFFFFFFFF) == (
        0x6B200159, 0x99BA4EFE)
    assert tf.key_from_seed(2 ** 32 + 7) == jtf.key_from_seed(2 ** 32 + 7)
