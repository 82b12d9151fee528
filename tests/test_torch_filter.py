"""filter_compact and count_where of cl_ops_tpu_torch against cl_ops_tpu's
(Pallas bitonic compaction in interpret mode), and the plain version of the
partition beneath filter_compact against numpy. The JAX sort's rank prefix
is unique and the port's partition stable, so every output column is
bit-identical, the dropped rows included."""

import numpy as np
import pytest
import torch
import torch_partition_cases as part_cases

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.ops.exec import filter as tflt
from cl_ops_tpu_torch.ops.scan import kernels as sk

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
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


N = 5000


def _data(seed, n=N):
    rng = np.random.default_rng(seed)
    return {
        "u32": rng.integers(0, 2 ** 32, n, dtype=np.uint32),
        "i64": rng.integers(-2 ** 63, 2 ** 63, n, dtype=np.int64),
        "f16": rng.standard_normal(n).astype(np.float16),
        "i8": rng.integers(-128, 128, n, dtype=np.int8),
        "u16": rng.integers(0, 2 ** 16, n, dtype=np.uint16),
        "f64": rng.standard_normal(n),
    }


def _run(data, cols, threshold):
    jout = jflt.filter_compact(
        jnp.asarray(data), lambda v: v < jnp.uint32(threshold),
        *[jnp.asarray(c) for c in cols], use_pallas=True)
    tout = tflt.filter_compact(
        interop.to_torch(data, "cpu"),
        lambda v: interop.widen_u32(v) < threshold,
        *[interop.to_torch(c, "cpu") for c in cols])
    return [np.asarray(a) for a in jout], tout


def _check(jout, tout, data, cols, threshold):
    mask = data < threshold
    assert int(tout[0]) == int(jout[0]) == int(mask.sum())
    for w, g, src in zip(jout[1:], tout[1:], (data, *cols)):
        g = interop.to_numpy(g)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        np.testing.assert_array_equal(g[:int(mask.sum())], src[mask])


@pytest.mark.parametrize("threshold", [429496730, 2 ** 31, 0, 2 ** 32 - 1])
@pytest.mark.parametrize("payload", [("u32",), ("i64", "f16"),
                                     ("i8", "u16", "f64")])
def test_filter_compact_matches_reference(threshold, payload):
    d = _data(1)
    cols = [d[k] for k in payload]
    jout, tout = _run(d["u32"], cols, threshold)
    _check(jout, tout, d["u32"], cols, threshold)


def test_two_column_rank_path(monkeypatch):
    # the JAX sort's wide (flag, position) rank; the port has one path
    monkeypatch.setattr(jflt, "_PACK_MAX", 1024)
    d = _data(2, 3000)
    cols = [d["u32"][::-1].copy(), d["i64"]]
    jout, tout = _run(d["u32"], cols, 2 ** 30)
    _check(jout, tout, d["u32"], cols, 2 ** 30)


def test_filter_float_data():
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    jout = jflt.filter_compact(jnp.asarray(x), lambda v: v > 0.5,
                               use_pallas=True)
    tout = tflt.filter_compact(torch.from_numpy(x), lambda v: v > 0.5)
    assert int(jout[0]) == int(tout[0])
    assert np.asarray(jout[1]).tobytes() == tout[1].numpy().tobytes()


@pytest.mark.parametrize("threshold", [0, 1000, 2 ** 32 - 1])
def test_count_where_matches_reference(threshold):
    x = _data(4)["u32"] % 2000
    want = jflt.count_where(jnp.asarray(x), lambda v: v < jnp.uint32(threshold))
    got = tflt.count_where(interop.to_torch(x, "cpu"),
                           lambda v: interop.widen_u32(v) < threshold)
    assert int(got) == int(want) == int((x < threshold).sum())


def test_filter_rejects_bad_columns():
    x = torch.arange(16, dtype=torch.int32)
    with pytest.raises(BadDtypeError):
        tflt.filter_compact(x, lambda v: v < 3, torch.zeros(16,
                                                           dtype=torch.bool))
    with pytest.raises(BadArgsError):
        tflt.filter_compact(x, lambda v: v < 3, torch.zeros(15,
                                                           dtype=torch.int32))


@pytest.mark.parametrize("mask", part_cases.MASKS)
@pytest.mark.parametrize("n", part_cases.LENGTHS)
def test_partition_plain_matches_numpy(n, mask):
    m = part_cases.mask(mask, n)
    cols = part_cases.columns(n, n)
    got = sk.partition(torch.from_numpy(m),
                       [torch.from_numpy(c) for c in cols])
    assert got[0].dtype == torch.int64 and got[0].dim() == 0
    assert int(got[0]) == int(m.sum())
    for g, w in zip(got[1:], part_cases.expected(m, cols)):
        assert g.numpy().tobytes() == w.tobytes()


def test_partition_plain_more_columns_than_a_launch():
    n = part_cases.TILE + 77
    m = np.random.default_rng(5).random(n) < 0.3
    cols = part_cases.columns(n, 6, part_cases.WIDTHS * 3)
    assert len(cols) > sk.PART_MAX_COLS
    got = sk.partition(torch.from_numpy(m),
                       [torch.from_numpy(c) for c in cols])
    assert int(got[0]) == int(m.sum())
    for g, w in zip(got[1:], part_cases.expected(m, cols)):
        assert g.numpy().tobytes() == w.tobytes()


def test_partition_traffic_is_its_bound():
    # the mask twice, each column once in and once out; a second move
    # launch reads the mask once more
    assert sk.partition_traffic_bytes(100, (4,)) == 100 * (2 + 2 * 4)
    assert sk.partition_traffic_bytes(100, (4, 8)) == 100 * (2 + 2 * 12)
    assert sk.partition_traffic_bytes(10, (1,) * 9) == 10 * (3 + 2 * 9)


def test_partition_rejects_bad_columns():
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(BadArgsError):
        sk.partition(m, [torch.zeros(7, dtype=torch.int32)])
    with pytest.raises(BadArgsError):
        sk.partition(m, [torch.zeros(16, dtype=torch.int32)[::2]])
    with pytest.raises(BadArgsError):
        sk.partition(m.to(torch.int32), [torch.zeros(8, dtype=torch.int32)])
