"""Dense GROUP BY of cl_ops_tpu_torch against cl_ops_tpu, whole outputs.

The same numpy inputs go through JAX's group_aggregate_dense_cols (its
use_pallas=False oracle, and the Pallas kernel in interpret mode in both of
its forms: unrolled for num_groups <= 128, a traced loop above) and through
the port's, whose dense_agg runs its plain version on CPU tensors. Group
keys, every table with its padding rows, and the count must agree bit for
bit (float32 min/max and means included: min/max of float32 are exact, and
both packages take a mean as one float32 divide of the same integer sum by
the same count).
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import dense_agg as tdense
from cl_ops_tpu_torch.ops.exec import group_aggregate_dense_cols

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdense = pytest.importorskip("cl_ops_tpu.ops.exec.dense_agg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(n, num_groups, seed):
    """Ids with some out of range, an int32, a u32, a float32, an int8 and
    a uint16 measure, and a mask keeping about two thirds of the rows."""
    rng = np.random.RandomState(seed)
    gid = rng.randint(-2, num_groups + 2, n).astype(np.int32)
    cols = {"i32": rng.randint(-900, 900, n).astype(np.int32),
            "u32": rng.randint(0, 1 << 32, n, dtype=np.int64)
            .astype(np.uint32),
            "f32": rng.randn(n).astype(np.float32),
            "i8": rng.randint(-128, 128, n).astype(np.int8),
            "u16": rng.randint(0, 1 << 16, n).astype(np.uint16)}
    mask = cols["i32"] < 300
    return gid, cols, mask


# (column, agg) slots: repeated columns, every agg, u32 and f32 min/max,
# means of int32, u32 and narrow ints, and sums that wrap in int8.
SLOTS = (("i32", "sum"), ("i32", "min"), ("u32", "max"), ("i32", "count"),
         ("f32", "min"), ("f32", "max"), ("u32", "mean"), ("u32", "min"),
         ("u32", "sum"), ("i8", "sum"), ("i8", "mean"), ("u16", "max"),
         ("u16", "min"), ("i32", "mean"))


def _both(gid, cols, slots, num_groups, mask=None, **jax_kw):
    """Run JAX and the port on the same arrays; a column in several slots
    is the same array object in both."""
    j_cols = {k: jnp.asarray(v) for k, v in cols.items()}
    t_cols = {k: interop.to_torch(v, "cpu") for k, v in cols.items()}
    aggs = tuple(a for _, a in slots)
    want = jdense.group_aggregate_dense_cols(
        jnp.asarray(gid), tuple(j_cols[c] for c, _ in slots), aggs,
        num_groups=num_groups,
        valid_mask=None if mask is None else jnp.asarray(mask), **jax_kw)
    got = group_aggregate_dense_cols(
        interop.to_torch(gid, "cpu"), tuple(t_cols[c] for c, _ in slots),
        aggs, num_groups=num_groups,
        valid_mask=None if mask is None else interop.to_torch(mask, "cpu"))
    return want, got


def _cmp(want, got):
    """Whole outputs, bit for bit (NaN padding rows of float32 tables
    included)."""
    assert int(got[2]) == int(want[2])
    assert len(got[1]) == len(want[1])
    for w, g in zip((want[0], *want[1]), (got[0], *got[1])):
        w, g = np.asarray(w), interop.to_numpy(g)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("num_groups", [4, 37, 200])
def test_dense_matches_reference(num_groups, masked):
    gid, cols, mask = _case(3000, num_groups, num_groups)
    _cmp(*_both(gid, cols, SLOTS, num_groups, mask if masked else None,
                use_pallas=False))


@pytest.mark.parametrize("num_groups", [37, 200])
def test_dense_matches_pallas_kernel(num_groups):
    """Both forms of the TPU kernel, in interpret mode, on two row
    blocks."""
    gid, cols, mask = _case(1500, num_groups, 5)
    slots = (("i32", "sum"), ("u32", "min"), ("f32", "max"),
             ("i32", "count"), ("i32", "mean"))
    _cmp(*_both(gid, cols, slots, num_groups, mask, block_rows=8,
                interpret=True))


def test_dense_present_groups_only_from_valid_rows():
    """Groups whose every row is masked out or whose ids never occur are
    padding, in ascending order after the present ones."""
    gid = np.array([5, 1, 1, 7, 3, 5, 9, -1], np.int32)
    v = np.arange(8, dtype=np.int32) * 3
    mask = np.array([1, 1, 0, 0, 1, 1, 1, 1], bool)
    cols = {"i32": v}
    want, got = _both(gid, cols, (("i32", "sum"), ("i32", "max")), 8, mask,
                      use_pallas=False)
    _cmp(want, got)
    assert interop.to_numpy(got[0]).tolist() == [1, 3, 5, 0, 2, 4, 6, 7]


@pytest.mark.parametrize("num_groups", [1, 4])
def test_dense_empty_and_all_masked(num_groups):
    """n = 0 and an all-masked input: no group present (count 0), every
    table its decoded identity; held to the Pallas kernel, which pads the
    empty input to one block."""
    gid, cols, _ = _case(0, num_groups, 3)
    slots = (("i32", "sum"), ("u32", "min"), ("f32", "max"),
             ("i32", "count"))
    _cmp(*_both(gid, cols, slots, num_groups, block_rows=8, interpret=True))
    gid, cols, _ = _case(500, num_groups, 4)
    _cmp(*_both(gid, cols, slots, num_groups, np.zeros(500, bool),
                use_pallas=False))


def test_dense_id_dtypes():
    """uint32 and int64 ids convert to int32 as JAX's astype does (a u32
    id past 2^31 is negative, so dropped)."""
    rng = np.random.RandomState(8)
    v = rng.randint(-50, 50, 800).astype(np.int32)
    for ids in (rng.randint(0, 40, 800).astype(np.uint32),
                np.where(rng.rand(800) < 0.1, 1 << 31, 7).astype(np.uint32),
                rng.randint(-3, 40, 800).astype(np.int64)):
        _cmp(*_both(ids, {"i32": v}, (("i32", "sum"), ("i32", "min")), 32,
                    use_pallas=False))


def test_dense_rejections():
    gid = np.zeros(16, np.int32)
    f = torch.zeros(16, dtype=torch.float32)
    with pytest.raises(BadArgsError, match="order-dependent"):
        group_aggregate_dense_cols(torch.from_numpy(gid), (f,), ("sum",),
                                   num_groups=8)
    with pytest.raises(BadArgsError, match="order-dependent"):
        group_aggregate_dense_cols(torch.from_numpy(gid), (f,), ("mean",),
                                   num_groups=8)
    with pytest.raises(BadArgsError, match="64-bit"):
        group_aggregate_dense_cols(
            torch.from_numpy(gid), (torch.zeros(16, dtype=torch.int64),),
            ("max",), num_groups=8)
    with pytest.raises(BadArgsError, match="unknown agg"):
        group_aggregate_dense_cols(torch.from_numpy(gid), (f,), ("median",),
                                   num_groups=8)
    with pytest.raises(BadArgsError, match="equal-length"):
        group_aggregate_dense_cols(torch.from_numpy(gid), (), (),
                                   num_groups=8)


def test_dense_agg_plain_table():
    """The kernel's plain version against numpy: counts and wrapping sums,
    signed and flipped min/max, identities in empty groups."""
    rng = np.random.RandomState(11)
    n, g = 5000, 6
    gid = rng.randint(-1, g + 1, n).astype(np.int32)
    x = rng.randint(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    mask = rng.rand(n) < 0.7
    reds = ((None, "count", False), (torch.from_numpy(x), "sum", False),
            (torch.from_numpy(x), "min", False),
            (torch.from_numpy(x), "max", True))
    got = tdense.dense_agg(torch.from_numpy(gid), torch.from_numpy(mask),
                           reds, g + 2).numpy()
    flipped = x ^ np.int32(-2 ** 31)
    for k in range(g + 2):  # id -1 drops; group g + 1 has no row
        m = mask & (gid == k)
        want = np.array([m.sum(), x[m].astype(np.int64).sum(),
                         x[m].min() if m.any() else 2 ** 31 - 1,
                         flipped[m].max() if m.any() else -2 ** 31],
                        np.int64)
        want = (want + 2 ** 31) % 2 ** 32 - 2 ** 31  # mod 2^32, as int32
        np.testing.assert_array_equal(got[:, k], want)
