"""Key limbs of cl_ops_tpu_torch bit-identical to cl_ops_tpu.ops.sort.keys."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.dtypes import canonicalize, type_by_name
from cl_ops_tpu_torch.ops.sort import keys as tkeys

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jkeys = pytest.importorskip("cl_ops_tpu.ops.sort.keys")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INT_TYPES = ["char", "uchar", "short", "ushort", "int", "uint", "long",
             "ulong"]
FLOAT_TYPES = ["half", "float", "double"]


def _values(name):
    d = type_by_name(name).np_dtype  # None for bfloat16
    rng = np.random.default_rng(11)
    if d is not None and d.kind in "iu":
        info = np.iinfo(d)
        mid = rng.integers(info.min, info.max, 200, dtype=d, endpoint=True)
        return np.concatenate([np.array([info.min, info.max, 0, 1, info.min,
                                         info.max], d), mid])
    size = 2 if d is None else d.itemsize
    raw = rng.integers(0, 2 ** (8 * size), 200, dtype=np.uint64).astype(
        f"u{size}")
    if d is None:  # bfloat16 bit patterns: ±0, ±inf, NaN, ±1, randoms
        special = np.array([0, 0x8000, 0x7F80, 0xFF80, 0x7FC0, 0xFFC0,
                            0x3F80, 0xBF80], np.uint16)
        return np.concatenate([special, raw])
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0,
                        -1.0, np.finfo(d).max, np.finfo(d).min,
                        np.finfo(d).tiny], d)
    return np.concatenate([special, raw.view(d)])


def _jax_keys(name, vals):
    # the JAX keys module rejects bfloat16 (its dtype kind is "V"); its own
    # rule for 2-byte floats is to widen to float32 first, so bfloat16 is
    # held against the float32 limbs of the widened values
    if name == "bfloat16":
        return jax.lax.bitcast_convert_type(
            jnp.asarray(vals), jnp.bfloat16).astype(jnp.float32)
    return jnp.asarray(vals)


def _torch_keys(name, vals):
    return interop.to_torch(vals, "cpu",
                            dtype="bfloat16" if name == "bfloat16" else None)


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES + ["bfloat16"])
def test_to_limbs_matches_reference(name):
    vals = _values(name)
    want = jkeys.to_limbs(_jax_keys(name, vals))
    got = tkeys.to_limbs(_torch_keys(name, vals))
    assert len(got) == len(want) == tkeys.num_limbs(name)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES + ["bfloat16"])
def test_from_limbs_matches_reference(name):
    vals = _values(name)
    limbs_np = [np.asarray(l) for l in jkeys.to_limbs(_jax_keys(name, vals))]
    dt = "bfloat16" if name == "bfloat16" else canonicalize(name)
    jdt = jnp.float32 if name == "bfloat16" else vals.dtype
    want = jkeys.from_limbs([jnp.asarray(l) for l in limbs_np], jdt)
    if name == "bfloat16":
        want = jax.lax.bitcast_convert_type(want.astype(jnp.bfloat16),
                                            jnp.uint16)
    want = np.asarray(want)
    got = interop.to_numpy(tkeys.from_limbs(
        [torch.from_numpy(l.copy()) for l in limbs_np], dt))
    if name == "bfloat16":
        # JAX's float32 -> bfloat16 rounding rewrites NaN payloads; the port
        # returns the original bits, which equal JAX's everywhere else
        same = want == vals
        widened = (vals[~same].astype(np.uint32) << 16).view(np.float32)
        assert (~same).sum() == 3 and np.isnan(widened).all()
        np.testing.assert_array_equal(got, vals)
        np.testing.assert_array_equal(got[same], want[same])
        return
    assert got.tobytes() == want.tobytes()
    if name in INT_TYPES:
        assert got.tobytes() == vals.tobytes()


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES)
def test_limb_order_is_key_order(name):
    vals = _values(name)
    if name in FLOAT_TYPES:
        vals = vals[~np.isnan(vals)]
    limbs = [l.numpy().astype(np.int64) for l in
             tkeys.to_limbs(_torch_keys(name, vals))]
    order = np.lexsort(limbs[::-1])
    s = vals[order]
    assert np.all(s[1:] >= s[:-1])


def test_sentinel_and_bad_dtype():
    assert tkeys.sentinel_max_limbs(2) == jkeys.sentinel_max_limbs(2)
    with pytest.raises(KeyError):
        tkeys.to_limbs(torch.zeros(3, dtype=torch.bool))
