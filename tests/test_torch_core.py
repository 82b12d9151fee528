"""cl_ops_tpu_torch core against cl_ops_tpu core: dtype table, canonicalize,
option parsing, registry errors, and bit-exact numpy <-> torch hand-over."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core import dtypes as tdt
from cl_ops_tpu_torch.core import registry as treg
from cl_ops_tpu_torch.core.errors import CloOpsError, ErrorCode
from cl_ops_tpu_torch.utils import bits as tbits
from cl_ops_tpu_torch.utils import platform

jdt = pytest.importorskip("cl_ops_tpu.core.dtypes")
jreg = pytest.importorskip("cl_ops_tpu.core.registry")
jbits = pytest.importorskip("cl_ops_tpu.utils.bits")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = jdt.all_type_names()


def test_type_table_matches_reference():
    assert tdt.all_type_names() == NAMES
    for name in NAMES + ["bfloat16"]:
        j, t = jdt.type_by_name(name), tdt.type_by_name(name)
        assert (t.name, t.size, t.is_integer, t.is_signed) == (
            j.name, j.size, j.is_integer, j.is_signed)
        if name != "bfloat16":
            assert t.np_dtype == j.dtype
    assert tdt.type_by_name("bfloat16").np_dtype is None


@pytest.mark.parametrize("name", NAMES + ["bfloat16"])
def test_canonicalize_forms(name):
    t = tdt.type_by_name(name)
    assert tdt.canonicalize(name) == t.dtype
    assert tdt.canonicalize(t.dtype) == t.dtype
    if t.np_dtype is not None:
        assert tdt.canonicalize(t.np_dtype) == t.dtype
        assert tdt.canonicalize(t.np_dtype.type) == t.dtype
    assert tdt.type_name(t.dtype) == name
    assert tdt.type_sizeof(name) == t.size
    assert tdt.signed_equivalent(name).itemsize == t.size


def test_unsigned_equivalent():
    assert tdt.unsigned_equivalent("int") == torch.uint32
    assert tdt.unsigned_equivalent("double") == torch.uint64


@pytest.mark.parametrize("name", NAMES + ["bfloat16"])
def test_unsigned_equivalent_matches_reference(name):
    """The same width as the JAX function's numpy dtype, for every type."""
    u = tdt.unsigned_equivalent(name)
    assert u == tdt.canonicalize(jdt.unsigned_equivalent(name))
    assert not u.is_signed and u.itemsize == tdt.type_sizeof(name)


def test_canonicalize_rejects_unknown():
    with pytest.raises(KeyError):
        tdt.canonicalize(torch.complex64)
    with pytest.raises(KeyError):
        tdt.type_by_name("quad")


@pytest.mark.parametrize("opts", [
    None, "", "radix=16,scan=blelloch", " a = 1 , flag ,b=x=y",
    {"block_elems": 1024, "x": "y"}])
def test_parse_options_matches_reference(opts):
    assert treg.parse_options(opts) == jreg.parse_options(opts)


def test_registry_errors():
    r = treg.Registry("thing")
    r.register("a")(lambda: 1)
    assert "a" in r and r.names() == ["a"] and r.get("a")() == 1
    with pytest.raises(CloOpsError) as e:
        r.register("a")(lambda: 2)
    assert e.value.code == ErrorCode.IMPL_DUPLICATE
    with pytest.raises(CloOpsError) as e:
        r.get("b")
    assert e.value.code == ErrorCode.IMPL_NOT_FOUND


def _extremes(np_dtype):
    d = np.dtype(np_dtype)
    rng = np.random.default_rng(5)
    if d.kind in "iu":
        info = np.iinfo(d)
        mid = rng.integers(info.min, info.max, 64, dtype=d, endpoint=True)
        return np.concatenate([np.array([info.min, info.max, 0, 1], d), mid])
    bits = rng.integers(0, 2 ** (8 * d.itemsize), 64, dtype=np.uint64)
    raw = bits.astype(f"u{d.itemsize}").view(d)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5], d)
    return np.concatenate([special, raw])


@pytest.mark.parametrize("name", NAMES)
def test_interop_round_trip(name):
    a = _extremes(jdt.type_by_name(name).dtype)
    t = interop.to_torch(a, "cpu")
    assert t.dtype == tdt.canonicalize(name)
    back = interop.to_numpy(t)
    assert back.dtype == a.dtype
    assert back.tobytes() == a.tobytes()


def test_interop_bfloat16_bits():
    import jax
    import jax.numpy as jnp
    bits = np.array([0, 0x8000, 0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x7FC0,
                     0x0001, 0x7F7F], np.uint16)
    t = interop.to_torch(bits, "cpu", dtype="bfloat16")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_numpy(t), bits)
    # values agree with JAX's bfloat16 of the same bits
    j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(j.astype(jnp.float32)).view(np.uint32),
        t.to(torch.float32).view(torch.int32).numpy().view(np.uint32))


def test_interop_reinterpret_and_widen():
    a = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    t = interop.to_torch(a, "cpu", dtype=torch.int32)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(interop.to_numpy(t, np.uint32), a)
    np.testing.assert_array_equal(
        interop.widen_u32(interop.to_torch(a, "cpu")).numpy(),
        a.astype(np.int64))


BITS_ARGS = [1, 2, 3, 5, 8, 1000, 1023, 1024, 2 ** 31 - 1, 2 ** 31,
             2 ** 32 - 1, 2 ** 40 + 3]


@pytest.mark.parametrize("fn", ["nlpo2", "ones32", "tzc", "log2_floor",
                                "sum_1_to_n", "is_po2"])
def test_bits_match_reference(fn):
    xs = BITS_ARGS + ([] if fn == "log2_floor" else [0])
    for x in xs:
        assert getattr(tbits, fn)(x) == getattr(jbits, fn)(x), x


@pytest.mark.parametrize("fn", ["cdiv", "round_up"])
def test_bits_pairs_match_reference(fn):
    for a in BITS_ARGS + [0]:
        for b in (1, 3, 128, 1024):
            assert getattr(tbits, fn)(a, b) == getattr(jbits, fn)(a, b)


def test_platform_device_and_build_dir(monkeypatch, tmp_path):
    assert platform.default_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("CL_OPS_TORCH_BUILD_DIR", str(tmp_path))
    assert platform.build_dir() == tmp_path
    monkeypatch.delenv("CL_OPS_TORCH_BUILD_DIR")
    d = platform.build_dir()
    assert d.name == "_build" and d.parent.name == "cl_ops_tpu_torch"
    if not platform.has_cuda():
        with pytest.raises(CloOpsError) as e:
            platform.default_device(None)
        assert e.value.code == ErrorCode.DEVICE_NOT_FOUND


def test_package_exports_deferred_witnesses():
    """The top-level package re-exports the deferred-form witnesses, as the
    JAX package does."""
    import cl_ops_tpu as jpkg

    import cl_ops_tpu_torch as tpkg
    from cl_ops_tpu_torch import DeferredOverflowError, verify_deferred
    from cl_ops_tpu_torch import defer
    assert DeferredOverflowError is defer.DeferredOverflowError
    assert verify_deferred is defer.verify_deferred
    for name in ("DeferredOverflowError", "verify_deferred"):
        assert name in jpkg.__all__ and name in tpkg.__all__
    assert issubclass(DeferredOverflowError, CloOpsError)


def _witness_cases():
    """(witnesses, op_name) of tests/test_core.py's TestVerifyDeferred, as
    numpy values both packages take."""
    dropped = np.zeros(8, np.int32)
    dropped[3] = 17
    return [
        ((np.zeros(4, np.int32),), "deferred op"),
        ((np.zeros((), np.bool_),), "rollup"),
        (((np.zeros(8, np.int32), np.zeros(8, np.int32)),), "deferred op"),
        (((np.zeros(8, np.int32), dropped),), "dist_hash_join"),
        ((np.asarray(True),), "rollup_query"),
        ((np.ones(2, np.int32),), "deferred op"),
        ((), "deferred op"),
    ]


@pytest.mark.parametrize("case", range(len(_witness_cases())))
def test_verify_deferred_matches_reference(case):
    """verify_deferred passes, or raises the same error naming the same
    witness and count, as the JAX package's (the advice after the dash
    differs: the port has no distributed join to re-plan); torch tensors
    of the same witnesses behave as the numpy ones."""
    import cl_ops_tpu as jpkg

    from cl_ops_tpu_torch import DeferredOverflowError, verify_deferred
    witnesses, op_name = _witness_cases()[case]

    def outcome(fn, ws):
        try:
            fn(*ws, op_name=op_name)
        except Exception as e:  # noqa: BLE001 - each package's own types
            return type(e).__name__, str(e).split(" — ")[0]
        return None

    def as_torch(w):
        if isinstance(w, tuple):
            return tuple(as_torch(x) for x in w)
        return torch.from_numpy(np.array(w))

    want = outcome(jpkg.verify_deferred, witnesses)
    assert outcome(verify_deferred, witnesses) == want
    assert outcome(verify_deferred, as_torch(witnesses)) == want
    if want is not None and want[0] != "ValueError":
        with pytest.raises(DeferredOverflowError):
            verify_deferred(*witnesses, op_name=op_name)
