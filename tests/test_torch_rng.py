"""The RNG family of cl_ops_tpu_torch against cl_ops_tpu's, bit for bit.

Every generator under every seeding strategy and hash gives the JAX
package's states and draws, with seeds and external states that set the top
bit; the six reference generators also equal the C++ oracle
(`cl_ops_tpu.native`). The rest mirrors `tests/test_rng.py`: draw widths,
validation, introspection and a monobit smoke test.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError
from cl_ops_tpu_torch.ops import rng as rng_mod
from cl_ops_tpu_torch.ops.rng import SeedType, rng_new
from cl_ops_tpu_torch.utils import platform

ALL_GENERATORS = rng_mod.generator_names()
REFERENCE_GENERATORS = ["lcg", "xorshift64", "xorshift128", "mwc64x",
                        "parkmiller", "tauslcg"]
# (seed type, hash, main seed): the last two seeds set the top bit of u64.
SEEDINGS = [("dev_gid", None, 2 ** 64 - 5), ("dev_gid", "knuth", 123),
            ("dev_gid", "xs1", -3), ("host_mt", None, 99),
            ("ext_host", None, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rng():
    pytest.importorskip("jax")
    from cl_ops_tpu.ops import rng as jrng
    return jrng


def _full_range_states(gen, n, seed):
    """States over the whole range of the generator's state type."""
    rs = np.random.default_rng(seed)
    dt = gen.state_dtype
    shape = gen.state_shape(n)
    if dt.kind == "i":
        return rs.integers(-2 ** 31, 2 ** 31, shape).astype(dt)
    states = rs.integers(0, 2 ** (8 * dt.itemsize), shape, dtype=dt)
    states.reshape(-1)[0] = np.iinfo(dt).max  # top bit set
    return states


def _pair(name, seed_type, hash_name, seed, n=64):
    """The JAX package's Rng and the port's (on the CPU), seeded alike."""
    jrng = _jax_rng()
    if seed_type == "ext_host":
        ext = _full_range_states(jrng.get_generator(name), n, seed)
        return (jrng.rng_new(name, seed_type, ext_states=ext),
                rng_new(name, seed_type, ext_states=ext, device="cpu"))
    kw = dict(num_streams=n, main_seed=seed, hash_name=hash_name)
    return (jrng.rng_new(name, seed_type, **kw),
            rng_new(name, seed_type, device="cpu", **kw))


def _states(r):
    return interop.to_numpy(r.states, r._gen.state_dtype)


@pytest.mark.parametrize("seeding", SEEDINGS,
                         ids=[f"{s}-{h}" for s, h, _ in SEEDINGS])
@pytest.mark.parametrize("name", ALL_GENERATORS)
def test_generate_matches_reference(name, seeding):
    j, t = _pair(name, *seeding)
    np.testing.assert_array_equal(_states(t), np.asarray(j.states))
    want = np.asarray(j.generate(64))
    got = interop.to_numpy(t.generate(64))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_states(t), np.asarray(j.states))
    # the single-step path continues the same streams
    np.testing.assert_array_equal(interop.to_numpy(t.next_raw()),
                                  np.asarray(j.next_raw()))


@pytest.mark.parametrize("hash_name", ["knuth", "xs1"])
def test_hash_matches_reference(hash_name):
    jrng = _jax_rng()
    x = np.random.default_rng(3).integers(0, 2 ** 64, 4096, dtype=np.uint64)
    x[:3] = [0, 2 ** 64 - 1, 2 ** 63]
    want = np.asarray(getattr(jrng, hash_name)(x))
    got = getattr(rng_mod, hash_name)(interop.to_torch(x, "cpu"))
    np.testing.assert_array_equal(interop.to_numpy(got, np.uint64), want)


def test_public_names_match_reference():
    jrng = _jax_rng()
    assert rng_mod.__all__ == jrng.__all__
    assert rng_mod.generator_names() == jrng.generator_names()
    for name in ALL_GENERATORS:
        assert (rng_mod.get_generator(name).seed_bytes
                == jrng.get_generator(name).seed_bytes)


@pytest.mark.parametrize("name", REFERENCE_GENERATORS)
def test_matches_native_oracle(name):
    pytest.importorskip("jax")
    from cl_ops_tpu import native
    if not native.available():
        pytest.skip("the C++ oracle does not build here")
    seeds = np.random.default_rng(7).integers(0, 2 ** 64, 97,
                                              dtype=np.uint64)
    seeds[0] = 2 ** 64 - 1
    want = native.rng_stream(name, seeds, 40)
    gen = rng_mod.get_generator(name)
    states = gen.seed_from_u64(interop.to_torch(seeds, "cpu").view(
        torch.int64))
    r = rng_new(name, "ext_dev", ext_states=states)
    np.testing.assert_array_equal(interop.to_numpy(r.generate(40)), want)


# --- mirrors tests/test_rng.py ----------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_vector_widths_stride_streams(width):
    # next_int with width w == GID striding (clo_rng_workitem.cl:24-32):
    # row k of the (w, g) result comes from state stripe k.
    r = rng_new("threefry", num_streams=32, main_seed=3, device="cpu")
    flat_r = rng_new("threefry", num_streams=32, main_seed=3, device="cpu")
    v = interop.to_numpy(r.next_int(1 << 30, width=width))
    flat = interop.to_numpy(flat_r.next_int(1 << 30))
    want_shape = (32,) if width == 1 else (width, 32 // width)
    assert v.shape == want_shape
    np.testing.assert_array_equal(v, flat.reshape(want_shape))
    assert (flat < 1 << 30).all()


def test_width_validation():
    r = rng_new("lcg", num_streams=10, main_seed=1, device="cpu")
    with pytest.raises(BadArgsError):
        r.next_int(10, width=3)
    with pytest.raises(BadArgsError):
        r.next_int(10, width=4)  # 10 % 4 != 0


def test_ext_shape_validated():
    with pytest.raises(BadArgsError):
        rng_new("xorshift128", SeedType.EXT_HOST, num_streams=8,
                ext_states=np.zeros((8, 3), np.uint32), device="cpu")
    with pytest.raises(BadArgsError):
        rng_new("lcg", SeedType.EXT_DEV, num_streams=8,
                ext_states=torch.zeros(4, dtype=torch.int64))


def test_bad_args():
    with pytest.raises(BadArgsError):
        rng_new("lcg", SeedType.DEV_GID, num_streams=0, device="cpu")
    with pytest.raises(BadArgsError):
        rng_new("lcg", SeedType.EXT_DEV, num_streams=4, device="cpu")
    with pytest.raises(BadArgsError):
        rng_new("lcg", num_streams=4, hash_name="md5", device="cpu")
    with pytest.raises(CloOpsError):
        rng_new("nope", num_streams=4, device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(platform, "has_cuda", lambda: False)
    with pytest.raises(CloOpsError):
        rng_new("threefry", num_streams=4)


@pytest.mark.parametrize("name", ALL_GENERATORS)
def test_ext_dev_keeps_tensor_and_ext_host_copies(name):
    donor = rng_new(name, num_streams=16, main_seed=5, device="cpu")
    ext = donor.get_device_seeds()
    dev_r = rng_new(name, SeedType.EXT_DEV, ext_states=ext)
    assert dev_r.states is ext
    host_r = rng_new(name, SeedType.EXT_HOST, num_streams=16,
                     ext_states=ext, device="cpu")
    assert host_r.states.data_ptr() != ext.data_ptr()
    assert torch.equal(host_r.states, ext)
    np.testing.assert_array_equal(interop.to_numpy(dev_r.next_raw()),
                                  interop.to_numpy(host_r.next_raw()))


@pytest.mark.parametrize("name", ALL_GENERATORS)
def test_introspection(name):
    r = rng_new(name, num_streams=8, main_seed=0, device="cpu")
    assert r.name == name
    assert r.num_streams == 8
    assert r.seed_bytes in (4, 8, 16)  # parity: clo_rng seed sizes
    states = r.get_device_seeds()
    assert tuple(states.shape) == r._gen.state_shape(8)
    _, want = r.get_source()(states)
    np.testing.assert_array_equal(interop.to_numpy(r.next_raw()),
                                  interop.to_numpy(want.view(torch.uint32)))


@pytest.mark.parametrize("name", ALL_GENERATORS)
def test_mean_of_uniform_bits(name):
    """Cheap sanity (full quality testing is outsourced, like the
    reference)."""
    r = rng_new(name, num_streams=256, main_seed=11, hash_name="xs1",
                device="cpu")
    vals = interop.to_numpy(r.generate(64)).astype(np.float64) / 2 ** 32
    assert 0.45 < vals.mean() < 0.55, f"{name} mean {vals.mean()}"
