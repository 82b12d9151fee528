"""The "satradix" sorter of cl_ops_tpu_torch and its rank_hist kernel against
cl_ops_tpu's, which runs its Pallas kernel in interpret mode.

Geometry: the JAX side takes tiles of block_rows=8 (1024 digits) and places
rows with scatter=xla, the port takes block_elems=1024; the placement does
not change the result. Everything is exact: rank and histogram bit for bit,
and, since both sorts are stable, the keys and the values that ride them
bit for bit. JAX's satradix compiles every pass in interpret mode, so the
sorts against it stay at radix 4 and 16; radix 64 is held at the kernel,
and radix 256 against numpy in the port alone.
"""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch.core.dtypes import type_by_name
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError
from cl_ops_tpu_torch.ops import sort as tsort
from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
from cl_ops_tpu_torch.ops.sort import satradix as tsr

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jsort = pytest.importorskip("cl_ops_tpu.ops.sort")
jsr = pytest.importorskip("cl_ops_tpu.ops.sort.satradix")

from test_torch_sort import _rand  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BLOCK = 1024


def _jax_rank_hist(digits, radix):
    """JAX's pass 1-2 as satradix.py runs it: pad with the digit `radix`,
    (rows, 128) tiles of 8 rows."""
    n = digits.size
    n_blocks = max(-(-n // BLOCK), 1)
    d2 = np.full(n_blocks * BLOCK, radix, np.int32)
    d2[:n] = digits
    rank, hist = jsr._rank_and_hist(jnp.asarray(d2.reshape(-1, 128)),
                                    nbins=radix, block_rows=8,
                                    interpret=True)
    return np.asarray(rank).reshape(-1)[:n], np.asarray(hist)[:, :radix]


def _numpy_rank_hist(digits, radix, block):
    rank = np.zeros(digits.size, np.int32)
    hist = np.zeros((-(-digits.size // block), radix), np.int32)
    for i, d in enumerate(digits.tolist()):
        if 0 <= d < radix:
            rank[i] = hist[i // block, d]
            hist[i // block, d] += 1
    return rank, hist


@pytest.mark.parametrize("radix,case", [
    (4, "short last tile"), (16, "short last tile"), (64, "short last tile"),
    (4, "all equal"), (16, "all equal")])
def test_rank_hist_plain_matches_pallas(radix, case):
    if case == "all equal":
        digits = np.full(2 * BLOCK, radix - 1, np.int32)
    else:
        digits = np.random.default_rng(radix).integers(
            0, radix, 2 * BLOCK + 452).astype(np.int32)
    want_rank, want_hist = _jax_rank_hist(digits, radix)
    rank, hist = rk.rank_hist_plain(torch.from_numpy(digits), radix, BLOCK)
    assert rank.dtype == hist.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(hist.numpy(), want_hist)


@pytest.mark.parametrize("radix,block", [(256, 512), (2, 1024), (16, 8192)])
def test_rank_hist_matches_numpy(radix, block):
    """The wrapper on CPU tensors (the plain version), radix 256 included;
    digits outside [0, radix) get rank 0 and no bin."""
    rng = np.random.default_rng(radix + block)
    digits = rng.integers(-3, radix + 3, 3 * block + 77).astype(np.int32)
    rk.reset_launches()
    rank, hist = rk.rank_hist(torch.from_numpy(digits), radix, block)
    want_rank, want_hist = _numpy_rank_hist(digits, radix, block)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    assert rk.launches["rank_hist"] == 0  # CPU tensors take the plain version


def _numpy_limb_digits(limb, shift, radix):
    """The digit at `shift` of the limb's unsigned bits, limb ^ 2^31."""
    u = limb.view(np.uint32) ^ np.uint32(0x80000000)
    return ((u >> np.uint32(shift)) & np.uint32(radix - 1)).astype(np.int32)


@pytest.mark.parametrize("radix", [2, 16, 256])
def test_rank_hist_limb_matches_numpy(radix):
    """The wrapper on CPU tensors (the plain version) at every shift of the
    radix, the limb's last digit with its flipped sign bit included: rank
    and histogram of the limb's digit, and bucket = digit * n_blocks +
    tile."""
    block = 512
    limb = np.random.default_rng(radix).integers(
        -2 ** 31, 2 ** 31, 3 * block + 77).astype(np.int32)
    limb[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    tile = np.arange(limb.size) // block
    rk.reset_launches()
    for shift in tsr.pass_shifts(radix):
        digits = _numpy_limb_digits(limb, shift, radix)
        rank, bucket, hist = rk.rank_hist_limb(torch.from_numpy(limb), shift,
                                               radix, block)
        want_rank, want_hist = _numpy_rank_hist(digits, radix, block)
        np.testing.assert_array_equal(rank.numpy(), want_rank)
        np.testing.assert_array_equal(hist.numpy(), want_hist)
        np.testing.assert_array_equal(bucket.numpy(),
                                      digits * hist.shape[0] + tile)
    assert rk.launches == {"rank_hist": 0, "rank_hist_limb": 0}


@pytest.mark.parametrize("radix", [2, 16])
def test_rank_hist_limb_matches_pallas(radix):
    """At the limb's last digit, where the sign bit flips, the plain
    version's rank and histogram equal JAX's pass 1-2 on the same digits.
    (JAX compiles its kernel for minutes at radix 256, which is held to
    numpy above.)"""
    limb = np.random.default_rng(radix + 1).integers(
        -2 ** 31, 2 ** 31, 2 * BLOCK + 452).astype(np.int32)
    shift = tsr.pass_shifts(radix)[-1]
    rank, _, hist = rk.rank_hist_limb_plain(torch.from_numpy(limb), shift,
                                            radix, BLOCK)
    want_rank, want_hist = _jax_rank_hist(
        _numpy_limb_digits(limb, shift, radix), radix)
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(hist.numpy(), want_hist)


def test_rank_hist_argument_checks():
    d = torch.zeros(1024, dtype=torch.int32)
    for bad in (dict(radix=3), dict(radix=512), dict(block_elems=1000),
                dict(block_elems=1 << 15)):
        kw = dict(radix=16, block_elems=1024) | bad
        with pytest.raises(BadArgsError):
            rk.rank_hist(d, **kw)
        with pytest.raises(BadArgsError):
            rk.rank_hist_limb(d, 0, **kw)
    for shift in (-1, 32):
        with pytest.raises(BadArgsError):
            rk.rank_hist_limb(d, shift, 16)
    with pytest.raises(BadArgsError):
        rk.rank_hist(d.to(torch.int64), 16)
    rank, hist = rk.rank_hist(torch.zeros(0, dtype=torch.int32), 16)
    assert rank.numel() == 0 and tuple(hist.shape) == (0, 16)


@pytest.mark.parametrize("dt,n,radix,kv", [
    ("uint", 3000, 16, False), ("uint", 1, 16, False),
    ("uint", 100, 4, False), ("int", 1024, 16, True),
    ("ulong", 1000, 16, True), ("float", 3000, 16, True)])
def test_satradix_matches_jax(dt, n, radix, kv):
    x = _rand(type_by_name(dt).np_dtype, n, 40 + n)
    if kv:
        x = x[np.random.RandomState(n).randint(0, max(n // 4, 1), n)]  # ties
    j = jsort.sort_new("satradix", f"block_rows=8,scatter=xla,radix={radix}",
                       elem_dtype=dt)
    t = tsort.sort_new("satradix", f"block_elems={BLOCK},radix={radix}",
                       elem_dtype=dt)
    if not kv:
        want, got = j.sort_with_host_data(x), t.sort_with_host_data(
            x, device="cpu")
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(got, np.sort(x))
        return
    vals = np.arange(n, dtype=np.int32)[::-1].copy()
    (wk, wv), (gk, gv) = (j.sort_with_host_data(x, vals),
                          t.sort_with_host_data(x, vals, device="cpu"))
    assert gk.tobytes() == wk.tobytes() and gv.tobytes() == wv.tobytes()
    np.testing.assert_array_equal(gv, vals[np.argsort(x, kind="stable")])


@pytest.mark.parametrize("opts", ["scan=blelloch", "scatter=bitonic",
                                  "scan=lookback,scatter=bitonic,radix=8"])
def test_satradix_options_agree(opts):
    """The composed scan and the placement change nothing in the result."""
    x = _rand(np.uint64, 2500, 3) % 5000
    vals = np.arange(2500, dtype=np.uint32)
    base = tsort.sort_new("satradix", elem_dtype="ulong")
    other = tsort.sort_new("satradix", opts, elem_dtype="ulong")
    want = base.sort_with_host_data(x, vals, device="cpu")
    got = other.sort_with_host_data(x, vals, device="cpu")
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(want[1], np.argsort(x, kind="stable"))


@pytest.mark.parametrize("dt", ["uint", "long", "double", "short"])
def test_satradix_radix_256_matches_numpy(dt):
    x = _rand(type_by_name(dt).np_dtype, 3000, 5)
    s = tsort.sort_new("satradix", "radix=256,block_elems=512",
                       elem_dtype=dt)
    np.testing.assert_array_equal(s.sort_with_host_data(x, device="cpu"),
                                  np.sort(x))
    ties = x[np.random.RandomState(6).randint(0, 40, 3000)]
    _, v = s.sort_with_host_data(ties, np.arange(3000, dtype=np.int64),
                                 device="cpu")
    np.testing.assert_array_equal(v, np.argsort(ties, kind="stable"))


@pytest.mark.parametrize("opts", ["radix=3", "radix=512", "radix=1",
                                  "scatter=dma", "block_elems=1000",
                                  "scan=nope"])
def test_satradix_bad_options(opts):
    with pytest.raises(CloOpsError):
        tsort.sort_new("satradix", opts)


def test_satradix_digits_and_traffic_model():
    limb = torch.tensor([-2 ** 31, -1, 0, 2 ** 31 - 1, 0x12345678],
                        dtype=torch.int32)
    u = limb.numpy().view(np.uint32) ^ np.uint32(0x80000000)
    for radix in (2, 8, 16, 256):
        bits = radix.bit_length() - 1
        for shift in tsr.pass_shifts(radix):
            got = rk.radix_digits(limb, shift, bits).numpy()
            np.testing.assert_array_equal(got, (u >> shift) & (radix - 1))
    # a 32-bit key at radix 16: 8 passes of 44 bytes a row (rank_hist_limb
    # 12, then the gather, the add and the int64 dest) and 16 per column
    assert tsr.satradix_traffic_bytes(1, 1, False, 16) == 8 * (44 + 16)
    assert tsr.satradix_traffic_bytes(10, 2, True, 16) == \
        2 * 10 * 8 * (44 + 3 * 16)
    s = tsort.sort_new("satradix", "radix=256")
    assert not s.in_place
    assert [s.kernel_name(i) for i in range(s.num_kernels)] == [
        "rank_hist", "counters_scan", "scatter"]
    assert s.smem_usage("rank_hist", 1 << 20) == 16 * 256 * 4
    assert s.smem_usage("scatter", 1 << 20) == 0
