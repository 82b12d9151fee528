"""The CUDA kernels against their plain versions, on the card.

Small and odd geometries that chip_smoke.py does not reach: up to MAX_COLS
columns, key prefixes shorter than the row, tied prefixes, single-block
arrays and the k = 0 merge; multi_stage, block_sort and block_merge at
every tile that the wrappers admit, at every column count's largest tile
with full and tied key prefixes, at tiles of 1 to 1024 rows, on columns at
an unaligned offset and back to back; scans of odd lengths, all ops and
dtypes, with dense and nearly absent segment flags; the band probe with 1-2
limbs, 1-3 value columns, empty and ragged build sides and several window
starts, and its edge cases (windows at the build's start and clamped at
its end, probes below every window row, equal high limbs, ragged probe
blocks, runs of equal probes across chunk edges, an unsorted chunk among
sorted ones); seg_scan_carry around its tile, unaligned, with no, every and
tile-start flags, and back to back; the
block scans at lengths 0, 1 and ragged tails; rank_hist with short tiles,
radix 4-256 and digits outside the bins; rank_hist_limb at every shift of
radix 4-256 and tiles of 512-16384 rows, and satradix's one launch of it
a pass; pair_cross at distances 1-32;
whole_sort up to its capacity and past it; the five sorters against numpy,
and autotune with its cache in a temporary file; dense_agg at 1 to 1024
groups with masks, u32 flips, float32 limbs and more reductions than one
launch takes, with 64, 23 and one copy of the table a block, operands
that start one element into their tensors, fewer rows than a vector, and
one column feeding count, sum, min and max;
chunk_copy with 1, 3 and 9 arrays, a partial last chunk and
whole-sentinel slots; the dense GROUP BY, window functions, top-k and
DISTINCT on the card against their CPU results. Every CUDA call checks that
the kernel's launch counter moved, so no CUDA tensor reaches a plain
version. Skips without CUDA. On a machine without JAX
run it with `python -m pytest --noconftest tests/test_torch_cuda.py`.
"""

import json

import numpy as np
import pytest
import torch
import torch_band_cases as band_cases

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.exec import bandprobe as bp
from cl_ops_tpu_torch.ops.exec import dense_agg as da
from cl_ops_tpu_torch.ops.exec import filter_compact, group_aggregate_cols
from cl_ops_tpu_torch.ops.scan import kernels as sk
from cl_ops_tpu_torch.ops.scan import scan_1d
from cl_ops_tpu_torch.ops.scan import segmented as seg
from cl_ops_tpu_torch.ops.sort import autotune
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
from cl_ops_tpu_torch.ops.sort import sort_new

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cols(n, n_cols, seed, hi=2 ** 31):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-hi, hi, n).astype(np.int32))
            for _ in range(n_cols)]


def _run_both(cols, fn_kernel, fn_plain, dev):
    a = [c.to(dev) for c in cols]
    b = [c.clone() for c in cols]
    fn_kernel(a)
    fn_plain(b)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("n_cols,num_keys,hi", [
    (1, 1, 2 ** 31), (3, 1, 4), (3, 2, 2 ** 31), (8, 3, 2), (8, 8, 2 ** 31)])
def test_sort_kernels_match_plain(cuda, n_cols, num_keys, hi):
    n = 1 << 14
    cols = _cols(n, n_cols, 7, hi)
    geoms = [(256, 1024), (1024, 4096), (1, 1024)]  # 1: a no-op block_sort
    if n_cols <= 3:
        geoms.append((1 << 14, 1 << 14))  # one block: block_sort alone
    for b, m in geoms:
        _run_both(cols,
                  lambda c: bk.bitonic_sort_2d(c, block_elems=b,
                                               merge_elems=m,
                                               num_keys=num_keys),
                  lambda c: bk.bitonic_sort_2d(c, block_elems=b,
                                               merge_elems=m,
                                               num_keys=num_keys), cuda)


def test_each_kernel_matches_plain(cuda):
    cols = _cols(1 << 13, 3, 3, 8)
    cases = [
        (lambda c: bk.block_sort_(c, 512, 2),
         lambda c: bk.block_sort_plain(c, 512, 2)),
        (lambda c: bk.multi_stage_(c, 256, 2048, 2),
         lambda c: bk.multi_stage_plain(c, 256, 2048, 2)),
        (lambda c: bk.pair_cross_(c, 4096, 1024, 2),
         lambda c: bk.pair_cross_plain(c, 4096, 1024, 2)),
        (lambda c: bk.pair_cross_(c, 0, 2048, 2),
         lambda c: bk.pair_cross_plain(c, 0, 2048, 2)),
        (lambda c: bk.block_merge_(c, 1024, 0, 2),
         lambda c: bk.block_merge_plain(c, 1024, 0, 2)),
        (lambda c: bk.block_merge_(c, 1024, 4096, 2),
         lambda c: bk.block_merge_plain(c, 1024, 4096, 2)),
    ]
    for kern, plain in cases:
        _run_both(cols, kern, plain, cuda)


def _default_merge(n_cols):
    """The largest merge block whose columns fit one block's shared
    memory (bitonic.pick_merge_elems)."""
    return max(length for c, length in bk.block_tiles() if c == n_cols)


def _block_pair(cols, length, k, num_keys, dev, reps=1):
    """multi_stage_ (stages 2B .. length at B = length / 4, or from stage 2
    at the smallest tiles), block_sort_ and block_merge_ (stage k) on
    `length`-row tiles, `reps` times back to back on one stream, against
    their plain versions; checks the three counters."""
    a = [c.to(dev) for c in cols]
    b = [c.clone() for c in cols]
    sort_block = max(length // 4, 1)
    bk.reset_launches()
    for _ in range(reps):
        bk.multi_stage_(a, sort_block, length, num_keys)
        bk.block_sort_(a, length, num_keys)
        bk.block_merge_(a, length, k, num_keys)
        bk.multi_stage_plain(b, sort_block, length, num_keys)
        bk.block_sort_plain(b, length, num_keys)
        bk.block_merge_plain(b, length, k, num_keys)
    torch.cuda.synchronize()
    assert bk.launches["multi_stage"] == reps
    assert bk.launches["block_sort"] == reps
    assert bk.launches["block_merge"] == reps
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("n_cols", range(1, bk.MAX_COLS + 1))
@pytest.mark.parametrize("keys", ["all", "prefix, tied"])
def test_block_kernels_at_default_merge_block(cuda, n_cols, keys):
    """Each column count at its largest tile (7 x 8192 rows included), four
    tiles, with every column a key or a shorter key prefix in 2-4 values;
    block_merge at stages k = 0, the tile (directions by tile parity) and
    beyond it."""
    m = _default_merge(n_cols)
    if keys == "all":
        num_keys, hi = n_cols, 2 ** 31
    else:
        num_keys, hi = max(n_cols - 1, 1), 2 + n_cols % 3
    cols = _cols(4 * m, n_cols, 10 + n_cols, hi)
    for k in (0, m, 2 * m):
        _block_pair(cols, m, k, num_keys, cuda)


@pytest.mark.parametrize("n_cols", range(1, bk.MAX_COLS + 1))
def test_block_kernels_at_every_admitted_tile(cuda, n_cols):
    """Every tile that _check admits at n_cols columns (R = 1 tiles, full
    rows, the 7-column unpadded tiles), two tiles a call, a key prefix with
    ties: multi_stage at its merge tile, block_sort and block_merge."""
    num_keys = max(n_cols - 1, 1)
    for c, length in bk.block_tiles():
        if c == n_cols:
            cols = _cols(2 * length, n_cols, length + n_cols, 3)
            _block_pair(cols, length, 2 * length, num_keys, cuda)


@pytest.mark.parametrize("length", [1, 2, 32, 64, 256, 512, 1024])
@pytest.mark.parametrize("n_cols,num_keys,hi", [(1, 1, 2 ** 31), (3, 2, 3),
                                                (8, 3, 2)])
def test_block_kernels_small_tiles(cuda, length, n_cols, num_keys, hi):
    """Tiles of 1 to 1024 rows: one row a thread under 32 full threads,
    then the full rows in one warp and more."""
    cols = _cols(4096, n_cols, length, hi)
    for k in (0, 2 * length):
        _block_pair(cols, length, k, num_keys, cuda)


@pytest.mark.parametrize("n_cols,num_keys", [(1, 1), (3, 2)])
def test_block_kernels_on_unaligned_columns(cuda, n_cols, num_keys):
    """Columns that start 4 bytes past a 16-byte boundary: slices [1:] of
    longer buffers."""
    m = _default_merge(n_cols)
    cols = _cols(2 * m, n_cols, 5, 3)
    bufs = [torch.zeros(2 * m + 1, dtype=torch.int32, device=cuda)
            for _ in cols]
    a = []
    for buf, c in zip(bufs, cols):
        buf[1:] = c.to(cuda)
        a.append(buf[1:])
    assert all(x.data_ptr() % 16 == 4 for x in a)
    b = [c.clone() for c in cols]
    bk.reset_launches()
    bk.multi_stage_(a, m // 4, m, num_keys)
    bk.block_sort_(a, m, num_keys)
    bk.block_merge_(a, m, 0, num_keys)
    bk.multi_stage_plain(b, m // 4, m, num_keys)
    bk.block_sort_plain(b, m, num_keys)
    bk.block_merge_plain(b, m, 0, num_keys)
    torch.cuda.synchronize()
    assert bk.launches["block_sort"] == bk.launches["block_merge"] == 1
    assert bk.launches["multi_stage"] == 1
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y)
    for buf in bufs:
        assert int(buf[0]) == 0


@pytest.mark.parametrize("n_cols,num_keys,hi", [(1, 1, 2 ** 31), (3, 2, 4)])
def test_block_kernels_back_to_back(cuda, n_cols, num_keys, hi):
    """Five rounds of block_sort and block_merge queued on one stream with
    no synchronisation between them."""
    m = _default_merge(n_cols)
    _block_pair(_cols(4 * m, n_cols, 21, hi), m, 2 * m, num_keys, cuda,
                reps=5)


def test_launch_counts_and_sorter(cuda):
    x = np.random.default_rng(1).integers(0, 2 ** 32, 100_000,
                                          dtype=np.uint32)
    bk.reset_launches()
    s = sort_new("abitonic", "block_elems=1024,merge_elems=4096")
    out = s.sort_with_host_data(x)
    np.testing.assert_array_equal(out, np.sort(x))
    assert all(bk.launches[k] > 0 for k in bk.FUSED)


def test_filter_on_card(cuda):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2 ** 32, 70_000, dtype=np.uint32)
    p = rng.integers(-2 ** 63, 2 ** 63, 70_000, dtype=np.int64)
    c, fx, fp = filter_compact(interop.to_torch(x, cuda),
                               lambda v: interop.widen_u32(v) < 2 ** 30,
                               interop.to_torch(p, cuda))
    m = x < 2 ** 30
    c = int(c)
    assert c == int(m.sum())
    np.testing.assert_array_equal(interop.to_numpy(fx)[:c], x[m])
    np.testing.assert_array_equal(interop.to_numpy(fp)[:c], p[m])


# --- the scan kernels (csrc/scan.cu) ------------------------------------------

SCAN_LENGTHS = [1, 1025, (1 << 20) + 3]


def _f32_add_tolerance(x, flags):
    """Allowed |kernel - plain| for a float32 segmented sum: the two sum in
    different orders, so each may be off by a few hundred ulps of the
    running sum of |x| in the segment; 1e-5 (about 84 ulps) of it, plus
    1e-6 for sums near zero."""
    return 1e-5 * seg.seg_scan_carry_plain(x.abs(), flags, "add", False) \
        + 1e-6


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_carry_matches_plain(cuda, n, dtype, exclusive):
    rng = np.random.default_rng(n)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    x = torch.from_numpy(rng.integers(info.min, info.max, n, endpoint=True,
                                      dtype=info.dtype))
    sk.reset_launches()
    got = sk.scan_carry(x.to(cuda), exclusive)
    torch.cuda.synchronize()
    name = "scan_carry" if dtype == torch.int32 else "scan_carry_wide"
    assert sk.launches[name] == 1
    assert torch.equal(got.cpu(), sk.scan_carry_plain(x, exclusive))


def _carry_input(n, dtype, seed, offset=0):
    """n full-range integers of dtype on the card, starting `offset`
    elements into their buffer (offset 1: not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    x = torch.from_numpy(rng.integers(info.min, info.max, n + offset,
                                      endpoint=True, dtype=info.dtype))
    return x[offset:], x.to("cuda")[offset:]


CARRY_CASES = {  # (length in tiles, extra elements, offset)
    "one tile": (1, 0, 0), "tile - 1": (1, -1, 0), "tile + 1": (1, 1, 0),
    "two tiles, ragged warp": (2, 32 * 33 + 5, 0),
    "long chain": (None, (1 << 24) + 5, 0), "unaligned": (2, 3, 1)}


@pytest.mark.parametrize("case", list(CARRY_CASES))
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_carry_around_its_tile(cuda, case, dtype, exclusive):
    """The 64 KB-tile scan_carry at one tile, on both sides of it, with a
    warp that runs past n, over a look-back chain of 1024-2048 tiles, and
    from a buffer that is not 16-byte aligned (element-wise loads)."""
    tiles, extra, offset = CARRY_CASES[case]
    tile = sk.CARRY_TILE[torch.tensor([], dtype=dtype).element_size()]
    n = (tiles or 0) * tile + extra
    x, dx = _carry_input(n, dtype, n + offset, offset)
    sk.reset_launches()
    got = sk.scan_carry(dx, exclusive)
    torch.cuda.synchronize()
    name = "scan_carry" if dtype == torch.int32 else "scan_carry_wide"
    assert sk.launches[name] == 1
    assert torch.equal(got.cpu(), sk.scan_carry_plain(x, exclusive))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_scan_carry_back_to_back(cuda, dtype):
    """Calls queued on one stream without a synchronize between them: each
    has its own zeroed status, so none sees another's tiles."""
    xs = [_carry_input(n, dtype, n) for n in ((1 << 22) + 7, 1 << 20)]
    sk.reset_launches()
    got = [sk.scan_carry(d, ex) for _, d in xs for ex in (False, True)]
    torch.cuda.synchronize()
    name = "scan_carry" if dtype == torch.int32 else "scan_carry_wide"
    assert sk.launches[name] == 4
    want = [sk.scan_carry_plain(h, ex) for h, _ in xs for ex in (False, True)]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


SEG_T = sk.SEG_TILE
SEG_CASES = {  # (length, segment flags: a density, "all" or "tile starts",
    #             elements the views start into their buffers)
    **{f"n={n} density={d:g}": (n, d, 0)
       for n in SCAN_LENGTHS for d in (1 / 256, 1e-6)},
    "tile - 1": (SEG_T - 1, 1 / 256, 0), "tile": (SEG_T, 1 / 256, 0),
    "tile + 1": (SEG_T + 1, 1 / 256, 0),
    "five tiles + 3": (5 * SEG_T + 3, 1 / 256, 0),
    "unaligned": (3 * SEG_T + 5, 1 / 256, 1),
    "no flags, long chain": ((1 << 22) + 5, 0.0, 0),
    "every row flagged": ((1 << 20) + 3, "all", 0),
    "flags at tile starts": (64 * SEG_T + 7, "tile starts", 0)}


def _seg_input(n, dtype, op, flags, offset, seed):
    """Values and segment flags for seg_scan_carry on the host, `offset`
    elements into buffers of n + offset (float32 min/max with NaNs and
    negative zeros)."""
    rng = np.random.default_rng(seed)
    m = n + offset
    if dtype == torch.int32:
        x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, m,
                                          dtype=np.int32))
    else:
        xs = rng.uniform(-1, 1, m).astype(np.float32)
        if op != "add":
            xs[rng.random(m) < 1e-3] = np.nan
            xs[rng.random(m) < 1e-3] = -0.0
        x = torch.from_numpy(xs)
    if flags == "all":
        f = np.ones(m, np.int32)
    elif flags == "tile starts":
        f = (np.arange(m) % SEG_T == offset).astype(np.int32)
    else:
        f = (rng.random(m) < flags).astype(np.int32)
    return x, torch.from_numpy(f)


def _check_seg(got, x, flags, op, exclusive):
    """got against seg_scan_carry_plain: bit for bit (NaN by isnan, +0 ==
    -0), float32 add within _f32_add_tolerance."""
    want = seg.seg_scan_carry_plain(x, flags, op, exclusive)
    if x.dtype == torch.float32 and op == "add":
        assert bool(((got - want).abs()
                     <= _f32_add_tolerance(x, flags)).all())
    else:
        assert torch.equal(got.isnan(), want.isnan())
        ok = got.isnan()
        assert torch.equal(got[~ok], want[~ok])  # +0 == -0


@pytest.mark.parametrize("case", list(SEG_CASES))
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_seg_scan_carry_matches_plain(cuda, case, dtype, op):
    """seg_scan_carry at lengths around its tile, from buffers that are
    not 16-byte aligned, with no flags (the look-back walks the whole
    chain), every row flagged and flags only at tile starts."""
    n, density, offset = SEG_CASES[case]
    xb, fb = _seg_input(n, dtype, op, density, offset, n + 1)
    x, flags = xb[offset:], fb[offset:]
    dx, dflags = xb.to(cuda)[offset:], fb.to(cuda)[offset:]
    for exclusive in ([False, True] if op == "add" else [False]):
        seg.reset_launches()
        got = seg.seg_scan_carry(dx, dflags, op, exclusive).cpu()
        torch.cuda.synchronize()
        assert seg.launches["seg_scan_carry"] == 1
        _check_seg(got, x, flags, op, exclusive)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_seg_scan_carry_back_to_back(cuda, dtype):
    """Calls queued on one stream without a synchronize between them, at
    two lengths, with and without flags, and a scan_carry among them: the
    status buffer they share must be clear at each call's start."""
    calls = []
    for n in ((1 << 22) + 7, 3 * SEG_T + 1):
        for density in (1 / 256, 0.0):
            calls += [(*_seg_input(n, dtype, op, density, 0, n), op,
                       op == "add") for op in ("add", "max")]
    seg.reset_launches()
    sk.reset_launches()
    got = []
    for x, f, op, exclusive in calls:
        got.append(seg.seg_scan_carry(x.to(cuda), f.to(cuda), op,
                                      exclusive))
        if len(got) == 4:
            ci, dci = _carry_input((1 << 21) + 3, torch.int32, 9)
            carried = sk.scan_carry(dci)
    torch.cuda.synchronize()
    assert seg.launches["seg_scan_carry"] == len(calls)
    assert sk.launches["scan_carry"] == 1
    assert torch.equal(carried.cpu(), sk.scan_carry_plain(ci, False))
    for g, (x, f, op, exclusive) in zip(got, calls):
        _check_seg(g.cpu(), x, f, op, exclusive)


def test_group_aggregate_cols_on_card(cuda):
    rng = np.random.default_rng(5)
    n, g = 300_000, 4096
    keys = rng.integers(0, g, n).astype(np.int32)
    v64 = rng.integers(-2 ** 63, 2 ** 63, n, dtype=np.int64)
    v32 = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int32)
    gk, (s, c, mn), cnt = group_aggregate_cols(
        interop.to_torch(keys, cuda),
        (interop.to_torch(v64, cuda), interop.to_torch(v64, cuda),
         interop.to_torch(v32, cuda)), ("sum", "count", "min"),
        num_groups=g)
    uniq = np.unique(keys)
    want_s = np.zeros(g, np.int64)
    np.add.at(want_s, keys, v64)  # wraps mod 2^64
    want_min = np.full(g, 2 ** 31 - 1, np.int32)
    np.minimum.at(want_min, keys, v32)
    assert int(cnt) == len(uniq)
    np.testing.assert_array_equal(interop.to_numpy(gk)[:len(uniq)], uniq)
    np.testing.assert_array_equal(interop.to_numpy(s)[:len(uniq)],
                                  want_s[uniq])
    np.testing.assert_array_equal(interop.to_numpy(c)[:len(uniq)],
                                  np.bincount(keys)[uniq])
    np.testing.assert_array_equal(interop.to_numpy(mn)[:len(uniq)],
                                  want_min[uniq])


# --- the band probe (csrc/bandprobe.cu) ------------------------------------------

def _band_case(rng, nb, n_limbs, n_vals, m, key_hi):
    """Sorted build limbs (with duplicates), value columns and probes that
    include i32 max and keys between and beyond the build's."""
    keys = np.sort(rng.integers(-key_hi, key_hi, (nb, n_limbs)).astype(
        np.int32).view([("", np.int32)] * n_limbs), axis=0).view(
        np.int32).reshape(nb, n_limbs)
    build = [torch.from_numpy(np.ascontiguousarray(keys[:, l]))
             for l in range(n_limbs)]
    vals = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, nb).astype(
        np.int32)) for _ in range(n_vals)]
    pk = rng.integers(-key_hi - 2, key_hi + 2, (m, n_limbs)).astype(np.int32)
    if nb:
        pk[: m // 4] = keys[rng.integers(0, nb, m // 4)]
    pk[-1] = 2 ** 31 - 1
    probes = [torch.from_numpy(np.ascontiguousarray(pk[:, l]))
              for l in range(n_limbs)]
    return build, vals, probes


def _assert_band_equal(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)
    for gs, ws in zip(got[2:4], want[2:4]):
        for g, w in zip(gs, ws):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n_limbs", [1, 2])
@pytest.mark.parametrize("n_vals", [1, 2, 3])
@pytest.mark.parametrize("nb", [0, 1000, 3 * 4096 + 777, 70_001])
def test_probe_band_matches_plain(cuda, n_limbs, n_vals, nb):
    rng = np.random.default_rng(nb + 10 * n_limbs + n_vals)
    m = 40_000
    build, vals, probes = _band_case(rng, nb, n_limbs, n_vals, m,
                                     2 ** 31 - 1 if n_limbs == 1 else 50)
    # several window starts per call, in range and at the clamp
    for block in (16384, 65536):
        grid = -(-m // block)
        top = max((nb + 4095) // 4096, 4) - 4
        starts = torch.from_numpy(rng.integers(0, top + 1, grid).astype(
            np.int32))
        bp.reset_launches()
        got = bp.probe_band([b.to(cuda) for b in build],
                            [v.to(cuda) for v in vals],
                            [p.to(cuda) for p in probes], starts.to(cuda),
                            block)
        torch.cuda.synchronize()
        assert bp.launches["probe_band"] == 1
        _assert_band_equal(got, bp.probe_band_plain(build, vals, probes,
                                                    starts, block))


@pytest.mark.parametrize("name", band_cases.NAMES)
def test_probe_band_edge_cases(cuda, name):
    """The kernel's edges (torch_band_cases.py; the CPU tests hold the
    plain version to the definition there): the row before the window,
    probes below every window row, nb = 0 and 1, clamped windows in both
    forms, equal high limbs, a short last probe block, equal runs across
    chunk edges, and an unsorted chunk among sorted ones that exceeds its
    sub-window and searches device memory."""
    build, vals, probes, starts, block = band_cases.case(name)
    bp.reset_launches()
    got = bp.probe_band(*band_cases.as_torch(build, vals, probes, starts,
                                             cuda), block)
    torch.cuda.synchronize()
    assert bp.launches["probe_band"] == 1
    _assert_band_equal(got, bp.probe_band_plain(
        *band_cases.as_torch(build, vals, probes, starts), block))


@pytest.mark.parametrize("n_limbs", [1, 2])
def test_band_entry_points_on_card(cuda, n_limbs):
    rng = np.random.default_rng(3 + n_limbs)
    nb = 3 * 4096 + 5
    build, vals, probes = _band_case(rng, nb, n_limbs, 3, 70_000,
                                     2 ** 31 - 1 if n_limbs == 1 else 9000)
    on = [[t.to(cuda) for t in ts] for ts in (build, vals, probes)]
    got = bp.probe_direct(tuple(on[0]), tuple(on[1]), tuple(on[2]))
    want = bp.probe_direct(tuple(build), tuple(vals), tuple(probes))
    _assert_band_equal(got, want)
    order = np.lexsort([p.numpy() for p in probes[::-1]])
    sp = [p[torch.from_numpy(order)] for p in probes]
    got = bp.probe_banded_sorted(tuple(on[0]), tuple(on[1]),
                                 tuple(p.to(cuda) for p in sp),
                                 probe_rows=128)
    want = bp.probe_banded_sorted(tuple(build), tuple(vals), tuple(sp),
                                  probe_rows=128)
    _assert_band_equal(got, want)
    assert bool(got[4].cpu()) == bool(want[4])


# --- the block scans (csrc/scan.cu scan_block_tiles) -------------------------------

@pytest.mark.parametrize("n", [0, 1, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.uint32,
                                   torch.int64])
@pytest.mark.parametrize("exclusive", [False, True])
def test_scan_block_matches_plain(cuda, n, dtype, exclusive):
    rng = np.random.default_rng(n + 3)
    if dtype == torch.float32:
        x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
    else:
        info = np.iinfo(np.int64 if dtype == torch.int64 else np.int32)
        x = torch.from_numpy(rng.integers(info.min, info.max, n,
                                          endpoint=True, dtype=info.dtype))
        if dtype == torch.uint32:
            x = x.view(torch.uint32)
    tiles = -(-n // sk.TILE)
    sk.reset_launches()
    if dtype in (torch.int32, torch.float32):
        base = (torch.from_numpy(rng.uniform(-50, 50, tiles).astype(
            np.float32)) if dtype == torch.float32 else torch.from_numpy(
            rng.integers(-2 ** 31, 2 ** 31, tiles).astype(np.int32)))
        got = sk.scan_block(x.to(cuda), base.to(cuda), exclusive).cpu()
        want = sk.scan_block_plain(x, base, exclusive)
        name = "scan_block"
    else:
        base = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, tiles,
                                             dtype=np.int64))
        got = sk.scan_block_wide(x.to(cuda), base.to(cuda), exclusive).cpu()
        want = sk.scan_block_wide_plain(x, base, exclusive)
        name = "scan_block_wide"
    torch.cuda.synchronize()
    assert sk.launches[name] == (1 if n else 0)
    if dtype == torch.float32:
        # float32 sums of one tile in two orders, plus the base: 1e-5 of
        # the running sum of |x| in the tile and |base|, plus 1e-6
        tol = 1e-5 * (sk.scan_block_plain(x.abs(), base.abs(), False)) + 1e-6
        assert bool(((got - want).abs() <= tol).all())
    else:
        assert torch.equal(got, want)


def test_three_phase_scan_on_card(cuda):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 2 ** 32, (1 << 20) + 17, dtype=np.uint32)
    sk.reset_launches()
    got = scan_1d(interop.to_torch(x, cuda), sum_dtype="ulong",
                  exclusive=True, single_pass=False)
    assert sk.launches["scan_block_wide"] == 1
    want = np.cumsum(x.astype(np.uint64)) - x
    np.testing.assert_array_equal(interop.to_numpy(got), want)
    xi = x.view(np.int32)
    got = scan_1d(interop.to_torch(xi, cuda), sum_dtype="int",
                  exclusive=False, single_pass=False)
    assert sk.launches["scan_block"] == 1
    np.testing.assert_array_equal(
        interop.to_numpy(got), np.cumsum(xi.astype(np.int64)).astype(np.int32))


# --- the join, its expansion and the pipelines on the card ------------------------

def _same(got, want):
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _same(g, w)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("impl", ["direct", "banded", "merge"])
@pytest.mark.parametrize("unique_build", [True, False])
def test_hash_join_on_card_matches_cpu(cuda, impl, unique_build):
    from cl_ops_tpu_torch.ops.exec import hash_join
    rng = np.random.default_rng(40)
    nb = 12_000
    bk_ = np.sort(rng.choice(1 << 20, nb, replace=unique_build)
                  .astype(np.uint32))
    bv = rng.integers(-2 ** 31, 2 ** 31, nb).astype(np.int32)
    pk = np.concatenate([bk_[rng.integers(0, nb, 50_000)],
                         rng.integers(0, 1 << 21, 30_000).astype(np.uint32)])
    kw = dict(build_sorted=True, unique_build=unique_build, probe_impl=impl)
    args = [interop.to_torch(a, "cpu") for a in (bk_, bv, pk)]
    bp.reset_launches()
    got = hash_join(*[a.to(cuda) for a in args], **kw)
    torch.cuda.synchronize()
    assert bp.launches["probe_band"] == (0 if impl == "merge" else
                                         1 if unique_build else 2)
    want = hash_join(*args, **kw)
    hit = want[0] if unique_build else want[0] > 0
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu()[hit], want[1][hit])
    if impl != "direct":
        kw.update(sorted_output=True, defer_overflow=True,
                  probe_cols=(args[2],))
        got = hash_join(*[a.to(cuda) for a in args[:2]], args[2].to(cuda),
                        **{**kw, "probe_cols": (args[2].to(cuda),)})
        want = hash_join(*args, **kw)
        assert not bool(got[-1].cpu()) and not bool(want[-1])
        _same((got[0], got[2], got[3]), (want[0], want[2], want[3]))


def test_expand_and_pipelines_on_card_match_cpu(cuda):
    from cl_ops_tpu_torch.models import pipeline
    from cl_ops_tpu_torch.ops.exec import hash_join_expand
    rng = np.random.default_rng(41)
    bk_ = np.sort(rng.integers(0, 5000, 20_000).astype(np.uint32))
    bv = np.arange(20_000, dtype=np.int32)
    pk = rng.integers(0, 5200, 30_000).astype(np.uint32)
    args = [interop.to_torch(a, "cpu") for a in (bk_, bv, pk)]
    bp.reset_launches()
    got = hash_join_expand(*[a.to(cuda) for a in args], capacity=1 << 17,
                           build_sorted=True)
    torch.cuda.synchronize()
    assert bp.launches["probe_band"] == 4  # two range passes, two expansion
    want = hash_join_expand(*args, capacity=1 << 17, build_sorted=True)
    _same(got, want)
    bp.reset_launches()
    _same(pipeline.rollup_query(1 << 16, dim_rows=1 << 12, defer=True,
                                device=cuda),
          pipeline.rollup_query(1 << 16, dim_rows=1 << 12, defer=True,
                                device="cpu"))
    _same(pipeline.star_query(1 << 16, dim_rows=1 << 12, num_cats=64,
                              device=cuda),
          pipeline.star_query(1 << 16, dim_rows=1 << 12, num_cats=64,
                              device="cpu"))
    assert bp.launches["probe_band"] == 2  # rollup's banded, star's direct


@pytest.mark.parametrize("impl", ["blelloch", "lookback", "xla"])
@pytest.mark.parametrize("elem", ["uint", "int", "float"])
def test_scan_new_on_card_matches_cpu(cuda, impl, elem):
    from cl_ops_tpu_torch.ops.scan import scan_new
    rng = np.random.default_rng(42)
    n = 3 * sk.TILE + 11
    x = (rng.uniform(-1, 1, n).astype(np.float32) if elem == "float" else
         rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32).view(
             np.uint32 if elem == "uint" else np.int32))
    s = scan_new(impl, elem_dtype=elem)
    sk.reset_launches()
    got = s.scan_with_host_data(x, device=cuda)
    torch.cuda.synchronize()
    want = s.scan_with_host_data(x, device="cpu")
    if impl == "blelloch" or elem == "float" and impl != "xla":
        kern = "scan_block_wide" if s.sum_dtype.itemsize == 8 else \
            "scan_block"
        assert sk.launches[kern] == 1
    if elem == "float":
        x64 = x.astype(np.float64)
        tol = 1e-6 * np.cumsum(np.abs(x64)) + 1e-6
        assert (np.abs(got - want) <= tol).all()
    else:
        np.testing.assert_array_equal(got, want)


# --- the rest of the sort family (csrc/radix.cu; pair_cross at small
# distances and whole_sort in csrc/bitonic.cu) ----------------------------------

@pytest.mark.parametrize("radix", [4, 16, 256])
@pytest.mark.parametrize("n,block", [(1, 512), (3 * 8192 + 77, 8192),
                                     ((1 << 20) + 5, 1024), (5000, 1 << 14)])
def test_rank_hist_matches_plain(cuda, radix, n, block):
    rng = np.random.default_rng(radix + n)
    d = torch.from_numpy(rng.integers(-1, radix + 1, n).astype(np.int32))
    rk.reset_launches()
    rank, hist = rk.rank_hist(d.to(cuda), radix, block)
    want_rank, want_hist = rk.rank_hist_plain(d, radix, block)
    torch.cuda.synchronize()
    assert rk.launches["rank_hist"] == 1
    assert torch.equal(rank.cpu(), want_rank)
    assert torch.equal(hist.cpu(), want_hist)


@pytest.mark.parametrize("radix", [4, 16, 256])
@pytest.mark.parametrize("block", [512, 1024, 8192, 1 << 14])
def test_rank_hist_limb_matches_plain(cuda, radix, block):
    """Every shift of the radix, the limb's last digit with its flipped
    sign bit included, over three tiles and a short one; the second half
    of the limbs takes 5 values, so many lanes of a round share a digit."""
    from cl_ops_tpu_torch.ops.sort import satradix as sr
    rng = np.random.default_rng(radix + block)
    n = 3 * block + 77
    h = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    h[n // 2:] = h[:5][rng.integers(0, 5, n - n // 2)]
    h[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    limb = torch.from_numpy(h)
    on = limb.to(cuda)
    shifts = sr.pass_shifts(radix)
    rk.reset_launches()
    for shift in shifts:
        got = rk.rank_hist_limb(on, shift, radix, block)
        want = rk.rank_hist_limb_plain(limb, shift, radix, block)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert rk.launches == {"rank_hist": len(shifts),
                           "rank_hist_limb": len(shifts)}


def test_satradix_pass_is_one_rank_hist_limb_launch(cuda, monkeypatch):
    """On the card each of the 16 passes of a 64-bit key at radix 16 is one
    rank_hist_limb launch: no digit-entry rank_hist and no radix_digits."""
    def no_digits(*args):
        raise AssertionError("radix_digits on the card")
    monkeypatch.setattr(rk, "radix_digits", no_digits)
    x = np.random.default_rng(7).integers(0, 2 ** 64, 70_000,
                                          dtype=np.uint64)
    s = sort_new("satradix", elem_dtype="ulong")
    rk.reset_launches()
    k, v = s.sort_with_host_data(x, np.arange(x.size, dtype=np.int32))
    np.testing.assert_array_equal(k, np.sort(x))
    np.testing.assert_array_equal(v, np.argsort(x, kind="stable"))
    assert rk.launches == {"rank_hist": 16, "rank_hist_limb": 16}


@pytest.mark.parametrize("j", [1, 2, 16, 32])
@pytest.mark.parametrize("n_cols,num_keys,hi", [(1, 1, 2 ** 31), (3, 2, 4)])
def test_pair_cross_small_distances(cuda, j, n_cols, num_keys, hi):
    cols = _cols(1 << 16, n_cols, j, hi)
    bk.reset_launches()
    for k in (2 * j, 1 << 16, 0):
        _run_both(cols, lambda c: bk.pair_cross_(c, k, j, num_keys),
                  lambda c: bk.pair_cross_plain(c, k, j, num_keys), cuda)
    assert bk.launches["pair_cross"] == 3


@pytest.mark.parametrize("n,n_cols,num_keys,hi", [
    (2, 1, None, 2 ** 31), (1024, 2, 1, 3), (1 << 15, 1, None, 2 ** 31),
    (1 << 17, 3, 1, 3), (1 << 20, 2, None, 2 ** 31),
    (1 << 21, 1, None, 2 ** 31), (1 << 18, 8, 3, 2)])
def test_whole_sort_matches_fused(cuda, n, n_cols, num_keys, hi):
    """One cooperative launch against the fused schedule's network, run as
    plain versions on the card: bit for bit, tied key prefixes included."""
    cols = [c.to(cuda) for c in _cols(n, n_cols, n_cols, hi)]
    want = [c.clone() for c in cols]
    bk.whole_sort_plain(want, n_cols if num_keys is None else num_keys)
    bk.reset_launches()
    bk.whole_sort_(cols, num_keys)
    torch.cuda.synchronize()
    assert bk.launches["whole_sort"] == 1
    for a, b in zip(cols, want):
        assert torch.equal(a, b)


def _whole_rows_of(n_cols, where):
    """Rows of a whole_sort case: one slice, two slices, or the largest
    array (2 x WHOLE_BLOCKS slices, two per SM)."""
    one = 32 * bk.whole_rows(n_cols)  # the smallest slice of full warps
    return {"one slice": one, "two slices": 2 * one,
            "largest grid": 1 << (bk.WHOLE_MAX // n_cols).bit_length() - 1
            }[where]


@pytest.mark.parametrize("where", ["one slice", "two slices",
                                   "largest grid"])
@pytest.mark.parametrize("n_cols,num_keys", [(1, None), (3, 2), (8, 3)])
def test_whole_sort_geometry_matches_plain(cuda, where, n_cols, num_keys):
    """The register/shuffle/shared-memory whole_sort at one slice, two and
    the most of them, at 1, 3 and 8 columns with key prefixes tied
    in many rows, against whole_sort_plain bit for bit."""
    n = _whole_rows_of(n_cols, where)
    s, r = bk.whole_geometry(n, n_cols)
    assert (n // s, r) == ({"one slice": 1, "two slices": 2}.get(
        where, 2 * bk.WHOLE_BLOCKS), bk.whole_rows(n_cols))
    cols = [c.to(cuda) for c in _cols(n, n_cols, n + n_cols, 3)]
    if n_cols > 1:  # a payload column of row numbers
        cols[-1] = torch.arange(n, dtype=torch.int32, device=cuda)
    want = [c.clone() for c in cols]
    bk.whole_sort_plain(want, n_cols if num_keys is None else num_keys)
    bk.reset_launches()
    bk.whole_sort_(cols, num_keys)
    torch.cuda.synchronize()
    assert bk.launches["whole_sort"] == 1
    for a, b in zip(cols, want):
        assert torch.equal(a, b)


def test_whole_sort_past_capacity_raises(cuda):
    from cl_ops_tpu_torch.core.errors import BadArgsError
    bk.reset_launches()
    with pytest.raises(BadArgsError):
        bk.whole_sort_([torch.zeros(1 << 20, dtype=torch.int32,
                                    device=cuda)] * 3)
    with pytest.raises(BadArgsError):
        sort_new("abitonic", "single_launch=1").sort_with_host_data(
            np.zeros((1 << 21) + 1, np.uint32))
    # past the co-resident grid (1024 blocks of 8192 rows), refused by the
    # library before any launch
    big = [torch.zeros(1 << 23, dtype=torch.int32, device=cuda)]
    with pytest.raises(BadArgsError):
        bk._launch("whole_sort", big, 1, *bk.whole_geometry(1 << 23, 1))
    assert bk.launches["whole_sort"] == 0


SORTERS = [("satradix", None, "rank_hist"),
           ("satradix", "radix=256,block_elems=4096", "rank_hist"),
           ("satradix", "radix=4,scatter=bitonic,scan=blelloch", "rank_hist"),
           ("sbitonic", None, "pair_cross"),
           ("abitonic", "single_launch=1", "whole_sort"),
           ("gselect", None, None), ("xla", None, None)]


@pytest.mark.parametrize("name,opts,kernel", SORTERS)
@pytest.mark.parametrize("dt", ["uint", "ulong", "float"])
def test_sorters_on_card_match_numpy(cuda, name, opts, kernel, dt):
    from cl_ops_tpu_torch.core.dtypes import type_by_name
    rng = np.random.default_rng(len(name) + len(dt))
    n = 5000 if name == "gselect" else 70_000
    npdt = type_by_name(dt).np_dtype
    x = (rng.standard_normal(n) * 100).astype(npdt) if dt == "float" else \
        rng.integers(0, 2 ** (8 * np.dtype(npdt).itemsize), n,
                     dtype=np.uint64).astype(npdt)
    ties = x[rng.integers(0, 50, n)]
    vals = np.arange(n, dtype=np.int32)
    s = sort_new(name, opts, elem_dtype=dt)
    bk.reset_launches()
    rk.reset_launches()
    np.testing.assert_array_equal(s.sort_with_host_data(x), np.sort(x))
    k, v = s.sort_with_host_data(ties, vals)
    np.testing.assert_array_equal(k, np.sort(ties))
    if name in ("satradix", "gselect", "xla"):  # stable
        np.testing.assert_array_equal(v, np.argsort(ties, kind="stable"))
    else:
        np.testing.assert_array_equal(ties[v], k)
        np.testing.assert_array_equal(np.sort(v), vals)
    if kernel is not None:
        assert {**bk.launches, **rk.launches}[kernel] > 0


def test_autotune_on_card(cuda, tmp_path, monkeypatch):
    from cl_ops_tpu_torch.ops.exec import psort
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    monkeypatch.setattr(autotune, "_mem_cache", {})
    x = np.random.default_rng(3).integers(0, 2 ** 32, 100_000,
                                          dtype=np.uint32)
    s = sort_new("abitonic", "autotune=1")
    np.testing.assert_array_equal(s.sort_with_host_data(x), np.sort(x))
    entry = json.loads(path.read_text())
    assert list(entry) == [f"{torch.cuda.get_device_name(cuda)}:131072x1"]
    monkeypatch.setenv("CL_OPS_PSORT_AUTOTUNE", "1")
    col = torch.from_numpy(x.view(np.int32)).to(cuda)
    got = psort.sort_i32_cols((col,))[0]
    assert torch.equal(got, torch.sort(col).values)
    assert len(json.loads(path.read_text())) == 1  # the same shape: cached


# --- the dense GROUP BY (csrc/dense_agg.cu) and the run copy
# (csrc/chunk_copy.cu) ----------------------------------------------------------

def _dense_reductions(cols, n_extra=0):
    """count, int32 sum/min/max, a flipped u32 min and max, float32 limbs'
    min and max, and n_extra more sums (past one launch's 32)."""
    i32, u32, f32 = cols
    reds = [(None, "count", False), (i32, "sum", False), (i32, "min", False),
            (i32, "max", False), (u32, "min", True), (u32, "max", True),
            (f32, "min", False), (f32, "max", False)]
    return reds + [(i32, "sum", False)] * n_extra


@pytest.mark.parametrize("num_groups", [1, 4, 32, 200, 1024])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_agg_matches_plain(cuda, num_groups, masked):
    from cl_ops_tpu_torch.ops.exec import dense_agg as da
    from cl_ops_tpu_torch.ops.sort import keys as keymod
    rng = np.random.default_rng(num_groups)
    n = 300_007  # not a multiple of any block
    gid = torch.from_numpy(rng.integers(-3, num_groups + 3, n)
                           .astype(np.int32))
    mask = torch.from_numpy(rng.random(n) < 0.6) if masked else None
    cols = (torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                             .astype(np.int32)),
            keymod.to_limbs(torch.from_numpy(
                rng.standard_normal(n).astype(np.float32)))[0])
    reds = _dense_reductions(cols, 30 if num_groups == 200 else 0)
    on = {id(c): c.to(cuda) for c in cols}
    da.reset_launches()
    got = da.dense_agg(gid.to(cuda), None if mask is None else mask.to(cuda),
                       [(None if c is None else on[id(c)], k, f)
                        for c, k, f in reds], num_groups)
    torch.cuda.synchronize()
    assert da.launches["dense_agg"] == (2 if len(reds) > 32 else 1)
    assert torch.equal(got.cpu(), da.dense_agg_plain(gid, mask, reds,
                                                     num_groups))


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_dense_agg_all_masked_and_empty(cuda, n):
    from cl_ops_tpu_torch.ops.exec import dense_agg as da
    gid = torch.zeros(n, dtype=torch.int32)
    x = torch.arange(n, dtype=torch.int32)
    reds = _dense_reductions((x, x, x))
    got = da.dense_agg(gid.to(cuda), torch.zeros(n, dtype=torch.bool,
                                                 device=cuda),
                       [(None if c is None else c.to(cuda), k, f)
                        for c, k, f in reds], 4)
    want = da.dense_agg_plain(gid, torch.zeros(n, dtype=torch.bool), reds, 4)
    assert torch.equal(got.cpu(), want)
    assert (want[0] == 0).all()


def _dense_run(gid, mask, reds, num_groups, dev):
    """dense_agg on the card (operands sliced on the card as on the host:
    a copy would realign them) against its plain version."""
    def on(t):
        if t is None:
            return None
        base = t._base if t._base is not None else t
        return base.to(dev)[t.storage_offset():t.storage_offset() + t.numel()]
    da.reset_launches()
    got = da.dense_agg(on(gid), on(mask), [(on(c), k, f) for c, k, f in reds],
                       num_groups)
    torch.cuda.synchronize()
    assert da.launches["dense_agg"] == 1
    assert torch.equal(got.cpu(), da.dense_agg_plain(gid, mask, reds,
                                                     num_groups))


@pytest.mark.parametrize("num_groups", [1, 4, 65, 1024])
@pytest.mark.parametrize("form", ["one column", "unaligned",
                                  "unaligned columns"])
def test_dense_agg_layouts_match_plain(cuda, num_groups, form):
    """Tables of 8 reductions in 64 copies a block (1 and 4 groups, each
    lane of a warp in its own copy), 23 copies (65 groups: lanes share
    copies) and one (1024); one column feeding count, sum, min and max
    (plain and flipped); every operand one element into its tensor (vector
    rows after a 3-row head); only the value columns one element in (rows
    one at a time)."""
    rng = np.random.default_rng(num_groups + len(form))
    n = 300_007

    def col(lo=-2 ** 31, hi=2 ** 31):
        return torch.from_numpy(rng.integers(lo, hi, n + 1).astype(np.int32))
    off = 1 if form == "unaligned" else 0
    gid = col(-3, num_groups + 3)[off:off + n]
    mask = torch.from_numpy(rng.random(n + 1) < 0.6)[off:off + n]
    off = 1 if form.startswith("unaligned") else 0
    cols = [col()[off:off + n] for _ in range(3)]
    if form == "one column":
        x = cols[0]
        reds = [(None, "count", False), (x, "sum", False), (x, "min", False),
                (x, "max", False), (x, "min", True), (x, "max", True)]
    else:
        reds = _dense_reductions(cols)
    _dense_run(gid, mask, reds, num_groups, cuda)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("num_groups", [4, 200])
@pytest.mark.parametrize("off", [0, 1])
def test_dense_agg_short_columns(cuda, n, num_groups, off):
    """Fewer rows than a vector, or one vector and a tail, at an aligned
    start and one element in."""
    rng = np.random.default_rng(n + num_groups + off)
    gid = torch.from_numpy(rng.integers(0, num_groups, n + 1)
                           .astype(np.int32))[off:off + n]
    mask = torch.from_numpy(rng.random(n + 1) < 0.7)[off:off + n]
    cols = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n + 1)
                             .astype(np.int32))[off:off + n]
            for _ in range(3)]
    _dense_run(gid, mask, _dense_reductions(cols), num_groups, cuda)


@pytest.mark.parametrize("n_arrays", [1, 3, 9])
def test_chunk_copy_matches_plain(cuda, n_arrays):
    from cl_ops_tpu_torch.ops.sort import dma_scatter as ds
    rng = np.random.default_rng(n_arrays)
    n = 40 * ds.CHUNK + 333  # a partial last chunk
    cuts = np.sort(rng.choice(np.arange(1, n), 60, replace=True))
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    lengths = (np.concatenate([cuts, [n]]) - starts).astype(np.int32)
    qlen = (lengths + ds.CHUNK - 1) // ds.CHUNK * ds.CHUNK
    qstarts = (np.cumsum(qlen) - qlen).astype(np.int32)
    n_chunks = n // ds.CHUNK + len(lengths) + 4  # whole-sentinel slots
    params = ds.plan_run_chunks(*(torch.from_numpy(a) for a in
                                  (starts, qstarts, lengths)),
                                n_chunks_static=n_chunks)
    arrs = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                             .astype(np.int32)) for _ in range(n_arrays)]
    ds.reset_launches()
    got = ds.chunk_copy([a.to(cuda) for a in arrs], params.to(cuda),
                        n_chunks=n_chunks)
    torch.cuda.synchronize()
    assert ds.launches["chunk_copy"] == (2 if n_arrays > 8 else 1)
    want = ds.chunk_copy_plain(arrs, params, n_chunks)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for s, q, ln in zip(starts, qstarts, lengths):
        assert torch.equal(got[0][q:q + ln].cpu(), arrs[0][s:s + ln])


def test_new_operators_on_card_match_cpu(cuda):
    """The dense GROUP BY, window_cols in both forms, top_k through both
    of its branches, and distinct: CUDA tensors against CPU tensors."""
    from cl_ops_tpu_torch.ops.exec import (dense_agg, distinct,
                                           group_aggregate_dense_cols, top_k,
                                           topk, window_cols)
    from cl_ops_tpu_torch.ops.scan import segmented
    rng = np.random.default_rng(44)
    n = 200_000
    gid = rng.integers(-1, 9, n).astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.int32)
    price = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    disc = (rng.integers(0, 11, n) * 0.25).astype(np.float32)
    mask = rng.random(n) < 0.98
    host = [interop.to_torch(a, "cpu") for a in (gid, qty, price, disc, mask)]
    dev = [t.to(cuda) for t in host]
    aggs = ("sum", "mean", "min", "max", "count", "max", "min")

    def dense(t):
        return group_aggregate_dense_cols(
            t[0], (t[1], t[1], t[2], t[2], t[1], t[3], t[3]), aggs,
            num_groups=8, valid_mask=t[4])
    dense_agg.reset_launches()
    _same(dense(dev), dense(host))
    assert dense_agg.launches["dense_agg"] == 1

    keys = interop.to_torch(rng.integers(0, 3000, n).astype(np.uint32), "cpu")
    order = interop.to_torch(rng.integers(0, 100, n).astype(np.int32), "cpu")
    waggs = ("sum", "row_number", "rank", "dense_rank", "lag", "min",
             "mean", "count")
    wvals = (host[1], None, None, None, host[2], host[3], host[3], None)

    def window(k, o, v, **kw):
        return window_cols(k, o, v, waggs, **kw)
    segmented.reset_launches()
    on = tuple(None if v is None else v.to(cuda) for v in wvals)
    _same(window(keys.to(cuda), order.to(cuda), on),
          window(keys, order, wvals))
    _same(window(keys.to(cuda), order.to(cuda), on, sorted_output=True),
          window(keys, order, wvals, sorted_output=True))
    assert segmented.launches["seg_scan_carry"] > 0

    spread = (np.arange(n, dtype=np.int64) * 7919 % n).astype(np.uint32)
    flood = np.zeros(n, np.uint32)  # 90% of the rows tie at the minimum
    flood[: n // 10] = rng.integers(1, 1 << 20, n // 10)
    for vals, branch in ((spread, "fast"), (flood, "exact")):
        for largest in (False, True):
            if largest and branch == "exact":  # the ties at the maximum
                vals = (np.uint32(1 << 20) - vals).astype(np.uint32)
            v = interop.to_torch(vals, "cpu")
            got = top_k(v.to(cuda), 16, dev[1], largest=largest)
            assert topk.last_branch == branch
            _same(got, top_k(v, 16, host[1], largest=largest))
    _same(distinct(keys.to(cuda), capacity=4096),
          distinct(keys, capacity=4096))


@pytest.mark.parametrize("name", ["lcg", "xorshift64", "xorshift128",
                                  "mwc64x", "parkmiller", "tauslcg",
                                  "threefry"])
@pytest.mark.parametrize("seeding", [("dev_gid", "knuth", 42),
                                     ("dev_gid", "xs1", 2 ** 64 - 9),
                                     ("host_mt", None, 7)])
def test_rng_on_card_matches_cpu(cuda, name, seeding):
    """Each generator's states and draws on the card equal the CPU's bit
    for bit at 4096 streams, through generate and next_int."""
    from cl_ops_tpu_torch.ops.rng import rng_new
    seed_type, hash_name, seed = seeding
    kw = dict(num_streams=4096, main_seed=seed, hash_name=hash_name)
    card = rng_new(name, seed_type, device=cuda, **kw)
    host = rng_new(name, seed_type, device="cpu", **kw)
    assert card.states.device.type == "cuda"
    assert torch.equal(card.states.cpu(), host.states)
    assert torch.equal(card.generate(16).view(torch.int32).cpu(),
                       host.generate(16).view(torch.int32))
    assert torch.equal(card.next_int(1000, 4).view(torch.int32).cpu(),
                       host.next_int(1000, 4).view(torch.int32))
    assert torch.equal(card.states.cpu(), host.states)


def test_stream_ceiling_on_card(cuda, tmp_path, monkeypatch):
    """The measured ceiling lies in (0, 1.05 x 3350] GB/s and is cached per
    device name and size in $CL_OPS_ROOFLINE_CACHE."""
    from cl_ops_tpu_torch.bench import roofline
    cache = tmp_path / "roofline.json"
    monkeypatch.setenv(roofline.CACHE_ENV, str(cache))
    monkeypatch.delenv(roofline.GBS_ENV, raising=False)
    roofline.stream_ceiling_gbs.cache_clear()
    try:
        gbs = roofline.stream_ceiling_gbs(mb=256)
        assert 0 < gbs <= 1.05 * 3350
        name = torch.cuda.get_device_name(cuda).replace(" ", "_")
        assert json.loads(cache.read_text()) == {f"{name}:256": gbs}
        roofline.stream_ceiling_gbs.cache_clear()
        assert roofline.stream_ceiling_gbs(mb=256) == gbs  # from the file
    finally:
        roofline.stream_ceiling_gbs.cache_clear()
