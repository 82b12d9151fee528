"""Banded join probe: per-probe binary search in a window of the sorted
build side.

Counterpart of `cl_ops_tpu/ops/exec/bandprobe.py`. The probe side of the
join wants, per probe key p, the searchsorted-right count (#build rows <=
p), whether the last such row equals p, and the build values on both sides
of the count. One CUDA kernel, `probe_band` (`csrc/bandprobe.cu`, replacing
`_probe_band_kernel`), searches each probe inside a window of WINDOW sorted
build rows; the window starts and the overflow test are small per-block
computations in plain torch here, as the JAX package did them in XLA.

  * probe_direct: build sides of <= DIRECT_MAX rows are one window, so the
    probes stream in their original order (no probe sort, no restore).
  * probe_banded_sorted: sorted probes in blocks of probe_rows * ROW; each
    block's window starts at a build block chosen from block-first keys,
    and `overflow` reports a block whose build range exceeds its window
    (extreme skew; the join then falls back to its merge probe).

The constants below decide results, not tiling, so they stay exactly the
JAX package's: the window start of each probe block (in units of
BUILD_BLOCK rows), the window length, the probe block and hence the
overflow flag that `hash_join(defer_overflow=True)` returns, and the
strategy `probe_impl="auto"` picks (DIRECT_MAX). The JAX names are WBE
(BUILD_BLOCK), PULL (WINDOW_BLOCKS), DIRECT_MAX and LANES (ROW).

`probe_band` runs its plain PyTorch version on CPU tensors and launches the
kernel on CUDA tensors, adding one to `launches["probe_band"]` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils.bits import cdiv
from cl_ops_tpu_torch.utils.platform import build_library

BUILD_BLOCK = 4096          # build rows per window-start unit (JAX WBE)
WINDOW_BLOCKS = 4           # build blocks per window (JAX PULL)
WINDOW = BUILD_BLOCK * WINDOW_BLOCKS  # 16384 rows: csrc/bandprobe.cu WINDOW
DIRECT_MAX = WINDOW         # build rows coverable without sorting probes
ROW = 128                   # probes per probe row (JAX LANES)
PROBE_ROWS = 512            # probe rows per probe block: 64K probes
MAX_VALS = 3                # csrc/bandprobe.cu MAX_VALS
WHOLE_THREADS = 512         # threads of a whole-side block (csrc)
SUB_THREADS = 256           # threads of a sub-window block (csrc)
SMEM_MAX = 232448           # shared memory one Hopper block can use
KERNELS = ("probe_band",)

_I32_MAX = 0x7FFFFFFF

# Kernel launches per wrapper since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


# --- the CUDA library --------------------------------------------------------

_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/bandprobe.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("bandprobe")
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        # (probe, build, n_limbs, vals, n_vals, starts, m, nb, probe_block,
        #  count, eq, vprev, vnext, stream)
        lib.clo_probe_band.argtypes = [ptrs, ptrs, i, ptrs, i, p, ll, ll, ll,
                                       p, p, ptrs, ptrs, p]
        lib.clo_probe_band.restype = i
        lib.clo_band_window.restype = i
        if lib.clo_band_window() != WINDOW:
            raise RuntimeError("csrc/bandprobe.cu WINDOW differs from "
                               "bandprobe.WINDOW")
        lib.clo_band_geometry.argtypes = [ll, i, i, ctypes.POINTER(ll)]
        lib.clo_band_geometry.restype = i
        out = (ll * 4)()
        for nb in (0, 1000, WINDOW, WINDOW + 1, 1 << 24):
            for nl in (1, 2):
                for nv in range(1, MAX_VALS + 1):
                    lib.clo_band_geometry(nb, nl, nv, out)
                    if tuple(out) != band_geometry(nb, nl, nv):
                        raise RuntimeError("csrc/bandprobe.cu band_geometry "
                                           "differs from "
                                           "bandprobe.band_geometry")
        _lib = lib
    return _lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


# --- lexicographic compares over limb tuples -------------------------------------

def lex_le(a, b) -> torch.Tensor:
    """a <= b in signed lexicographic order of equal-length limb lists."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt | eq


def _composite(limbs) -> torch.Tensor:
    """One int64 per key ordering like its 1-2 int32 limbs."""
    if len(limbs) == 1:
        return limbs[0].to(torch.int64)
    return limbs[0].to(torch.int64) * (1 << 32) + \
        (limbs[1].to(torch.int64) + (1 << 31))


# --- kernel and plain version ----------------------------------------------------

def _check(build_limbs, vals, probe_limbs, starts, probe_block) -> bool:
    """Validate probe_band's operands; returns whether they lie on the
    card."""
    if not 1 <= len(build_limbs) == len(probe_limbs) <= 2:
        raise BadArgsError("1 or 2 key limbs, equal on both sides")
    if not 1 <= len(vals) <= MAX_VALS:
        raise BadArgsError(f"1..{MAX_VALS} value columns, got {len(vals)}")
    nb, m = build_limbs[0].numel(), probe_limbs[0].numel()
    dev = probe_limbs[0].device
    for t, n in [(c, nb) for c in (*build_limbs, *vals)] + \
            [(c, m) for c in probe_limbs] + [(starts, cdiv(m, probe_block))]:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise BadArgsError("band probe operands must be contiguous 1-D "
                               "int32")
        if t.numel() != n or t.device != dev:
            raise BadArgsError("band probe operands differ in length or "
                               "device")
    if probe_block < 1 or nb >= 1 << 31 or m >= 1 << 31:
        raise BadArgsError("probe_block must be positive and the sides "
                           "shorter than 2^31")
    if dev.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {dev}")
    return dev.type == "cuda"


def band_geometry(nb: int, n_limbs: int, n_vals: int
                  ) -> tuple[int, int, int, int]:
    """(whole, threads, staged rows, shared-memory bytes) of a probe_band
    launch against nb build rows (csrc/bandprobe.cu band_geometry, which
    load_kernels checks against this). whole: the build side is one window
    (nb <= WINDOW), and each persistent block of WHOLE_THREADS stages all
    of it in whole 32-row lines (the stage swizzles rows within a line),
    its value columns too where keys and values fit SMEM_MAX. Otherwise
    blocks of SUB_THREADS search device memory and stage nothing."""
    whole = nb <= WINDOW
    if not whole:
        return 0, SUB_THREADS, 0, 0
    cap = -(-nb // 32) * 32
    staged = n_limbs + (n_vals if (n_limbs + n_vals) * cap * 4 <= SMEM_MAX
                        else 0)
    return 1, WHOLE_THREADS, cap, staged * cap * 4


def probe_band_plain(build_limbs, vals, probe_limbs, starts,
                     probe_block: int):
    """Plain version of probe_band: a 15-step binary search of each probe
    in its block's window, as whole-tensor gathers."""
    nb, m = build_limbs[0].numel(), probe_limbs[0].numel()
    dev = probe_limbs[0].device
    blk = torch.arange(m, dtype=torch.int64, device=dev) // probe_block
    offs = starts.to(torch.int64)[blk] * BUILD_BLOCK
    wl = ((offs + WINDOW).clamp(max=nb) - offs).clamp(min=0)
    pos = torch.zeros(m, dtype=torch.int64, device=dev)
    step = WINDOW
    while step >= 1 and nb > 0:
        cand = pos + step
        idx = (offs + cand - 1).clamp(0, nb - 1)
        le = lex_le([b[idx] for b in build_limbs], probe_limbs)
        pos = torch.where((cand <= wl) & le, cand, pos)
        step //= 2
    count = offs + pos
    eq = count > 0
    zero = torch.zeros(m, dtype=torch.int32, device=dev)
    if nb == 0:
        return count.to(torch.int32), eq, (zero,) * len(vals), \
            (zero,) * len(vals)
    prev = (count - 1).clamp(min=0)
    nxt = count.clamp(max=nb - 1)
    for b, p in zip(build_limbs, probe_limbs):
        eq = eq & (b[prev] == p)
    return (count.to(torch.int32), eq, tuple(v[prev] for v in vals),
            tuple(v[nxt] for v in vals))


def probe_band(build_limbs, vals, probe_limbs, starts, probe_block: int):
    """Search each probe of block i (probe_block consecutive probes) in the
    window [starts[i] * BUILD_BLOCK, + WINDOW) of the sorted build limbs.

    build_limbs/probe_limbs: 1-2 int32 limb columns each; vals: 1-3 int32
    value columns of the build's length; starts: int32, one per probe
    block. Returns (count int32, eq bool, val_prev tuple, val_next tuple)
    per probe: count = window start + #window rows <= probe, eq = count > 0
    and build[count-1] == probe, val_prev[k] = vals[k][max(count-1, 0)],
    val_next[k] = vals[k][min(count, nb-1)] (zeros when nb == 0).
    """
    build_limbs, vals, probe_limbs = (tuple(build_limbs), tuple(vals),
                                      tuple(probe_limbs))
    if not _check(build_limbs, vals, probe_limbs, starts, probe_block):
        return probe_band_plain(build_limbs, vals, probe_limbs, starts,
                                probe_block)
    m, dev = probe_limbs[0].numel(), probe_limbs[0].device
    count = torch.empty(m, dtype=torch.int32, device=dev)
    eq = torch.empty(m, dtype=torch.bool, device=dev)
    vps = tuple(torch.empty(m, dtype=torch.int32, device=dev) for _ in vals)
    vns = tuple(torch.empty(m, dtype=torch.int32, device=dev) for _ in vals)
    if m == 0:
        return count, eq, vps, vns
    lib = load_kernels()
    with torch.cuda.device(dev):  # the library launches on it
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.clo_probe_band(
            _ptrs(probe_limbs), _ptrs(build_limbs), len(build_limbs),
            _ptrs(vals), len(vals), starts.data_ptr(), m,
            build_limbs[0].numel(), probe_block, count.data_ptr(),
            eq.data_ptr(), _ptrs(vps), _ptrs(vns), stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel probe_band failed: error {err}")
    launches["probe_band"] += 1
    return count, eq, vps, vns


def band_pass_traffic_bytes(m: int, n_limbs: int, nb: int,
                            probe_rows: int = PROBE_ROWS,
                            n_vals: int = 1) -> int:
    """Device-memory bytes of one probe_band pass over m probes against nb
    build rows: the probe limbs read, the outputs written (count 4, eq 1,
    val_prev and val_next 4 each per value column), and one window of
    limbs and values read per probe block."""
    grid = cdiv(m, probe_rows * ROW)
    window = grid * min(WINDOW, nb) * (n_limbs + n_vals) * 4
    return n_limbs * 4 * m + (5 + 8 * n_vals) * m + window


# --- window starts and the two entry points --------------------------------------

def _at(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[idx] where idx < len(col), i32 max (the pad key) elsewhere."""
    n = col.numel()
    if n == 0:
        return torch.full(idx.shape, _I32_MAX, dtype=torch.int32,
                          device=idx.device)
    return torch.where(idx < n, col[idx.clamp(max=n - 1)], _I32_MAX)


def window_starts(build_limbs, firsts, lasts):
    """(starts, overflow) of the probe blocks whose queries lie in
    [firsts[i], lasts[i]] (per-limb tensors, one entry per block).

    The build side is viewed as padded with i32-max rows to at least
    WINDOW_BLOCKS blocks of BUILD_BLOCK rows. start[i] = (#build blocks
    whose first key <= firsts[i]) - 1, clamped so the window stays inside
    the padded side. overflow: some block has real build rows beyond its
    window AND its window's last key is <= lasts[i] (so the first build row
    greater than every query of the block is inside the window whenever it
    exists). Returns int32 starts and a 0-d bool tensor.
    """
    nb = build_limbs[0].numel()
    dev = build_limbs[0].device
    nbb_real = cdiv(nb, BUILD_BLOCK)
    nbb = max(nbb_real, WINDOW_BLOCKS)
    first_row = torch.arange(nbb, dtype=torch.int64, device=dev) * BUILD_BLOCK
    fs = [_at(b, first_row) for b in build_limbs]
    ls = [_at(b, first_row + BUILD_BLOCK - 1) for b in build_limbs]
    cb = torch.searchsorted(_composite(fs), _composite(firsts), right=True)
    starts = (cb - 1).clamp(0, max(nbb - WINDOW_BLOCKS, 0))
    wlast = (starts + WINDOW_BLOCKS).clamp(max=nbb) - 1
    beyond = (starts + WINDOW_BLOCKS) < nbb_real
    ovf = beyond & lex_le([l[wlast] for l in ls], list(lasts))
    return starts.to(torch.int32), ovf.any()


def _as_vals_tuple(build_vals):
    """Accept one value column or a tuple of them."""
    return build_vals if isinstance(build_vals, tuple) else (build_vals,)


def probe_direct(build_limbs, build_vals, probe_limbs):
    """Unsorted-probe search against a small (<= DIRECT_MAX rows) sorted
    build side: its whole table is one window, so the probes keep their
    original order. Returns (count, eq, val_prev, val_next) per probe as
    probe_band defines them (val_prev/val_next are tuples when build_vals
    is a tuple)."""
    nb = build_limbs[0].numel()
    m = probe_limbs[0].numel()
    if nb > DIRECT_MAX:
        raise BadArgsError(f"build side of {nb} rows is too large for the "
                           f"direct band probe (<= {DIRECT_MAX})")
    block = PROBE_ROWS * ROW
    starts = torch.zeros(cdiv(m, block), dtype=torch.int32,
                         device=probe_limbs[0].device)
    count, eq, vps, vns = probe_band(build_limbs, _as_vals_tuple(build_vals),
                                     probe_limbs, starts, block)
    if not isinstance(build_vals, tuple):
        return count, eq, vps[0], vns[0]
    return count, eq, vps, vns


def probe_banded_sorted(build_limbs, build_vals, sp_limbs, *,
                        probe_rows: int = PROBE_ROWS, block_bounds=None):
    """Search SORTED probes against an arbitrarily large sorted build side.

    Returns (count, eq, val_prev, val_next, overflow) per sorted probe;
    overflow (a 0-d bool tensor, read on the host by nobody here) is True
    when some probe block's build range exceeds its window, and the results
    are then unusable.

    Requires non-decreasing queries unless `block_bounds = (lo_limbs,
    hi_limbs)` is given: per-limb tensors bounding every query of probe
    block i inclusively as lo[i] <= q <= hi[i], one entry per block of
    probe_rows * ROW probes. Window starts then derive from lo and the
    overflow test from hi (the join expansion's pass 2 needs this: its
    queries dip back at duplicate probe keys). Smaller probe_rows span
    fewer build rows per block.
    """
    vals = _as_vals_tuple(build_vals)
    m = sp_limbs[0].numel()
    dev = sp_limbs[0].device
    block = probe_rows * ROW
    grid = cdiv(m, block)
    if block_bounds is None:
        heads = torch.arange(grid, dtype=torch.int64, device=dev) * block
        tails = (heads + block).clamp(max=m) - 1
        firsts = [c[heads] for c in sp_limbs]
        lasts = [c[tails] for c in sp_limbs]
    else:
        firsts, lasts = (list(b) for b in block_bounds)
    if m == 0:
        starts = torch.zeros(0, dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        starts, overflow = window_starts(build_limbs, firsts, lasts)
    count, eq, vps, vns = probe_band(build_limbs, vals, sp_limbs, starts,
                                     block)
    if not isinstance(build_vals, tuple):
        return count, eq, vps[0], vns[0], overflow
    return count, eq, vps, vns, overflow
