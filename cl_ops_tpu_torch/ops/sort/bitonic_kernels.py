"""The bitonic sorts: host schedules, five CUDA entry points, plain versions.

Counterpart of `cl_ops_tpu/ops/sort/bitonic_kernels.py`. The data is a tuple
of 1-D int32 columns of one power-of-two length; rows order by signed-i32
lexicographic comparison of the first `num_keys` columns (all when None) and
the rest ride as payload.

Fused schedule (`bitonic_sort_2d`) for n rows, sort block B and merge block M:
  block_sort   stages K = 2 .. B inside each B-block          1 launch
  multi_stage  stages K = 2B .. M inside each M-block         1 launch (M > B)
  per stage K = 2M .. n:
    pair_cross   steps J = K/2 .. M on gathered tiles         ceil(steps/span)
    block_merge  steps J = M/2 .. 1 inside each M-block       1 launch
where the span (`cross_span`) is the most steps one pair_cross launch takes
at the array's column count (`cross_passes` cuts a stage's steps into runs).
With single_launch=True the same network runs as one cooperative
`whole_sort` launch (n x columns <= WHOLE_MAX). `sbitonic_sort_2d` runs it
one `pair_cross` launch per step (K, J), J down to 1.

Every compare-exchange is in pair form: the two rows swap, all columns
together, only when strictly out of order for the pair's direction, which is
ascending iff (global index of the lower partner) & K == 0. So ties never
duplicate a row, and a kernel and its plain version agree bit for bit, ties
included. The CUDA kernels live in `csrc/bitonic.cu` and work in place;
multi_stage runs block_sort's kernel from stage 2B, at the merge tile.

Each wrapper (`block_sort_`, `multi_stage_`, `pair_cross_`, `block_merge_`,
`whole_sort_`) runs the plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, adding one to `launches[<name>]` per launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils.bits import is_po2, log2_floor, nlpo2
from cl_ops_tpu_torch.utils.platform import build_library, launch_stream

MAX_COLS = 8           # csrc/bitonic.cu MAX_COLS
MAX_LEN = 1 << 30      # indices and stage bits stay inside 32-bit ints
SMEM_MAX = 227 * 1024  # dynamic shared memory one Hopper block can use
# n x columns of the single-launch sort: the JAX package's limit (16384 rows
# of 128 per array), 8 MB of int32
WHOLE_MAX = 1 << 21
WHOLE_BLOCKS = 128    # slices of a whole_sort: a power of two <= 132 SMs
WHOLE_THREADS = 512   # threads of a whole_sort block at most: two fit an SM
FUSED = ("block_sort", "multi_stage", "pair_cross", "block_merge")
KERNELS = FUSED + ("whole_sort",)

# Kernel launches per wrapper since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


# --- the CUDA library --------------------------------------------------------

_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/bitonic.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("bitonic")
        lib = ctypes.CDLL(str(path))
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        for name in KERNELS:
            # (columns, n_cols, num_keys, n, 1-3 geometry ints, stream)
            n_ints = {"block_sort": 4, "pair_cross": 6}.get(name, 5)
            fn = getattr(lib, f"clo_{name}")
            fn.argtypes = [ptrs] + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.clo_whole_rows.argtypes = [ctypes.c_int]
        lib.clo_whole_rows.restype = ctypes.c_int
        if any(lib.clo_whole_rows(c) != whole_rows(c)
               for c in range(1, MAX_COLS + 1)):
            raise RuntimeError("csrc/bitonic.cu whole_rows differs from "
                               "bitonic_kernels.whole_rows")
        lib.clo_cross_span.argtypes = [ctypes.c_int]
        lib.clo_cross_span.restype = ctypes.c_int
        if any(lib.clo_cross_span(c) != cross_span(c)
               for c in range(1, MAX_COLS + 1)):
            raise RuntimeError("csrc/bitonic.cu cross_span differs from "
                               "bitonic_kernels.cross_span")
        lib.clo_block_rows.argtypes = [ctypes.c_int] * 2
        lib.clo_block_rows.restype = ctypes.c_int
        lib.clo_block_smem.argtypes = [ctypes.c_int] * 2
        lib.clo_block_smem.restype = ctypes.c_longlong
        for c, length in block_tiles():
            _, rows, smem = block_geometry(c, length)
            if (lib.clo_block_rows(c, length), lib.clo_block_smem(c, length)
                    ) != (rows, smem):
                raise RuntimeError("csrc/bitonic.cu block_rows/block_smem "
                                   "differ from bitonic_kernels."
                                   "block_geometry")
        _lib = lib
    return _lib


# cudaErrorCooperativeLaunchTooLarge (CUDA 12's runtime enum): whole_sort's
# grid cannot be co-resident
_COOPERATIVE_TOO_LARGE = 720


def _launch(name: str, cols, num_keys: int, *ints) -> None:
    fn = getattr(load_kernels(), f"clo_{name}")
    ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    dev = cols[0].device
    here = dev.index == torch.cuda.current_device()
    # the library launches on the current device
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        err = fn(ptrs, len(cols), num_keys, cols[0].numel(), *ints,
                 launch_stream(dev))
    if err == _COOPERATIVE_TOO_LARGE:
        raise BadArgsError(f"{name}: {cols[0].numel()} rows need more "
                           "co-resident blocks than the card holds")
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: error {err}")
    launches[name] += 1


def _check(cols, num_keys, *blocks, smem_block=0) -> tuple[int, bool]:
    """Validate columns (and that `smem_block` rows of them fit one block's
    shared memory); returns (resolved num_keys, is_cuda)."""
    if not 1 <= len(cols) <= MAX_COLS:
        raise BadArgsError(f"1..{MAX_COLS} columns, got {len(cols)}")
    n = cols[0].numel()
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or not c.is_contiguous():
            raise BadArgsError("columns must be contiguous 1-D int32")
        if c.numel() != n or c.device != dev:
            raise BadArgsError("columns differ in length or device")
    if not is_po2(n) or n > MAX_LEN:
        raise BadArgsError(f"length {n} is not a power of two <= 2^30")
    for b in blocks:
        if not is_po2(b) or b > n:
            raise BadArgsError(f"block {b} is not a power of two <= {n}")
    if len(cols) * smem_block * 4 > SMEM_MAX:
        raise BadArgsError(f"{len(cols)} columns of {smem_block} rows exceed "
                           f"{SMEM_MAX} bytes of shared memory")
    if dev.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {dev}")
    nk = len(cols) if num_keys is None else num_keys
    if not 1 <= nk <= len(cols):
        raise BadArgsError(f"num_keys {num_keys} out of range")
    return nk, dev.type == "cuda"


# --- plain versions ----------------------------------------------------------

def _lex_lt(a, b):
    """Strict signed lexicographic a < b over equal-length column lists."""
    lt = a[0] < b[0]
    eq = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _plain_step(cols, k: int, j: int, num_keys: int) -> None:
    """One network step (stage k, distance j) over whole columns, in place."""
    n = cols[0].numel()
    g = n // (2 * j)
    views = [c.view(g, 2, j) for c in cols]
    lo = [v[:, 0] for v in views]
    hi = [v[:, 1] for v in views]
    base = torch.arange(g, device=cols[0].device, dtype=torch.int64) * (2 * j)
    asc = ((base & k) == 0).unsqueeze(1)
    swap = torch.where(asc, _lex_lt(hi[:num_keys], lo[:num_keys]),
                       _lex_lt(lo[:num_keys], hi[:num_keys]))
    for v, l, h in zip(views, lo, hi):
        nl, nh = torch.where(swap, h, l), torch.where(swap, l, h)
        v[:, 0] = nl
        v[:, 1] = nh


def _plain_stages(cols, k_first: int, k_last: int, num_keys: int) -> None:
    k = k_first
    while k <= k_last:
        j = k // 2
        while j >= 1:
            _plain_step(cols, k, j, num_keys)
            j //= 2
        k *= 2


def block_sort_plain(cols, block: int, num_keys: int) -> None:
    """Plain version of block_sort: stages K = 2 .. block."""
    _plain_stages(cols, 2, block, num_keys)


def multi_stage_plain(cols, block: int, merge: int, num_keys: int) -> None:
    """Plain version of multi_stage: stages K = 2*block .. merge."""
    _plain_stages(cols, 2 * block, merge, num_keys)


def pair_cross_plain(cols, k: int, j: int, num_keys: int,
                     j_last: int | None = None) -> None:
    """Plain version of pair_cross: steps J = j .. j_last (default j) of
    stage k, in the kernel's tile form. Each column is viewed as
    (n / 2j, 2j / j_last, j_last): the group of rows whose indices differ
    only in the bits j_last .. j, the run (the group's member at distance
    j_last), the offset in the run. The step at distance J pairs runs
    J / j_last apart along the run axis. A pair's direction is that of its
    lower row's global index, whose bit k is its group base's: k lies above
    every J bit."""
    jl = j if j_last is None else j_last
    n = cols[0].numel()
    g, runs = n // (2 * j), 2 * j // jl
    base = torch.arange(g, device=cols[0].device, dtype=torch.int64) * (2 * j)
    asc = ((base & k) == 0).view(g, 1, 1, 1)
    d = runs // 2
    while d >= 1:
        views = [c.view(g, runs // (2 * d), 2, d, jl) for c in cols]
        lo = [v[:, :, 0] for v in views]
        hi = [v[:, :, 1] for v in views]
        swap = torch.where(asc, _lex_lt(hi[:num_keys], lo[:num_keys]),
                           _lex_lt(lo[:num_keys], hi[:num_keys]))
        for v, lw, h in zip(views, lo, hi):
            nl, nh = torch.where(swap, h, lw), torch.where(swap, lw, h)
            v[:, :, 0] = nl
            v[:, :, 1] = nh
        d //= 2


def block_merge_plain(cols, merge: int, k: int, num_keys: int) -> None:
    """Plain version of block_merge: steps J = merge/2 .. 1 of stage k."""
    j = merge // 2
    while j >= 1:
        _plain_step(cols, k, j, num_keys)
        j //= 2


def whole_sort_plain(cols, num_keys: int) -> None:
    """Plain version of whole_sort: every stage K = 2 .. n."""
    _plain_stages(cols, 2, cols[0].numel(), num_keys)


# --- wrappers ----------------------------------------------------------------

def block_sort_(cols, block: int, num_keys: int | None = None):
    """Sort every `block`-row block (top stage by block parity), in place."""
    nk, cuda = _check(cols, num_keys, block, smem_block=block)
    if cuda:
        _launch("block_sort", cols, nk, block)
    else:
        block_sort_plain(cols, block, nk)
    return cols


def multi_stage_(cols, block: int, merge: int, num_keys: int | None = None):
    """Stages 2*block .. merge inside every `merge`-row block, in place."""
    nk, cuda = _check(cols, num_keys, block, merge, smem_block=merge)
    if cuda:
        _launch("multi_stage", cols, nk, block, merge)
    else:
        multi_stage_plain(cols, block, merge, nk)
    return cols


def pair_cross_(cols, k: int, j: int, num_keys: int | None = None, *,
                j_last: int | None = None):
    """Steps J = j, j/2, .., j_last (default j: one step) of stage k in one
    launch, in place; at most cross_span(columns) steps."""
    jl = j if j_last is None else j_last
    nk, cuda = _check(cols, num_keys, 2 * j, jl)
    if k and (not is_po2(k) or k < 2 * j):
        raise BadArgsError(f"stage {k} must be 0 or a power of two >= 2*{j}")
    if jl > j or log2_floor(j // jl) >= cross_span(len(cols)):
        raise BadArgsError(f"steps {j} .. {jl}: j_last <= j, at most "
                           f"{cross_span(len(cols))} steps a launch")
    if cuda:
        _launch("pair_cross", cols, nk, k, j, jl)
    else:
        pair_cross_plain(cols, k, j, nk, jl)
    return cols


def block_merge_(cols, merge: int, k: int, num_keys: int | None = None):
    """Steps merge/2 .. 1 of stage k inside every `merge`-row block (k = 0:
    all ascending), in place."""
    nk, cuda = _check(cols, num_keys, merge, smem_block=merge)
    if k and (not is_po2(k) or k < merge):
        raise BadArgsError(f"stage {k} must be 0 or a power of two >= {merge}")
    if cuda:
        _launch("block_merge", cols, nk, merge, k)
    else:
        block_merge_plain(cols, merge, k, nk)
    return cols


def block_tiles():
    """Every (columns, tile rows) that _check admits for block_sort_,
    multi_stage_ (its merge tile) and block_merge_: power-of-two tiles whose
    columns fit SMEM_MAX."""
    for c in range(1, MAX_COLS + 1):
        length = 1
        while c * length * 4 <= SMEM_MAX:
            yield c, length
            length *= 2


def block_geometry(n_cols: int, length: int) -> tuple[int, int, int]:
    """(threads, rows per thread, shared-memory bytes) of a block_sort,
    multi_stage (at its merge tile) or block_merge tile of `length` rows
    (csrc/bitonic.cu block_rows and block_smem, which load_kernels checks
    against this): 32 rows a thread at 1-3 columns, 16 at 4, 8 at more, 1
    in tiles under 32 such threads; one pad word per 32 rows of a column,
    none at 7 columns (whose padded 8192-row tile would not fit
    SMEM_MAX)."""
    full = 32 if n_cols <= 3 else 16 if n_cols == 4 else 8
    rows = full if length >= 32 * full else 1
    shift = 31 if n_cols == 7 else 5
    return length // rows, rows, n_cols * (length + (length >> shift)) * 4


CROSS_TILE_BYTES = 96 * 1024  # csrc/bitonic.cu CROSS_TILE_BYTES


def cross_rows(n_cols: int) -> int:
    """Rows of a multi-step pair_cross tile at n_cols columns: the largest
    power of two whose columns fit CROSS_TILE_BYTES (csrc/bitonic.cu
    cross_rows)."""
    rows = 1
    while 2 * rows * n_cols * 4 <= CROSS_TILE_BYTES:
        rows *= 2
    return rows


def cross_span(n_cols: int) -> int:
    """Steps one pair_cross launch may take at n_cols columns (csrc/
    bitonic.cu cross_span, which load_kernels checks against this):
    log2(cross_rows / 32), so that the tile's gathered runs stay 32 rows (a
    128-byte line) or longer. 9 at one column, 6 at 8."""
    return log2_floor(cross_rows(n_cols) // 32)


def cross_passes(k: int, j_hi: int, m: int,
                 span: int) -> list[tuple[int, int]]:
    """The pair_cross launches (j, j_last) of stage k's cross steps
    J = j_hi .. m: runs of at most `span` steps, highest J first, so
    ceil(steps / span) of them (none when m > j_hi)."""
    if k and k < 2 * j_hi:
        raise BadArgsError(f"stage {k} below 2 x {j_hi}")
    runs = []
    j = j_hi
    while j >= m:
        jl = max(j >> (span - 1), m)
        runs.append((j, jl))
        j = jl // 2
    return runs


def whole_rows(n_cols: int) -> int:
    """Rows each whole_sort thread holds in registers at n_cols columns
    (csrc/bitonic.cu whole_rows): 16 int32 registers or fewer per thread."""
    return {1: 16, 2: 8, 3: 4, 4: 4}.get(n_cols, 2)


def whole_slice(n: int, n_cols: int) -> int:
    """Rows of each whole_sort block: n / WHOLE_BLOCKS, so that the slices
    spread over the card's SMs, but at least a warp's worth (32 x
    whole_rows) where n has them and at least sqrt(n) (a stage's gathered
    groups must fit one slice); then halved while the slice needs more
    than WHOLE_THREADS threads (so the largest arrays take 256 blocks, two
    per SM) or its padded columns more than one block's shared memory."""
    r = whole_rows(n_cols)
    s = max(n // WHOLE_BLOCKS, min(n, 32 * r), 1)
    while s * s < n:
        s *= 2
    while s > 1 and (s > WHOLE_THREADS * r
                     or n_cols * (s + s // 32) * 4 > SMEM_MAX):
        s //= 2
    return s


@functools.cache
def whole_geometry(n: int, n_cols: int) -> tuple[int, int]:
    """(slice, rows per thread) of a whole_sort launch over n rows: the
    rows are whole_rows(n_cols), or 1 in a slice under 32 x whole_rows
    rows (less than a warp of threads)."""
    s = whole_slice(n, n_cols)
    r = whole_rows(n_cols)
    return s, (r if s >= 32 * r else 1)


def whole_sort_(cols, num_keys: int | None = None):
    """Sort the columns ascending in one launch, in place. Raises
    BadArgsError past WHOLE_MAX (n x columns), and on the card when the
    grid cannot be co-resident; it never falls back to the fused
    schedule."""
    nk, cuda = _check(cols, num_keys)
    n = cols[0].numel()
    if n * len(cols) > WHOLE_MAX:
        raise BadArgsError(f"single-launch sort holds n x columns <= "
                           f"{WHOLE_MAX}, got {n} x {len(cols)}")
    if n <= 1:
        return cols
    if cuda:
        _launch("whole_sort", cols, nk, *whole_geometry(n, len(cols)))
    else:
        whole_sort_plain(cols, nk)
    return cols


# --- host schedules ----------------------------------------------------------

def bitonic_sort_2d(cols, *, block_elems: int, merge_elems: int,
                    num_keys: int | None = None,
                    single_launch: bool | None = None):
    """Sort power-of-two-length int32 columns ascending, in place.

    Named after its JAX counterpart; the columns here are 1-D. block_elems
    and merge_elems are clamped to the length (merge >= block).
    single_launch=True runs whole_sort_ instead (the geometry is then
    unused); None resolves to off, as in the JAX package. Returns the
    columns.
    """
    if single_launch:
        return whole_sort_(cols, num_keys)
    n = cols[0].numel()
    if n <= 1:
        return cols
    b = min(block_elems, n)
    m = max(min(merge_elems, n), b)
    block_sort_(cols, b, num_keys)
    if m > b:
        multi_stage_(cols, b, m, num_keys)
    span = cross_span(len(cols))
    for sk in range(log2_floor(m) + 1, log2_floor(n) + 1):
        k = 1 << sk
        for j, jl in cross_passes(k, k // 2, m, span):
            pair_cross_(cols, k, j, num_keys, j_last=jl)
        block_merge_(cols, m, k, num_keys)
    return cols


def bitonic_merge_2d(cols, *, merge_elems: int, num_keys: int | None = None):
    """Ascending merge of one whole bitonic sequence, in place (stage K = 0:
    every pair ascending). Used by the distributed sort."""
    n = cols[0].numel()
    if n <= 1:
        return cols
    m = min(merge_elems, n)
    for j, jl in cross_passes(0, n // 2, m, cross_span(len(cols))):
        pair_cross_(cols, 0, j, num_keys, j_last=jl)
    return block_merge_(cols, m, 0, num_keys)


def sbitonic_sort_2d(cols, *, num_keys: int | None = None):
    """Sort power-of-two-length int32 columns ascending, in place, with one
    pair_cross launch per network step (K, J): every stage K = 2 .. n, every
    J = K/2 .. 1 (the reference's simple bitonic, one work item per pair).
    The same network as bitonic_sort_2d, so the same output bit for bit.
    Returns the columns."""
    n = cols[0].numel()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            pair_cross_(cols, k, j, num_keys)
            j //= 2
        k *= 2
    return cols


def sbitonic_steps(n: int) -> int:
    """pair_cross launches of sbitonic_sort_2d."""
    lg = log2_floor(n) if n > 1 else 0
    return lg * (lg + 1) // 2


def sweeps(n: int, block_elems: int, merge_elems: int,
           n_cols: int = 1) -> dict[str, int]:
    """Launches of each fused-schedule kernel in bitonic_sort_2d over
    n_cols columns (each one sweep): the s-th stage above the merge block
    has s cross steps, in its cross_passes' ceil(s / cross_span)
    pair_cross launches."""
    if n <= 1:
        return dict.fromkeys(FUSED, 0)
    b = min(block_elems, n)
    m = max(min(merge_elems, n), b)
    stages = log2_floor(n) - log2_floor(m)
    span = cross_span(n_cols)
    cross = sum(len(cross_passes(m << s, m << (s - 1), m, span))
                for s in range(1, stages + 1))
    return {"block_sort": 1, "multi_stage": int(m > b), "pair_cross": cross,
            "block_merge": stages}


def fused_traffic_bytes(n_padded: int, n_arrays: int, block_elems: int,
                        merge_elems: int,
                        single_launch: bool | None = None) -> int:
    """Device-memory bytes bitonic_sort_2d moves: each launch reads and
    writes every column once (whole_sort: one launch)."""
    per = 2 * n_padded * 4 * n_arrays
    if single_launch:
        return per
    return per * sum(sweeps(n_padded, block_elems, merge_elems,
                            n_arrays).values())


def merge_traffic_bytes(n_padded: int, n_arrays: int,
                        merge_elems: int) -> int:
    """Device-memory bytes of bitonic_merge_2d (its pair_cross launches +
    one merge)."""
    per = 2 * n_padded * 4 * n_arrays
    passes = cross_passes(0, n_padded // 2, merge_elems,
                          cross_span(n_arrays))
    return (len(passes) + 1) * per


def pad_and_reshape(cols, pad_values):
    """Copy 1-D columns into fresh int32 buffers padded to a shared power of
    two with `pad_values`. Named after its JAX counterpart; nothing is
    reshaped here. Returns (columns, padded length)."""
    n = cols[0].numel()
    padded = nlpo2(n)
    out = []
    for c, pv in zip(cols, pad_values):
        buf = torch.empty(padded, dtype=torch.int32, device=c.device)
        buf[:n] = c
        buf[n:] = pv
        out.append(buf)
    return tuple(out), padded
