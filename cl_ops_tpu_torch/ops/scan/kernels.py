"""Prefix sums: scan_1d on the scan_carry and scan_block kernels; the
filter's stable partition on scan_carry's look-back.

Counterpart of `cl_ops_tpu/ops/scan/kernels.py`. Two designs, four CUDA
kernels in `csrc/scan.cu`:

  * single pass (`single_pass=True`, integer sums): scan_carry, a decoupled
    look-back, in two forms: 32-bit sums mod 2^32 ("scan_carry", replacing
    `_scan_carry_kernel`) and 64-bit sums mod 2^64 ("scan_carry_wide",
    replacing `_wide_scan_carry_kernel`, on native 64-bit integers instead
    of two limbs). One read and one write per element, in 64 KB tiles
    (CARRY_TILE elements) of 16-byte loads, with a status word per tile
    that packs flag and value. The segmented scan (`segmented.py`,
    SEG_TILE-element tiles) runs on the same design.
  * 3-phase (`single_pass=False`, and every float32 sum, as in JAX): the
    per-tile sums and their exclusive scan are glue in plain torch
    (phases 1-2), then scan_block scans every TILE-element tile and adds
    its precomputed base (phase 3): "scan_block" for 32-bit integer sums
    mod 2^32 and float32 sums (replacing `_scan_block_kernel`),
    "scan_block_wide" for 64-bit sums mod 2^64 (replacing
    `_wide_scan_block_kernel`), which widens 32-bit input on load. The
    input is read twice (block sums, kernel) and the sums written once.

`partition` (filter_compact's compaction; no Pallas counterpart) moves
columns of any width with the kept rows first and the dropped rows after
them, both in their original order: two launches of `csrc/scan.cu`, the
kept rows a tile with their exclusive prefix by look-back, then the ranked
move of up to PART_MAX_COLS columns (one more launch for each further
PART_MAX_COLS).

The look-back kernels share one status buffer per (device, stream),
zeroed when it is made; each call's last block clears what the call used,
so no call zeroes it.

float64 sums are a plain torch.cumsum, as the JAX package leaves them to
XLA. float16/bfloat16 sum types are computed in float32 and rounded at the
end (JAX sums in the narrow type). The float32 tile bases are a float64
cumsum of float32 tile sums (JAX: a float32 cumsum), so float32 results
differ from JAX's by rounding; integer sums are exact.

Each kernel wrapper runs its plain PyTorch version on CPU tensors and
launches its kernel on CUDA tensors, adding one to `launches[<name>]` per
launch.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.bits import cdiv
from cl_ops_tpu_torch.utils.platform import build_library, launch_stream

KERNELS = ("scan_carry", "scan_carry_wide", "scan_block", "scan_block_wide",
           "partition")
TILE = 4096    # elements per tile of scan_block: csrc/scan.cu TILE
THREADS = 512  # csrc/scan.cu THREADS (and C_THREADS)
WARPS = THREADS // 32
# scan_carry's elements per 64 KB tile by value bytes: csrc/scan.cu
# C_TILE_BYTES / value_bytes; its dynamic shared memory is one tile
CARRY_TILE_BYTES = 64 * 1024
CARRY_TILE = {4: CARRY_TILE_BYTES // 4, 8: CARRY_TILE_BYTES // 8}
# seg_scan_carry's threads and elements per tile (csrc/scan.cu S_THREADS,
# S_TILE); its dynamic shared memory is the tile's values and flags
SEG_THREADS = 256
SEG_TILE = 8192
# partition's rows a tile, tiles a count block and columns a move launch
# (csrc/scan.cu P_TILE, P_GROUP, P_MAX_COLS)
PART_TILE = 8192
PART_GROUP = 8
PART_MAX_COLS = 8

# Kernel launches per wrapper since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


# --- the CUDA library --------------------------------------------------------

_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/scan.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("scan")
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.clo_scan_carry_status_bytes.argtypes = [ll, i]
        lib.clo_scan_carry_status_bytes.restype = ll
        lib.clo_scan_carry_tile.argtypes = [i]
        lib.clo_scan_carry_tile.restype = i
        lib.clo_seg_scan_status_bytes.argtypes = [ll]
        lib.clo_seg_scan_status_bytes.restype = ll
        lib.clo_seg_scan_tile.restype = i
        # (x, out, n, value_bytes, exclusive, status, stream)
        lib.clo_scan_carry.argtypes = [p, p, ll, i, i, p, p]
        lib.clo_scan_carry.restype = i
        # (x, flags, out, n, is_float, op, exclusive, status, stream)
        lib.clo_seg_scan_carry.argtypes = [p, p, p, ll, i, i, i, p, p]
        lib.clo_seg_scan_carry.restype = i
        # (x, base, out, n, kind, exclusive, stream)
        lib.clo_scan_block.argtypes = [p, p, p, ll, i, i, p]
        lib.clo_scan_block.restype = i
        lib.clo_scan_tile.restype = i
        for fn in (lib.clo_partition_tile, lib.clo_partition_group,
                   lib.clo_partition_max_cols):
            fn.restype = i
        lib.clo_partition_status_bytes.argtypes = [ll]
        lib.clo_partition_status_bytes.restype = ll
        # (mask, n, base, count, status, stream)
        lib.clo_partition_count.argtypes = [p, ll, p, p, p, p]
        lib.clo_partition_count.restype = i
        # (mask, n, base, count, ins, outs, widths, n_cols, stream)
        lib.clo_partition_move.argtypes = [
            p, ll, p, p, ctypes.POINTER(p), ctypes.POINTER(p),
            ctypes.POINTER(i), i, p]
        lib.clo_partition_move.restype = i
        n = (1 << 20) + 1
        if lib.clo_scan_tile() != TILE or any(
                lib.clo_scan_carry_tile(b) != t
                or lib.clo_scan_carry_status_bytes(n, b)
                != carry_status_bytes(n, b)
                for b, t in CARRY_TILE.items()) \
                or lib.clo_seg_scan_tile() != SEG_TILE \
                or lib.clo_seg_scan_status_bytes(n) != seg_status_bytes(n) \
                or (lib.clo_partition_tile(), lib.clo_partition_group(),
                    lib.clo_partition_max_cols()) != (
                        PART_TILE, PART_GROUP, PART_MAX_COLS) \
                or lib.clo_partition_status_bytes(n) \
                != partition_status_bytes(n):
            raise RuntimeError("csrc/scan.cu tile or status sizes differ "
                               "from kernels.TILE / CARRY_TILE / SEG_TILE / "
                               "PART_*")
        _lib = lib
    return _lib


# The look-back status of scan_carry and seg_scan_carry, one buffer per
# (device, stream): a kernel's last block clears what its call used, so the
# next call on the same stream finds it zeroed; a new or larger buffer
# starts zeroed.
_status: dict[tuple[int, int], torch.Tensor] = {}


def carry_status_bytes(n: int, value_bytes: int) -> int:
    """csrc/scan.cu carry_status_bytes: a 16-byte ticket and tile count,
    then 2 * value_bytes per tile."""
    return 16 + 2 * value_bytes * cdiv(n, CARRY_TILE[value_bytes])


def seg_status_bytes(n: int) -> int:
    """csrc/scan.cu clo_seg_scan_status_bytes: a 16-byte ticket and tile
    count, then one 8-byte word per tile."""
    return 16 + 8 * cdiv(n, SEG_TILE)


def partition_status_bytes(n: int) -> int:
    """csrc/scan.cu clo_partition_status_bytes: a 16-byte ticket and block
    count, then one 8-byte word per count block of PART_GROUP tiles."""
    return 16 + 8 * cdiv(cdiv(n, PART_TILE), PART_GROUP)


def _status_for(dev: torch.device, stream: int, need: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _status.get(key)
    if buf is None or buf.numel() < need:
        size = max(need, 2 * buf.numel()) if buf is not None else need
        buf = torch.zeros(size, dtype=torch.uint8, device=dev)
        _status[key] = buf
    return buf


def run_kernel(fn_name: str, dev: torch.device, *args,
               status_bytes: int = 0) -> None:
    """Call `fn_name`(*args, stream) of the scan library on `dev`'s current
    stream; status_bytes > 0 passes that stream's cached look-back status
    buffer (at least that large) before the stream."""
    lib = _lib or load_kernels()
    here = dev.index == torch.cuda.current_device()
    # the library launches on the current device
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        stream = launch_stream(dev)
        if status_bytes:
            args += (_status_for(dev, stream, status_bytes).data_ptr(),)
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn_name} failed: error {err}")


def check_1d(x: torch.Tensor, dtypes) -> bool:
    """Validate a kernel operand; returns whether it lies on the card."""
    if x.dim() != 1 or not x.is_contiguous() or x.dtype not in dtypes:
        raise BadArgsError(f"expected a contiguous 1-D tensor of {dtypes}, "
                           f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def smem_bytes(kernel: str, value_bytes: int) -> int:
    """Shared memory per block of a scan kernel (csrc/scan.cu), for values
    of value_bytes: static, plus the look-back kernels' dynamic tile."""
    if kernel in ("scan_carry", "scan_carry_wide"):
        # tile ticket, warp totals, and the tile itself (dynamic)
        return 4 + WARPS * value_bytes + CARRY_TILE_BYTES
    if kernel == "seg_scan_carry":
        # tile ticket, warp values and flags, and the tile's values and
        # flags (dynamic)
        return (4 + SEG_THREADS // 32 * (value_bytes + 4)
                + SEG_TILE * (value_bytes + 4))
    if kernel in ("scan_block", "scan_block_wide"):
        return WARPS * value_bytes            # warp totals
    raise BadArgsError(f"unknown scan kernel {kernel!r}")


# --- single pass: scan_carry -----------------------------------------------------

def scan_carry_plain(x: torch.Tensor, exclusive: bool) -> torch.Tensor:
    """Plain version of scan_carry: prefix sums mod 2^32 (int32) or 2^64
    (int64)."""
    return intmath.cumsum(x, exclusive)


def scan_carry(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Inclusive (or exclusive) prefix sums of an int32 or int64 tensor,
    mod 2^32 or 2^64 (unsigned data goes in as its signed view)."""
    if not check_1d(x, (torch.int32, torch.int64)):
        return scan_carry_plain(x, exclusive)
    out = torch.empty_like(x)
    if x.numel():
        run_kernel("clo_scan_carry", x.device, x.data_ptr(), out.data_ptr(),
                   x.numel(), x.element_size(), int(exclusive),
                   status_bytes=carry_status_bytes(x.numel(),
                                                   x.element_size()))
        launches["scan_carry" if x.dtype == torch.int32
                 else "scan_carry_wide"] += 1
    return out


# --- 3-phase: scan_block ---------------------------------------------------------

def _int_block_plain(xw: torch.Tensor, base: torch.Tensor,
                     exclusive: bool) -> torch.Tensor:
    """Per-tile prefix sums plus base[tile], mod 2^bits of xw's dtype: the
    in-tile sum is the global prefix sum less its value before the tile,
    which is exact for wrapping integers."""
    n = xw.numel()
    if n == 0:
        return xw.clone()
    g = intmath.cumsum(xw)
    heads = torch.arange(cdiv(n, TILE), device=xw.device) * TILE
    before = intmath.sub(g[heads], xw[heads])
    tile = torch.arange(n, device=xw.device) // TILE
    r = intmath.add(intmath.sub(g, before[tile]), base[tile])
    return intmath.sub(r, xw) if exclusive else r


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """x as (tiles, TILE) rows, the ragged tail padded with zeros."""
    pad = cdiv(x.numel(), TILE) * TILE - x.numel()
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    return x.view(-1, TILE)


def scan_block_plain(x: torch.Tensor, base: torch.Tensor,
                     exclusive: bool) -> torch.Tensor:
    """Plain version of scan_block: int32 (u32 bits, sums mod 2^32) or
    float32 per-tile sums plus base[tile]."""
    if x.dtype == torch.int32:
        return _int_block_plain(x, base, exclusive)
    t = _tiles(x)
    r = torch.cumsum(t, 1) + base[:, None]
    if exclusive:
        r = r - t
    return r.reshape(-1)[:x.numel()]


def scan_block_wide_plain(x: torch.Tensor, base: torch.Tensor,
                          exclusive: bool) -> torch.Tensor:
    """Plain version of scan_block_wide: 64-bit per-tile sums mod 2^64 plus
    base[tile] (int64 bits) of int32 (sign-extended), uint32
    (zero-extended) or 64-bit input."""
    return _int_block_plain(intmath.astype(x, torch.int64)
                            if x.dtype.itemsize == 4 else signed_view(x),
                            base, exclusive)


def _check_base(x: torch.Tensor, base: torch.Tensor, dtype) -> None:
    if base.dtype != dtype or base.dim() != 1 or not base.is_contiguous() \
            or base.numel() != cdiv(x.numel(), TILE) \
            or base.device != x.device:
        raise BadArgsError(f"base must be a contiguous {dtype} tensor with "
                           "one entry per tile, on x's device")


def scan_block(x: torch.Tensor, base: torch.Tensor,
               exclusive: bool = False) -> torch.Tensor:
    """Per-tile inclusive (or exclusive) prefix sums of an int32 (sums mod
    2^32) or float32 tensor plus base[tile], one base per TILE elements
    (same dtype as x)."""
    cuda = check_1d(x, (torch.int32, torch.float32))
    _check_base(x, base, x.dtype)
    if not cuda:
        return scan_block_plain(x, base, exclusive)
    out = torch.empty_like(x)
    if x.numel():
        run_kernel("clo_scan_block", x.device, x.data_ptr(),
                     base.data_ptr(), out.data_ptr(), x.numel(),
                     int(x.dtype == torch.float32), int(exclusive))
        launches["scan_block"] += 1
    return out


_WIDE_KIND = {torch.int32: 2, torch.uint32: 3, torch.int64: 4,
              torch.uint64: 4}


def scan_block_wide(x: torch.Tensor, base: torch.Tensor,
                    exclusive: bool = False) -> torch.Tensor:
    """Per-tile 64-bit prefix sums mod 2^64 plus base[tile] (int64 bits,
    one per TILE elements); int32 input sign-extends, uint32 zero-extends.
    Returns int64 bits."""
    cuda = check_1d(x, tuple(_WIDE_KIND))
    _check_base(x, base, torch.int64)
    if not cuda:
        return scan_block_wide_plain(x, base, exclusive)
    out = torch.empty(x.numel(), dtype=torch.int64, device=x.device)
    if x.numel():
        run_kernel("clo_scan_block", x.device, x.data_ptr(),
                     base.data_ptr(), out.data_ptr(), x.numel(),
                     _WIDE_KIND[x.dtype], int(exclusive))
        launches["scan_block_wide"] += 1
    return out


def _tile_bases(x: torch.Tensor, work: torch.dtype) -> torch.Tensor:
    """Phases 1-2: each tile's sum, then their exclusive scan, in `work`
    (int32 for sums mod 2^32, int64 for sums mod 2^64, float32)."""
    full = x.numel() // TILE * TILE
    parts = [x[:full].view(-1, TILE)]
    if full < x.numel():
        parts.append(x[full:].view(1, -1))
    if work == torch.float32:
        sums = torch.cat([p.sum(1) for p in parts]).to(torch.float64)
        return (torch.cumsum(sums, 0) - sums).to(torch.float32)
    sums = []
    for p in parts:
        if p.dtype.itemsize == 8:
            sums.append(intmath.row_sums(signed_view(p)))
        else:  # exact in int64; uint32 counts 2^32 per negative signed view
            s = signed_view(p).sum(1)
            if p.dtype == torch.uint32:
                s = s + (signed_view(p) < 0).sum(1) * (1 << 32)
            sums.append(s)
    sums = torch.cat(sums)
    if work == torch.int32:
        sums = intmath.wrap(sums, torch.int32)
    return intmath.cumsum(sums, exclusive=True)


def _three_phase(x: torch.Tensor, sd: torch.dtype,
                 exclusive: bool) -> torch.Tensor:
    if not intmath.is_int(sd):
        xf = x if x.dtype == torch.float32 else x.to(torch.float32)
        xf = xf.contiguous()
        res = scan_block(xf, _tile_bases(xf, torch.float32), exclusive)
        return res if sd == torch.float32 else res.to(sd)
    if sd.itemsize == 8:
        xk = x
        if x.dtype.itemsize < 4:
            xk = intmath.astype(x, torch.uint32 if intmath.is_unsigned(
                x.dtype) else torch.int32)
        xk = xk.contiguous()
        return scan_block_wide(xk, _tile_bases(xk, torch.int64),
                               exclusive).view(sd)
    xw = intmath.astype(x, torch.int32).contiguous()
    res = scan_block(xw, _tile_bases(xw, torch.int32), exclusive)
    return intmath.astype(res.view(torch.uint32) if intmath.is_unsigned(sd)
                          else res, sd)


# --- scan_1d -------------------------------------------------------------------

def scan_traffic_bytes(n: int, sum_dtype, *, single_pass: bool = True,
                       elem_dtype=None) -> int:
    """Bytes the kernels of scan_1d move, 4 or 8 per element and per pass.

    Single pass (integer sums): one read of the converted input and one
    write of the sums. 3-phase (single_pass=False, and float sums): the
    block sums read the input once, scan_block reads it again and writes
    the sums. elem_dtype sets the 3-phase input width (default: the
    sum's): 8-byte integers stay 8 bytes, everything else is read as 4.
    """
    sd = canonicalize(sum_dtype)
    ss = 8 if sd.itemsize == 8 else 4
    if single_pass and intmath.is_int(sd):
        return n * 2 * ss
    ed = sd if elem_dtype is None else canonicalize(elem_dtype)
    es = 8 if intmath.is_int(ed) and ed.itemsize == 8 else 4
    return n * (2 * es + ss)


def scan_1d(x: torch.Tensor, *, sum_dtype, exclusive: bool = True,
            single_pass: bool = False) -> torch.Tensor:
    """Prefix sum over a 1-D tensor, in `sum_dtype`.

    Integer sums wrap mod 2^bits of sum_dtype (inputs convert as numpy's
    astype does); exclusive=False gives the inclusive form. single_pass
    picks the scan_carry kernel for integer sums; float sums always take
    the 3-phase path; float64 sums are a torch.cumsum. The JAX options
    block_rows and interpret are TPU tiling and Pallas settings with no
    counterpart here.
    """
    if x.dim() != 1:
        raise BadArgsError(f"scan_1d expects 1-D input, got {tuple(x.shape)}")
    sd = canonicalize(sum_dtype)
    if sd == torch.float64:
        xs = x.to(torch.float64)
        acc = torch.cumsum(xs, 0)
        return acc - xs if exclusive else acc
    if not intmath.is_int(sd):
        return _three_phase(x, sd, exclusive)
    if not intmath.is_int(x.dtype):
        raise BadDtypeError(f"integer sums take integer input, got {x.dtype}")
    if not single_pass:
        return _three_phase(x, sd, exclusive)
    wide = sd.itemsize == 8
    work = torch.int64 if wide else torch.int32
    res = scan_carry(intmath.astype(x, work).contiguous(), exclusive)
    if wide:
        return res.view(sd)
    # the sums are u32 bits for unsigned sum types, i32 values otherwise
    return intmath.astype(res.view(torch.uint32) if intmath.is_unsigned(sd)
                          else res, sd)


# --- partition: the filter's stable partition -------------------------------------

# The integer type of each column width: the plain version scatters bits.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def partition_traffic_bytes(n: int, col_bytes) -> int:
    """Bytes partition moves for n rows of columns `col_bytes` wide: the
    mask read once by the count launch and once by each move launch, every
    column read once and written once."""
    moves = cdiv(len(col_bytes), PART_MAX_COLS)
    return n * ((1 + moves) + 2 * sum(col_bytes))


def partition_plain(mask: torch.Tensor, cols) -> tuple:
    """Plain version of partition: rank = exclusive cumsum of keep; kept row
    i goes to rank[i], dropped row i to count + i - rank[i]."""
    keep = mask != 0
    k = keep.to(torch.int64)
    count = k.sum()
    rank = torch.cumsum(k, 0) - k
    pos = torch.arange(k.numel(), device=k.device)
    dest = torch.where(keep, rank, count + pos - rank)
    outs = []
    for c in cols:
        out = torch.empty_like(c)
        bits = _BITS[c.element_size()]
        out.view(bits)[dest] = c.view(bits)
        outs.append(out)
    return (count, *outs)


def partition(mask: torch.Tensor, cols) -> tuple:
    """Stable partition of `cols` by `mask` (bool, or nonzero bytes: kept).

    Returns (count, *moved): count, a 0-d int64 tensor on the mask's
    device, is the kept rows' number; each moved column holds the kept rows
    first and the dropped rows after them, both in their original order.
    Columns are contiguous 1-D tensors of 1, 2, 4 or 8 bytes an element,
    as long as the mask and on its device; each moves at its own width."""
    cuda = check_1d(mask, (torch.bool, torch.uint8))
    n = mask.numel()
    for c in cols:
        if c.dim() != 1 or not c.is_contiguous() or c.numel() != n \
                or c.device != mask.device \
                or c.element_size() not in _BITS:
            raise BadArgsError("partition takes contiguous 1-D columns of "
                               "1, 2, 4 or 8 bytes, as long as the mask "
                               "and on its device")
    if not cuda:
        return partition_plain(mask, cols)
    outs = tuple(torch.empty_like(c) for c in cols)
    if n == 0:
        return (torch.zeros((), dtype=torch.int64, device=mask.device), *outs)
    count = torch.empty((), dtype=torch.int64, device=mask.device)
    base = torch.empty(cdiv(n, PART_TILE), dtype=torch.int32,
                       device=mask.device)
    m8 = mask.view(torch.uint8)
    run_kernel("clo_partition_count", mask.device, m8.data_ptr(), n,
               base.data_ptr(), count.data_ptr(),
               status_bytes=partition_status_bytes(n))
    launches["partition"] += 1
    for at in range(0, len(cols), PART_MAX_COLS):
        group = range(at, min(at + PART_MAX_COLS, len(cols)))
        k = len(group)
        ins = (ctypes.c_void_p * k)(*(cols[g].data_ptr() for g in group))
        dst = (ctypes.c_void_p * k)(*(outs[g].data_ptr() for g in group))
        widths = (ctypes.c_int * k)(*(cols[g].element_size() for g in group))
        run_kernel("clo_partition_move", mask.device, m8.data_ptr(), n,
                   base.data_ptr(), count.data_ptr(), ins, dst, widths, k)
        launches["partition"] += 1
    return (count, *outs)
