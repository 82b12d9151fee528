"""The radix sorter's rank/histogram kernel: CUDA wrappers and plain versions.

Counterpart of `_rank_hist_kernel` / `_rank_and_hist` in
`cl_ops_tpu/ops/sort/satradix.py`. `rank_hist(digits, radix, block_elems)`
cuts int32 digits into tiles of `block_elems` (the last one may be short)
and returns
  rank  int32 [n]                 count of earlier elements of the same tile
                                  with the same digit
  hist  int32 [n_blocks, radix]   each tile's count per digit bin
A digit outside [0, radix) matches no bin (rank 0, not counted), as the
TPU kernel's padding digit `radix` does.

`rank_hist_limb(limb, shift, radix, block_elems)` is the sorter's pass: the
same kernel cuts each digit from an int32 key limb, as `radix_digits` does,
and returns (rank, bucket, hist), where bucket = digit * n_blocks + tile,
the index of the element's counter in the digit-major scan.

The wrappers run the plain PyTorch versions on CPU tensors and launch the
CUDA kernel (`csrc/radix.cu`) on CUDA tensors. `launches["rank_hist"]`
counts every launch of the kernel, from either entry point;
`launches["rank_hist_limb"]` those of `rank_hist_limb`.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils.bits import cdiv, is_po2, log2_floor
from cl_ops_tpu_torch.utils.platform import build_library, launch_stream

KERNELS = ("rank_hist", "rank_hist_limb")
WARPS = 16             # csrc/radix.cu WARPS: a tile is cut into 16 runs
MAX_RADIX = 256
BLOCK_ELEMS = 8192     # the tile the sorter uses by default
MAX_BLOCK_ELEMS = 1 << 14

# Kernel launches since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/radix.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("radix")
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clo_rank_hist.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
        lib.clo_rank_hist.restype = i
        # (limb, shift, rank, bucket, hist, n, tile, radix, stream)
        lib.clo_rank_hist_limb.argtypes = [p, i, p, p, p, ctypes.c_longlong,
                                           i, i, p]
        lib.clo_rank_hist_limb.restype = i
        _lib = lib
    return _lib


def smem_bytes(radix: int) -> int:
    """Dynamic shared memory of one rank_hist block: the per-warp bin
    counts (ranks and digits stay in registers)."""
    return WARPS * radix * 4


def check_block_elems(block_elems: int) -> None:
    """A tile is WARPS runs of whole 32-digit rows, at most 32 rows a run."""
    if block_elems <= 0 or block_elems % (WARPS * 32) \
            or block_elems > MAX_BLOCK_ELEMS:
        raise BadArgsError(f"block_elems must be a positive multiple of "
                           f"{WARPS * 32} and <= {MAX_BLOCK_ELEMS}, got "
                           f"{block_elems}")


def _check(t: torch.Tensor, what: str, radix: int, block_elems: int) -> bool:
    """Validate the operands; returns whether they lie on the card."""
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise BadArgsError(f"{what} must be a contiguous 1-D int32 tensor")
    if not is_po2(radix) or not 2 <= radix <= MAX_RADIX:
        raise BadArgsError(f"radix must be a power of 2 in [2, {MAX_RADIX}]")
    check_block_elems(block_elems)
    if t.device.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def radix_digits(limb: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """Digit `bits` wide at `shift` of the limb's unsigned bits,
    limb ^ 0x80000000, from int32 arithmetic: the arithmetic shift's sign
    copies fall outside the mask, and the flipped sign bit is the digit's
    top bit in the limb's last digit."""
    d = limb >> shift if shift else limb
    d = d & (((1 << bits) - 1) & ((1 << (32 - shift)) - 1))
    if shift + bits >= 32:
        d = d ^ (1 << (31 - shift))
    return d


def rank_hist_plain(digits: torch.Tensor, radix: int, block_elems: int):
    """Plain version of rank_hist: for each bin, a per-tile cumulative count
    of the digit's matches (the TPU kernel's per-bin block scans)."""
    n = digits.numel()
    n_blocks = cdiv(n, block_elems)
    d = torch.full((n_blocks * block_elems,), radix, dtype=torch.int32,
                   device=digits.device)
    d[:n] = digits
    d = d.view(n_blocks, block_elems)
    rank = torch.zeros_like(d)
    hist = torch.empty((n_blocks, radix), dtype=torch.int32,
                       device=digits.device)
    for b in range(radix):
        mask = (d == b).to(torch.int32)
        incl = torch.cumsum(mask, 1, dtype=torch.int32)
        rank += (incl - mask) * mask
        hist[:, b] = incl[:, -1]
    return rank.view(-1)[:n], hist


def rank_hist_limb_plain(limb: torch.Tensor, shift: int, radix: int,
                         block_elems: int):
    """Plain version of rank_hist_limb: radix_digits, rank_hist_plain and
    the bucket digit * n_blocks + tile."""
    digits = radix_digits(limb, shift, log2_floor(radix))
    rank, hist = rank_hist_plain(digits, radix, block_elems)
    tile = torch.div(torch.arange(limb.numel(), dtype=torch.int32,
                                  device=limb.device),
                     block_elems, rounding_mode="floor")
    return rank, torch.add(tile, digits, alpha=hist.shape[0]), hist


def _launch(fn, args, n, radix, block_elems, dev):
    here = dev.index == torch.cuda.current_device()
    # the library launches on the current device
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        err = fn(*args, n, block_elems, radix, launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"CUDA kernel rank_hist failed: error {err}")
    launches["rank_hist"] += 1


def rank_hist(digits: torch.Tensor, radix: int,
              block_elems: int = BLOCK_ELEMS):
    """(rank, hist) of int32 `digits` in tiles of `block_elems`."""
    if not _check(digits, "digits", radix, block_elems):
        return rank_hist_plain(digits, radix, block_elems)
    n = digits.numel()
    rank = torch.empty_like(digits)
    hist = torch.empty((cdiv(n, block_elems), radix), dtype=torch.int32,
                       device=digits.device)
    if n:
        _launch(load_kernels().clo_rank_hist,
                (digits.data_ptr(), rank.data_ptr(), hist.data_ptr()), n,
                radix, block_elems, digits.device)
    return rank, hist


def rank_hist_limb(limb: torch.Tensor, shift: int, radix: int,
                   block_elems: int = BLOCK_ELEMS):
    """(rank, bucket, hist) of the `log2(radix)`-bit digit at `shift` of
    the int32 key limb's unsigned bits, in tiles of `block_elems`."""
    on_card = _check(limb, "limb", radix, block_elems)
    if not 0 <= shift < 32:
        raise BadArgsError(f"shift must be in [0, 32), got {shift}")
    n = limb.numel()
    n_blocks = cdiv(n, block_elems)
    if n_blocks * radix > 2 ** 31:
        raise BadArgsError(f"{n} rows at radix {radix}: buckets past int32")
    if not on_card:
        return rank_hist_limb_plain(limb, shift, radix, block_elems)
    rank = torch.empty_like(limb)
    bucket = torch.empty_like(limb)
    hist = torch.empty((n_blocks, radix), dtype=torch.int32,
                       device=limb.device)
    if n:
        _launch(load_kernels().clo_rank_hist_limb,
                (limb.data_ptr(), shift, rank.data_ptr(), bucket.data_ptr(),
                 hist.data_ptr()), n, radix, block_elems, limb.device)
        launches["rank_hist_limb"] += 1
    return rank, bucket, hist
