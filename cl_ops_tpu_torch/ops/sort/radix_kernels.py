"""The radix sorter's rank/histogram kernel: CUDA wrapper and plain version.

Counterpart of `_rank_hist_kernel` / `_rank_and_hist` in
`cl_ops_tpu/ops/sort/satradix.py`. `rank_hist(digits, radix, block_elems)`
cuts int32 digits into tiles of `block_elems` (the last one may be short)
and returns
  rank  int32 [n]                 count of earlier elements of the same tile
                                  with the same digit
  hist  int32 [n_blocks, radix]   each tile's count per digit bin
A digit outside [0, radix) matches no bin (rank 0, not counted), as the
TPU kernel's padding digit `radix` does.

The wrapper runs the plain PyTorch version on CPU tensors and launches the
CUDA kernel (`csrc/radix.cu`) on CUDA tensors, adding one to
`launches["rank_hist"]` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils.bits import cdiv, is_po2
from cl_ops_tpu_torch.utils.platform import build_library

KERNELS = ("rank_hist",)
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
        lib.clo_rank_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.clo_rank_hist.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes(radix: int, block_elems: int) -> int:
    """Dynamic shared memory of one rank_hist block: per-warp bin counts,
    and the tile's ranks (4 bytes) and bins (2 bytes)."""
    return WARPS * radix * 4 + block_elems * 6


def check_block_elems(block_elems: int) -> None:
    """A tile is WARPS runs of whole 32-digit rows, and fits shared memory."""
    if block_elems <= 0 or block_elems % (WARPS * 32) \
            or block_elems > MAX_BLOCK_ELEMS:
        raise BadArgsError(f"block_elems must be a positive multiple of "
                           f"{WARPS * 32} and <= {MAX_BLOCK_ELEMS}, got "
                           f"{block_elems}")


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


def rank_hist(digits: torch.Tensor, radix: int,
              block_elems: int = BLOCK_ELEMS):
    """(rank, hist) of int32 `digits` in tiles of `block_elems`."""
    if digits.dtype != torch.int32 or digits.dim() != 1 \
            or not digits.is_contiguous():
        raise BadArgsError("digits must be a contiguous 1-D int32 tensor")
    if not is_po2(radix) or not 2 <= radix <= MAX_RADIX:
        raise BadArgsError(f"radix must be a power of 2 in [2, {MAX_RADIX}]")
    check_block_elems(block_elems)
    if digits.device.type == "cpu":
        return rank_hist_plain(digits, radix, block_elems)
    if digits.device.type != "cuda":
        raise BadArgsError(f"unsupported device {digits.device}")
    n = digits.numel()
    rank = torch.empty_like(digits)
    hist = torch.empty((cdiv(n, block_elems), radix), dtype=torch.int32,
                       device=digits.device)
    if n == 0:
        return rank, hist
    dev = digits.device
    with torch.cuda.device(dev):  # the library launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = load_kernels().clo_rank_hist(
            digits.data_ptr(), rank.data_ptr(), hist.data_ptr(), n,
            block_elems, radix, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel rank_hist failed: error {err}")
    launches["rank_hist"] += 1
    return rank, hist
