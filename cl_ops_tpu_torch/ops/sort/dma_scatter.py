"""Blocked run copy: the write half of a binned radix scatter.

Counterpart of `cl_ops_tpu/ops/sort/dma_scatter.py`. After a per-block
stable digit sort, every (block, digit) pair's rows form one contiguous run,
and the runs' destinations are contiguous too, so the scatter reduces to
copying runs of elements to computed offsets. `plan_run_chunks` cuts the
runs into CHUNK-element chunks with chunk-aligned destinations, and
`chunk_copy` moves them; the slack past each run's end becomes an i32-max
sentinel, so later passes can treat pads as largest-key rows.

The JAX kernel takes its sources as (rows, 128) tiles, a TPU layout; here
the columns stay flat 1-D int32 tensors. The table keeps the JAX layout
(block, row roll, lane shift) so that the two packages' tables compare bit
for bit. `chunk_copy` runs its plain PyTorch version on CPU tensors and
launches the CUDA kernel (`csrc/chunk_copy.cu`, replacing
`_chunk_copy_kernel`) on CUDA tensors, adding one to
`launches["chunk_copy"]` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.utils.platform import build_library

LANES = 128
C_ROWS = 8                # a chunk is C_ROWS x LANES elements in JAX's tiles
CHUNK = C_ROWS * LANES    # csrc/chunk_copy.cu CHUNK
_SENT = 0x7FFFFFFF
KERNELS = ("chunk_copy",)

# Kernel launches since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    launches["chunk_copy"] = 0


_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/chunk_copy.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("chunk_copy")
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        ptrs = ctypes.POINTER(p)
        ll = ctypes.c_longlong
        # (src, out, n_arrays, params, n_chunks, n_src, stream)
        lib.clo_chunk_copy.argtypes = [ptrs, ptrs, ctypes.c_int, p, ll, ll, p]
        lib.clo_chunk_copy.restype = ctypes.c_int
        lib.clo_chunk_copy_max_arrays.restype = ctypes.c_int
        _lib = lib
    return _lib


def plan_run_chunks(src_starts, dst_qstarts, lengths, *,
                    n_chunks_static: int) -> torch.Tensor:
    """Chunk table for `chunk_copy` from run metadata (element units).

    src_starts/lengths describe runs in the source; dst_qstarts are the
    CHUNK-aligned destination bases (the exclusive scan of
    ceil(lengths / CHUNK) * CHUNK). n_chunks_static bounds the chunks
    (total elements / CHUNK + runs covers any split). Unused chunk slots
    fill the leftover destination blocks with whole-sentinel chunks, so
    every output block is written exactly once. Returns the (5,
    n_chunks_static) int32 table [src block, row roll, lane shift, valid
    elements, dst block], equal to the JAX package's.
    """
    dev = lengths.device
    starts, qstarts, lens = (t.to(torch.int64) for t in
                             (src_starts, dst_qstarts, lengths))
    if lens.numel() == 0:  # one empty run: every chunk slot is unused
        starts = qstarts = lens = torch.zeros(1, dtype=torch.int64,
                                              device=dev)
    qchunks = (lens + CHUNK - 1) // CHUNK
    qend = torch.cumsum(qchunks, 0)
    qstart = qend - qchunks
    total_valid = qend[-1]
    c = torch.arange(n_chunks_static, dtype=torch.int64, device=dev)
    valid = c < total_valid
    run = torch.searchsorted(qend, c, right=True).clamp(max=qend.numel() - 1)
    within = c - qstart[run]
    src_elem = torch.where(valid, starts[run] + within * CHUNK, 0)
    rem = torch.where(valid, (lens[run] - within * CHUNK).clamp(0, CHUNK), 0)
    inv_rank = torch.cumsum((~valid).to(torch.int64), 0) - 1
    dst_blk = torch.where(valid, qstarts[run] // CHUNK + within,
                          total_valid + inv_rank)
    return torch.stack([src_elem // CHUNK, (src_elem % CHUNK) // LANES,
                        src_elem % LANES, rem, dst_blk]).to(torch.int32)


def _check(arrs, params, n_chunks: int) -> bool:
    """Validate chunk_copy's operands; returns whether they lie on the
    card."""
    if not arrs:
        raise BadArgsError("chunk_copy needs at least one array")
    n, dev = arrs[0].numel(), arrs[0].device
    for a in arrs:
        if a.dtype != torch.int32 or a.dim() != 1 or not a.is_contiguous():
            raise BadArgsError("chunk_copy arrays must be contiguous 1-D "
                               "int32")
        if a.numel() != n or a.device != dev:
            raise BadArgsError("chunk_copy arrays differ in length or device")
    if params.dtype != torch.int32 or params.shape != (5, n_chunks) \
            or not params.is_contiguous() or params.device != dev:
        raise BadArgsError(f"params must be a contiguous (5, {n_chunks}) "
                           "int32 tensor on the arrays' device")
    if dev.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {dev}")
    return dev.type == "cuda"


def chunk_copy_plain(arrs, params, n_chunks: int):
    """Plain version of chunk_copy: a gather by a built index, the sentinel
    by torch.where, and one indexed write of the chunks."""
    p = params.to(torch.int64)
    n_src, dev = arrs[0].numel(), arrs[0].device
    t = torch.arange(CHUNK, dtype=torch.int64, device=dev)
    idx = (p[0] * CHUNK + p[1] * LANES + p[2])[:, None] + t
    ok = (t < p[3][:, None]) & (idx >= 0) & (idx < n_src)
    keep = (p[4] >= 0) & (p[4] < n_chunks)
    outs = []
    for a in arrs:
        vals = torch.full_like(idx, _SENT, dtype=torch.int32) if n_src == 0 \
            else torch.where(ok, a[idx.clamp(0, n_src - 1)], _SENT)
        out = torch.full((n_chunks, CHUNK), _SENT, dtype=torch.int32,
                         device=dev)
        out[p[4][keep]] = vals[keep]
        outs.append(out.view(-1))
    return tuple(outs)


def chunk_copy(arrs, params, *, n_chunks: int):
    """Blocked-write scatter: move `n_chunks` CHUNK-element runs.

    arrs: tuple of 1-D int32 sources of one length (flat, where the JAX
    package takes (rows, 128) tiles). params: the (5, n_chunks) int32
    table of plan_run_chunks: chunk c copies its `rem` valid elements from
    src_elem = block * CHUNK + roll * 128 + shift to destination block dst
    and fills the rest of the block with the i32-max sentinel. Reads past
    the source give the sentinel; destinations must be a permutation of
    0..n_chunks-1 (every output block written exactly once). Returns one
    (n_chunks * CHUNK,) int32 tensor per array.
    """
    arrs = tuple(arrs)
    if not _check(arrs, params, n_chunks):
        return chunk_copy_plain(arrs, params, n_chunks)
    dev = arrs[0].device
    outs = tuple(torch.empty(n_chunks * CHUNK, dtype=torch.int32, device=dev)
                 for _ in arrs)
    if n_chunks == 0:
        return outs
    lib = load_kernels()
    per_launch = lib.clo_chunk_copy_max_arrays()
    with torch.cuda.device(dev):  # the library launches on it
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, len(arrs), per_launch):
            srcs, dsts = arrs[lo:lo + per_launch], outs[lo:lo + per_launch]
            k = len(srcs)
            err = lib.clo_chunk_copy(
                (ctypes.c_void_p * k)(*[a.data_ptr() for a in srcs]),
                (ctypes.c_void_p * k)(*[o.data_ptr() for o in dsts]), k,
                params.data_ptr(), n_chunks, arrs[0].numel(), stream)
            if err != 0:
                raise RuntimeError(f"CUDA kernel chunk_copy failed: error "
                                   f"{err}")
            launches["chunk_copy"] += 1
    return outs
