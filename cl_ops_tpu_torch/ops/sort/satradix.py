"""The "satradix" sorter: LSD radix sort (Satish et al.) on the rank_hist
kernel.

Counterpart of `cl_ops_tpu/ops/sort/satradix.py`, computing what it
computes. Limbs are taken least significant first; in each limb, one pass
per log2(radix)-bit digit of `limb ^ 0x80000000` (the key's unsigned bits),
shift 0, bits, ... < 32, so a 64-bit key at radix 16 takes 16 passes. One
pass is a stable partition by the digit:
  1. rank_hist_limb (CUDA kernel, radix_kernels.py): per tile of
     block_elems rows, the digit cut from the limb, each row's rank among
     the tile's rows with its digit and its bucket digit * n_blocks + tile,
     and the tile's digit histogram;
  2. the histogram flattened digit-major, counters[digit * n_blocks + tile],
     and its exclusive scan by a composed `scan_new(scan=...)` (torch);
  3. dest = base[bucket] + rank, a permutation (torch);
  4. placement of every column at dest.

Options: `radix=` bins per pass (a power of 2 in [2, 256], default 16),
`scan=` the composed scan impl (default "xla") with `scan<opt>=` passed
through to it, `block_elems=` the tile (default 8192; the JAX package's
`block_rows=8` is block_elems=1024), and `scatter=`:
  * "xla" (the port's default): a direct scatter of each column to dest,
    `index_copy_`; dest is a permutation, so it is deterministic.
  * "bitonic": place the rows by sorting (dest, columns...) through
    psort.sort_i32_cols, the JAX package's default. The TPU has no fast
    random store, so there a sort is the cheaper placement; the card has
    one, and a bitonic placement would make each of the 16 passes of a
    64-bit key a full sort of every column.
Both placements give the same rows. The sort is stable, so values ride in
input order among equal keys.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.scan import scan_new
from cl_ops_tpu_torch.ops.sort import radix_kernels as rk
from cl_ops_tpu_torch.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu_torch.utils.bits import is_po2, log2_floor

KERNEL_NAMES = ("rank_hist", "counters_scan", "scatter")


def pass_shifts(radix: int) -> list[int]:
    bits = log2_floor(radix)
    return list(range(0, 32, bits))


def satradix_traffic_bytes(n: int, n_limbs: int, has_payload: bool,
                           radix: int = 16) -> int:
    """Device-memory bytes of the port's passes over n rows: per pass,
    rank_hist_limb (read the 4-byte limb, write the rank and the bucket),
    the base gather (read 4, write 4), the rank add (read 8, write 4), the
    int64 dest (read 4, write 8) and, per column, the scatter (read the
    8-byte dest and 4 bytes, write 4). The histogram and its scan,
    n / block_elems * radix entries, are left out."""
    cols = n_limbs + int(has_payload)
    per_pass = 12 + 8 + 12 + 12 + 16 * cols
    return n_limbs * len(pass_shifts(radix)) * per_pass * n


def _make_satradix(spec, options):
    radix = int(options.get("radix", 16))
    if not is_po2(radix) or not 2 <= radix <= rk.MAX_RADIX:
        raise BadArgsError("radix must be a power of 2 in [2, 256]")
    block = int(options.get("block_elems", rk.BLOCK_ELEMS))
    rk.check_block_elems(block)
    scatter = options.get("scatter", "xla")
    if scatter not in ("xla", "bitonic"):
        raise BadArgsError("scatter= must be 'xla' or 'bitonic'")
    scan_opts = {k[4:]: v for k, v in options.items()
                 if k.startswith("scan") and k != "scan"}
    scanner = scan_new(options.get("scan", "xla"), scan_opts or None,
                       elem_dtype="int", sum_dtype="int")

    def radix_pass(cols, limb, shift):
        rank, bucket, hist = rk.rank_hist_limb(limb, shift, radix, block)
        # counters[digit * n_blocks + tile], then their exclusive scan
        base = scanner.scan_with_device_data(hist.t().reshape(-1))
        dest = base.index_select(0, bucket)
        dest += rank
        if scatter == "bitonic":
            return psort.sort_i32_cols((dest, *cols), num_keys=1,
                                       pad_safe=True)[1:]
        dest = dest.to(torch.int64)
        return [torch.empty_like(c).index_copy_(0, dest, c) for c in cols]

    def fn(limbs, payload):
        cols = list(limbs) + ([payload] if payload is not None else [])
        n = cols[0].numel()
        if n:
            # LSD: the least significant limb first (limbs are MSB first)
            for li in reversed(range(len(limbs))):
                for shift in pass_shifts(radix):
                    cols = radix_pass(cols, cols[li], shift)
        return (tuple(cols[:len(limbs)]),
                cols[len(limbs)] if payload is not None else None)
    return fn


def _smem_usage(kernel: str, numel: int, options: dict, n_arrays: int) -> int:
    """Dynamic shared memory per block of one pass's kernel, in bytes."""
    if kernel != "rank_hist":
        return 0
    return rk.smem_bytes(int(options.get("radix", 16)))


sort_impls.register("satradix")(lambda: SortImplDef(
    name="satradix",
    in_place=False,
    make_limb_sorter=_make_satradix,
    kernel_names=KERNEL_NAMES,
    smem_usage=_smem_usage,
))
