"""The "abitonic" sorter: the fused bitonic schedule and its geometry.

Counterpart of the abitonic impl in `cl_ops_tpu/ops/sort/bitonic.py`. The
geometry is a shared-memory model: the merge block M is the largest power of
two whose columns fit the per-block budget (SMEM_BUDGET, all of the 227 KB
one Hopper block may use), and the sort block is B = M / 4. Both are clamped to the
padded length. Options `block_elems=` and `merge_elems=` override them.

Not in this package yet: "sbitonic" (its single-step and cross kernels), and
the options `single_launch=1` and `autotune=1`, which raise BadArgsError.
"""

from __future__ import annotations

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu_torch.utils.bits import is_po2, nlpo2

# i32 max: pads sort after every real key; pad payloads also get this value.
_PAD = 0x7FFFFFFF

# Dynamic shared memory per block that the geometry fills by default: all of
# what Hopper lets one block use (232,448 bytes). A smaller budget would let
# two blocks share an SM, at the price of more device-memory sweeps.
SMEM_BUDGET = bk.SMEM_MAX


def pick_merge_elems(n_arrays: int) -> int:
    """Largest power of two M with n_arrays * M * 4 bytes <= SMEM_BUDGET."""
    m = 2
    while n_arrays * (m * 2) * 4 <= SMEM_BUDGET:
        m *= 2
    return m


def pick_block_elems(merge_elems: int) -> int:
    """The sort block: a quarter of the merge block."""
    return max(merge_elems // 4, 1)


def reject_unported(options: dict) -> None:
    for opt in ("single_launch", "autotune"):
        if options.get(opt) == "1":
            raise BadArgsError(f"option {opt}=1 is not available in the "
                               "CUDA port yet")


def resolve_geometry(n_padded: int, n_arrays: int,
                     options: dict | None = None) -> tuple[int, int]:
    """(block_elems, merge_elems) for a padded problem: options first, then
    the shared-memory model; clamped to n_padded with merge >= block."""
    options = options or {}
    m = int(options.get("merge_elems", pick_merge_elems(n_arrays)))
    b = int(options.get("block_elems", pick_block_elems(m)))
    if not (is_po2(b) and is_po2(m)):
        raise BadArgsError("block_elems and merge_elems must be powers of 2")
    b = min(b, n_padded)
    return b, max(min(m, n_padded), b)


def abitonic_traffic_bytes(n: int, n_arrays: int,
                           options: dict | None = None) -> int:
    """Bytes-moved model of one abitonic sort call: the fused schedule's
    launches plus the padded copy (read n, write padded)."""
    padded = nlpo2(n)
    b, m = resolve_geometry(padded, n_arrays, options)
    return bk.fused_traffic_bytes(padded, n_arrays, b, m) \
        + (n + padded) * 4 * n_arrays


def _make_abitonic(spec, options):
    reject_unported(options)

    def fn(limbs, payload):
        cols = list(limbs) + ([payload] if payload is not None else [])
        n = cols[0].numel()
        cols, padded = bk.pad_and_reshape(cols, [_PAD] * len(cols))
        b, m = resolve_geometry(padded, len(cols), options)
        # KV sorts: the payload only moves (num_keys). Padding keeps the
        # total comparator: a real all-i32-max key row would tie the pad
        # rows on the prefix alone.
        nk = len(limbs) if (payload is not None and padded == n) else None
        bk.bitonic_sort_2d(cols, block_elems=b, merge_elems=m, num_keys=nk)
        flat = [c[:n] for c in cols]
        return (tuple(flat[:len(limbs)]),
                flat[len(limbs)] if payload is not None else None)
    return fn


def _smem_usage(kernel: str, numel: int, options: dict, n_arrays: int) -> int:
    """Dynamic shared memory per block of `kernel`, in bytes."""
    b, m = resolve_geometry(nlpo2(numel), n_arrays, options)
    return {"block_sort": b, "multi_stage": m, "pair_cross": 0,
            "block_merge": m}[kernel] * 4 * n_arrays


sort_impls.register("abitonic")(lambda: SortImplDef(
    name="abitonic",
    in_place=True,
    make_limb_sorter=_make_abitonic,
    kernel_names=bk.KERNELS,
    smem_usage=_smem_usage,
))
