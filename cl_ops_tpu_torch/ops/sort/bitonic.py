"""The bitonic sorters: "abitonic" (the fused schedule) and "sbitonic".

Counterpart of `cl_ops_tpu/ops/sort/bitonic.py`. abitonic's geometry is a
shared-memory model: the merge block M is the largest power of two whose
columns fit the per-block budget (SMEM_BUDGET, all of the 227 KB one Hopper
block may use), and the sort block is B = M / 4. Both are clamped to the
padded length. Its options, in the order they win:
  block_elems=, merge_elems=  the geometry, explicitly;
  autotune=1                  the winner of an on-card sweep, cached
                              (autotune.py); on CPU tensors nothing is tuned;
  single_launch=0|1           the whole network as one cooperative launch
                              (n x columns <= 2^21); absent = off, or the
                              tuner's verdict with autotune=1.

sbitonic launches pair_cross once per network step (K, J), the reference's
simple bitonic (abitonic's pair_cross launches take up to cross_span steps
each). Its option `block_elems=` is validated for parity with the
JAX package, where it routes steps between two kernels; on the card one
kernel runs every step, so it routes nothing.
"""

from __future__ import annotations

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import autotune
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort.abstract import SortImplDef, sort_impls
from cl_ops_tpu_torch.utils.bits import is_po2, nlpo2
from cl_ops_tpu_torch.utils.profiling import named

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


def flag_option(options: dict, name: str) -> bool | None:
    """A 0|1 option: None when absent."""
    v = options.get(name)
    if v is None:
        return None
    if v not in ("0", "1"):
        raise BadArgsError(f"option {name}= takes 0 or 1, got {v!r}")
    return v == "1"


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


def sort_plan(n_padded: int, n_arrays: int, options: dict,
              device) -> tuple[int, int, bool]:
    """(block_elems, merge_elems, single_launch) for a padded problem on
    `device`: explicit options first, then the autotune cache (autotune=1,
    CUDA only), then the shared-memory model; single_launch absent is off."""
    sl = flag_option(options, "single_launch")
    if (flag_option(options, "autotune") and device.type == "cuda"
            and not {"block_elems", "merge_elems"} <= options.keys()):
        tb, tm, tsl = autotune.tune_geometry(n_padded, n_arrays, device)
        options = {"block_elems": tb, "merge_elems": tm, **options}
        sl = tsl if sl is None else sl
    b, m = resolve_geometry(n_padded, n_arrays, options)
    return b, m, bool(sl)


def abitonic_traffic_bytes(n: int, n_arrays: int,
                           options: dict | None = None) -> int:
    """Bytes-moved model of one abitonic sort call: the fused schedule's
    launches (or the one whole_sort launch with single_launch=1) plus the
    padded copy (read n, write padded)."""
    options = options or {}
    padded = nlpo2(n)
    b, m = resolve_geometry(padded, n_arrays, options)
    return bk.fused_traffic_bytes(
        padded, n_arrays, b, m, flag_option(options, "single_launch")) \
        + (n + padded) * 4 * n_arrays


def sbitonic_traffic_bytes(n: int, n_arrays: int) -> int:
    """Bytes-moved model of one sbitonic sort call: one sweep of every
    column per network step, plus the padded copy."""
    padded = nlpo2(n)
    return (2 * bk.sbitonic_steps(padded) * padded + n + padded) \
        * 4 * n_arrays


def _pad_and_sort(limbs, payload, sort):
    """Pad the limb and payload columns to a power of two, sort them with
    sort(cols, num_keys), and cut the padding off again."""
    cols = list(limbs) + ([payload] if payload is not None else [])
    n = cols[0].numel()
    with named("clo.sort", n=n, padded=nlpo2(n), cols=len(cols)):
        cols, padded = bk.pad_and_reshape(cols, [_PAD] * len(cols))
        # KV sorts: the payload only moves (num_keys). Padding keeps the
        # total comparator: a real all-i32-max key row would tie the pad
        # rows on the prefix alone.
        nk = len(limbs) if (payload is not None and padded == n) else None
        sort(cols, nk)
        flat = [c[:n] for c in cols]
    return (tuple(flat[:len(limbs)]),
            flat[len(limbs)] if payload is not None else None)


def _make_abitonic(spec, options):
    for name in ("single_launch", "autotune"):
        flag_option(options, name)

    def sort(cols, nk):
        b, m, sl = sort_plan(cols[0].numel(), len(cols), options,
                             cols[0].device)
        bk.bitonic_sort_2d(cols, block_elems=b, merge_elems=m, num_keys=nk,
                           single_launch=sl)
    return lambda limbs, payload: _pad_and_sort(limbs, payload, sort)


def _make_sbitonic(spec, options):
    if not is_po2(int(options.get("block_elems", 1024))):
        raise BadArgsError("block_elems must be a power of 2")

    def sort(cols, nk):
        bk.sbitonic_sort_2d(cols, num_keys=nk)
    return lambda limbs, payload: _pad_and_sort(limbs, payload, sort)


def _smem_usage(kernel: str, numel: int, options: dict, n_arrays: int) -> int:
    """Dynamic shared memory per block of `kernel`, in bytes (pair_cross:
    its tile, which a launch of more steps than its registers take
    allocates)."""
    n = nlpo2(numel)
    b, m = resolve_geometry(n, n_arrays, options)
    return {"block_sort": b, "multi_stage": m,
            "pair_cross": min(bk.cross_rows(n_arrays), n),
            "block_merge": m}[kernel] * 4 * n_arrays


sort_impls.register("abitonic")(lambda: SortImplDef(
    name="abitonic",
    in_place=True,
    make_limb_sorter=_make_abitonic,
    kernel_names=bk.FUSED,
    smem_usage=_smem_usage,
))

sort_impls.register("sbitonic")(lambda: SortImplDef(
    name="sbitonic",
    in_place=True,
    make_limb_sorter=_make_sbitonic,
    kernel_names=("pair_cross",),
    smem_usage=lambda kernel, numel, options, n_arrays: 0,
))
