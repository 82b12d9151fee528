"""Dense (small-cardinality) multi-measure GROUP BY: one streaming pass.

Counterpart of `cl_ops_tpu/ops/exec/dense_agg.py`. When group ids are dense
ints in [0, num_groups) and num_groups is small (TPC-H Q1 has 4 groups),
sorting every row to aggregate into a few slots moves far more data than
the problem needs: one pass over the rows into a table of num_groups slots
per reduction does it. The CUDA kernel `dense_agg` (`csrc/dense_agg.cu`,
replacing `_dense_kernel` and its lane combine) reads each distinct column
once and sends each row to its group's slot with shared-memory atomics, in
up to 64 copies of the table a block; its plain version here is one
`index_add_` or `scatter_reduce_` per reduction.

Exactness: integer sums wrap mod 2^32 and integer min/max/count are
order-free, so any accumulation order gives the same bits. float32 columns
take min/max only, through the order-preserving int32 map of
`ops/sort/keys.py`; float32 sums would depend on the order and are
rejected, as are 8-byte columns. u32 min/max compare with the sign bit
flipped, in and out, as in JAX.

The JAX options block_rows, interpret and use_pallas have no counterpart
(as in `join.py`): CUDA tensors run the kernel, CPU tensors its plain
version. `dense_agg` adds one to `launches["dense_agg"]` per launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.ops.exec.aggregate import _mean
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.platform import build_library, launch_stream

__all__ = ["group_aggregate_dense_cols", "DENSE_MAX_GROUPS"]

# Auto-routing ceiling of the JAX package, kept for its callers.
DENSE_MAX_GROUPS = 1024
KINDS = ("count", "sum", "min", "max")  # csrc/dense_agg.cu's enum order
KERNELS = ("dense_agg",)

_I32_MAX = 2 ** 31 - 1
_I32_MIN = -(2 ** 31)
_IDENT = {"count": 0, "sum": 0, "min": _I32_MAX, "max": _I32_MIN}

# Kernel launches since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    launches["dense_agg"] = 0


_lib = None
build_log = ""


def load_kernels():
    """Build (once per source hash) and load csrc/dense_agg.cu."""
    global _lib, build_log
    if _lib is None:
        path, build_log = build_library("dense_agg")
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(ctypes.c_int)
        # (gid, mask, src, kind, flip, n_red, n, G, out, stream)
        lib.clo_dense_agg.argtypes = [p, p, ctypes.POINTER(p), ints, ints, i,
                                      ctypes.c_longlong, i, p, p]
        lib.clo_dense_agg.restype = i
        lib.clo_dense_agg_max_red.restype = i
        _lib = lib
    return _lib


# --- kernel and plain version ------------------------------------------------

def _check(gid, mask, reductions, num_groups) -> bool:
    """Validate dense_agg's operands; returns whether they lie on the card."""
    n, dev = gid.numel(), gid.device
    if not reductions:
        raise BadArgsError("dense_agg needs at least one reduction")
    if not 1 <= num_groups < 2 ** 31:
        raise BadArgsError(f"num_groups must be in [1, 2^31), got "
                           f"{num_groups}")
    cols = [gid] + [src for src, _, _ in reductions if src is not None]
    for t in cols:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise BadArgsError("dense_agg columns must be contiguous 1-D "
                               "int32")
        if t.numel() != n or t.device != dev:
            raise BadArgsError("dense_agg columns differ in length or "
                               "device")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (n,)
                             or not mask.is_contiguous()
                             or mask.device != dev):
        raise BadArgsError("valid_mask must be a contiguous bool tensor of "
                           "the ids' length and device")
    for src, kind, _ in reductions:
        if kind not in KINDS or (src is None) != (kind == "count"):
            raise BadArgsError(f"bad reduction {kind!r}: count takes no "
                               "column, the others one")
    if dev.type not in ("cpu", "cuda"):
        raise BadArgsError(f"unsupported device {dev}")
    return dev.type == "cuda"


def dense_agg_plain(gid, mask, reductions, num_groups: int) -> torch.Tensor:
    """Plain version of dense_agg: one index_add_ (counts and sums, in int64
    and then wrapped to int32) or scatter_reduce_ (amin/amax) per
    reduction, with dropped rows sent to a spare last slot."""
    keep = (gid >= 0) & (gid < num_groups)
    if mask is not None:
        keep = keep & mask
    ids = torch.where(keep, gid, num_groups).to(torch.int64)
    out = torch.empty((len(reductions), num_groups), dtype=torch.int32,
                      device=gid.device)
    for r, (src, kind, flip) in enumerate(reductions):
        if kind in ("count", "sum"):
            add = torch.ones_like(ids) if kind == "count" \
                else src.to(torch.int64)
            t = torch.zeros(num_groups + 1, dtype=torch.int64,
                            device=gid.device).index_add_(0, ids, add)
            out[r] = intmath.wrap(t[:num_groups], torch.int32)
        else:
            v = src ^ _I32_MIN if flip else src
            t = torch.full((num_groups + 1,), _IDENT[kind],
                           dtype=torch.int32, device=gid.device)
            t.scatter_reduce_(0, ids, v, "amin" if kind == "min" else "amax")
            out[r] = t[:num_groups]
    return out


def dense_agg(gid, mask, reductions, num_groups: int) -> torch.Tensor:
    """Per-group reductions over the rows whose int32 id lies in
    [0, num_groups) and whose bool mask entry (where given) holds.

    reductions: tuple of (src, kind, flip): kind one of count/sum/min/max,
    src an int32 column (None for count), flip the u32 sign flip of a
    min/max (the table stays in the flipped domain). Returns an
    (n_reductions, num_groups) int32 table: counts and sums mod 2^32, and
    the identities (0, i32 max, i32 min) where a group has no row.
    """
    reductions = tuple(reductions)
    if not _check(gid, mask, reductions, num_groups):
        return dense_agg_plain(gid, mask, reductions, num_groups)
    dev = gid.device
    out = _identities(dev, tuple(kind for _, kind, _ in reductions),
                      num_groups).clone()
    if gid.numel() == 0:
        return out
    lib = load_kernels()
    per_launch = lib.clo_dense_agg_max_red()
    here = dev.index == torch.cuda.current_device()
    # the library launches on the current device
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        stream = launch_stream(dev)
        for lo in range(0, len(reductions), per_launch):
            part = reductions[lo:lo + per_launch]
            k = len(part)
            src = (ctypes.c_void_p * k)(*[
                None if s is None else s.data_ptr() for s, _, _ in part])
            kind = (ctypes.c_int * k)(*[KINDS.index(kd) for _, kd, _ in part])
            flip = (ctypes.c_int * k)(*[int(f) for _, _, f in part])
            err = lib.clo_dense_agg(
                gid.data_ptr(), None if mask is None else mask.data_ptr(),
                src, kind, flip, k, gid.numel(), num_groups,
                out[lo].data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"CUDA kernel dense_agg failed: error "
                                   f"{err}")
            launches["dense_agg"] += 1
    return out


@functools.lru_cache(maxsize=64)
def _identities(dev, kinds, num_groups: int) -> torch.Tensor:
    """The (len(kinds), num_groups) table of each reduction's identity, on
    the device; dense_agg starts from a copy of it."""
    ident = torch.tensor([_IDENT[k] for k in kinds], dtype=torch.int32)
    return ident[:, None].expand(-1, num_groups).contiguous().to(dev)


# --- the operator ------------------------------------------------------------

def _to_raw_i32(v: torch.Tensor):
    """(int32 column, flip) of a measure: 4-byte integers by their bits
    (uint32 flips for min/max), narrower integers widened (unsigned ones
    zero-extended, so their order holds), float32 by the order-preserving
    limb map."""
    dt = v.dtype
    if dt == torch.int32:
        return v, False
    if dt == torch.uint32:
        return v.view(torch.int32), True
    if intmath.is_int(dt) and dt.itemsize < 4:
        return intmath.astype(v, torch.int32), False
    if dt == torch.float32:
        return keymod.to_limbs(v)[0], False
    raise BadArgsError(f"dense aggregate: unsupported column dtype {dt}")


def _decode(table: torch.Tensor, dtype: torch.dtype, kind: str):
    """Inverse of _to_raw_i32 on a table (narrow ints truncate: the wrapped
    sum)."""
    if kind == "count":
        return table
    if dtype == torch.float32:
        return keymod.from_limbs([table], torch.float32)
    return intmath.astype(table, dtype)


def _ids_i32(group_ids: torch.Tensor) -> torch.Tensor:
    """The ids as int32, converted as JAX's astype(int32) does (integers
    wrap mod 2^32)."""
    if intmath.is_int(group_ids.dtype):
        return intmath.astype(group_ids, torch.int32).contiguous()
    return group_ids.to(torch.int32).contiguous()


def group_aggregate_dense_cols(group_ids, values, aggs, *, num_groups: int,
                               valid_mask=None):
    """Multi-measure GROUP BY over DENSE group ids, with no sort.

    group_ids: 1-D integer ids; rows with ids outside [0, num_groups) are
    dropped, and so are rows where the boolean valid_mask (the fused
    WHERE) is False. values: tuple of 1-D measure columns (integers of 4
    bytes or fewer; float32 for min/max only); a column passed in several
    slots (the same tensor object) streams through the kernel once. aggs:
    matching sum/count/min/max/mean. num_groups: the dense id capacity;
    the JAX package routes up to DENSE_MAX_GROUPS here.

    Returns (group_keys, tables, count) in group_aggregate_cols' layout:
    the first `count` rows hold the groups with at least one valid row,
    ascending by id; the padding rows are the absent ids, ascending, with
    the decoded identities (sums and counts 0).
    """
    values, aggs = tuple(values), tuple(aggs)
    if len(values) != len(aggs) or not values:
        raise BadArgsError("values and aggs must be equal-length, non-empty")
    gid = _ids_i32(group_ids)
    mask = None if valid_mask is None else valid_mask.to(torch.bool) \
        .contiguous()

    # The reductions: count always first (presence, count and mean); mean
    # is sum + count; one reduction per (distinct column, kind).
    encoded = {}      # id(column) -> (int32 column, flip)
    reductions = [(None, "count", False)]
    red_of = {}       # (id(column), kind) -> reduction index
    plan = []         # per slot: its reduction's index
    for v, a in zip(values, aggs):
        if a not in ("sum", "count", "min", "max", "mean"):
            raise BadArgsError(f"unknown agg {a!r}")
        if v.dtype == torch.float32 and a in ("sum", "mean"):
            raise BadArgsError("dense aggregate: f32 sums are "
                               "order-dependent; use the sorted path")
        if v.dtype.itemsize == 8:
            raise BadArgsError("dense aggregate: 64-bit columns need the "
                               "sorted path")
        if a == "count":
            plan.append(0)
            continue
        if id(v) not in encoded:
            raw, flip = _to_raw_i32(v)
            encoded[id(v)] = (raw.contiguous(), flip)
        raw, flip = encoded[id(v)]
        kind = "sum" if a == "mean" else a
        if (id(v), kind) not in red_of:
            red_of[(id(v), kind)] = len(reductions)
            reductions.append((raw, kind, flip and kind in ("min", "max")))
        plan.append(red_of[(id(v), kind)])

    table = dense_agg(gid, mask, reductions, num_groups)
    combined = [table[r] ^ _I32_MIN if flip else table[r]
                for r, (_, _, flip) in enumerate(reductions)]

    counts = combined[0]
    present = counts > 0
    count = present.sum(dtype=torch.int64)
    gi = torch.arange(num_groups, dtype=torch.int32, device=gid.device)
    # present slots first, ascending, then the absent ones, ascending
    order = torch.argsort(torch.where(present, gi, num_groups), stable=True)
    group_keys = intmath.astype(gi[order], group_ids.dtype) \
        if intmath.is_int(group_ids.dtype) else gi[order].to(group_ids.dtype)

    tables = []
    for v, a, r in zip(values, aggs, plan):
        if a == "count":
            t = counts
        elif a == "mean":
            t = _mean(intmath.astype(combined[r], v.dtype), counts)
        else:
            t = _decode(combined[r], v.dtype, a)
        tables.append(signed_view(t)[order].view(t.dtype))
    return group_keys, tuple(tables), count
