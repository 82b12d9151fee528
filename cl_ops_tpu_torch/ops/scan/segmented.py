"""Segmented prefix scans: per-segment running sum/min/max over flag runs.

Counterpart of `cl_ops_tpu/ops/scan/segmented.py`. For an associative op
(+) with identity e the pair operator

    (v1, f1) (x) (v2, f2) = (f2 ? v2 : v1 (+) v2,  f1 | f2)

is associative, so a segmented scan is a plain scan of (value, flag) pairs.
The kernel, `csrc/scan.cu` seg_scan_carry (`seg_tiles`, replacing
`_seg_carry_kernel`), runs it in one pass over int32 or float32 values with
int32 flags: 12n bytes read and written. It is scan_carry's design with a
pair carry: tiles of `kernels.SEG_TILE` elements read with 16-byte loads,
each thread's contiguous items scanned serially, and one status word per
tile holding its state, its any-flag bit and its value. A tile that holds
a flag publishes its inclusive prefix before it looks back, and a
look-back stops at the nearest such tile. The status buffer is cached per
(device, stream) and cleared by each call's last block.

Dtype rules follow the JAX package: <=32-bit integers run in int32 (sums
mod 2^32; u32 min/max through a sign flip so that signed order is unsigned
order), float32 natively. 64-bit integer and float64 accumulators take a
plain torch formulation, as the JAX package writes them in XLA: cumsum
minus the cumsum gathered at each run's start for add, and a log-step
scan of the pair operator for min/max. Exclusive min/max shift on the host.

`seg_scan_carry` runs the plain PyTorch version on CPU tensors and launches
the kernel on CUDA tensors, adding one to `launches["seg_scan_carry"]`.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.interop import signed_view, take
from cl_ops_tpu_torch.ops.scan.kernels import (check_1d, run_kernel,
                                               seg_status_bytes)
from cl_ops_tpu_torch.utils import intmath

__all__ = ["segmented_scan_1d", "flags_from_segment_ids"]

KERNELS = ("seg_scan_carry",)
OPS = ("add", "min", "max")
_MIN32 = -(1 << 31)
_MIN64 = -(1 << 63)

# Kernel launches per wrapper since the last reset_launches().
launches = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    launches["seg_scan_carry"] = 0


def _identity(op: str, dtype: torch.dtype):
    """The op's identity in `dtype`, as a python scalar."""
    if op == "add":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    lo, hi = intmath.int_limits(dtype)
    return hi if op == "min" else lo


def _combine(op: str):
    return {"add": torch.add, "min": torch.minimum, "max": torch.maximum}[op]


def _pair_scan(v: torch.Tensor, f: torch.Tensor, op: str) -> torch.Tensor:
    """Inclusive scan of (v, f) pairs under the pair operator, in log2(n)
    Hillis-Steele rounds (v signed int or float, f bool)."""
    fn = _combine(op)
    d = 1
    while d < v.numel():
        nv = v.clone()
        nv[d:] = torch.where(f[d:], v[d:], fn(v[:-d], v[d:]))
        nf = f.clone()
        nf[d:] = f[d:] | f[:-d]
        v, f = nv, nf
        d *= 2
    return v


def _run_starts(flags: torch.Tensor) -> torch.Tensor:
    """For every row, the index of its run's first row (int32)."""
    iota = torch.arange(flags.numel(), dtype=torch.int32, device=flags.device)
    return torch.cummax(torch.where(flags > 0, iota, 0), 0).values


def _seg_add_int(x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive sum mod 2^bits: the cumsum minus the cumsum
    just before each run's start."""
    incl = intmath.cumsum(x)
    start = _run_starts(flags)
    prev = intmath.where(start > 0, take(incl, (start - 1).clamp(min=0)),
                         torch.zeros_like(incl))
    return intmath.sub(incl, prev)


# --- kernel and plain version --------------------------------------------------

def seg_scan_carry_plain(x: torch.Tensor, flags: torch.Tensor, op: str,
                         exclusive: bool) -> torch.Tensor:
    """Plain version of seg_scan_carry. int32 sums are exact mod 2^32;
    float32 sums are taken in log-step tree order, which differs from the
    kernel's order (see tests/test_torch_cuda.py for the tolerance)."""
    if op == "add" and x.dtype == torch.int32:
        res = _seg_add_int(x, flags)
        return intmath.sub(res, x) if exclusive else res
    res = _pair_scan(x, flags != 0, op)
    return res - x if exclusive else res


def seg_scan_carry(x: torch.Tensor, flags: torch.Tensor, op: str,
                   exclusive: bool = False) -> torch.Tensor:
    """Inclusive segmented scan of int32 or float32 values under op (add,
    min, max), restarting at every nonzero int32 flag; exclusive=True (add
    only) gives the exclusive form."""
    cuda = check_1d(x, (torch.int32, torch.float32))
    check_1d(flags, (torch.int32,))
    if flags.shape != x.shape or flags.device != x.device:
        raise BadArgsError("flags differ from the values in length or device")
    if op not in OPS or (exclusive and op != "add"):
        raise BadArgsError(f"op {op!r} (exclusive={exclusive}) not supported")
    if not cuda:
        return seg_scan_carry_plain(x, flags, op, exclusive)
    out = torch.empty_like(x)
    if x.numel():
        run_kernel("clo_seg_scan_carry", x.device, x.data_ptr(),
                   flags.data_ptr(), out.data_ptr(), x.numel(),
                   int(x.dtype == torch.float32), OPS.index(op),
                   int(exclusive), status_bytes=seg_status_bytes(x.numel()))
        launches["seg_scan_carry"] += 1
    return out


# --- segmented_scan_1d ---------------------------------------------------------

def _shift_exclusive(incl, x, flags, op: str, dtype):
    """Exclusive from inclusive: identity at run starts, previous value
    elsewhere (add: inclusive minus the element)."""
    if op == "add":
        if intmath.is_int(dtype):
            return intmath.sub(incl, intmath.astype(x, dtype))
        return incl - x.to(dtype)
    ident = intmath.full(1, _identity(op, dtype), dtype, incl.device)
    prev = torch.cat([signed_view(ident), signed_view(incl)[:-1]]).view(dtype)
    return intmath.where(flags > 0, ident.expand_as(incl), prev)


def _segmented_scan_wide(x, flags, dtype, op: str, exclusive: bool):
    """64-bit integer and float64 accumulators (the JAX package's XLA
    formulation)."""
    xs = intmath.astype(x, dtype) if intmath.is_int(dtype) else x.to(dtype)
    if op == "add" and intmath.is_int(dtype):
        incl = _seg_add_int(xs, flags)
    elif op == "add":
        incl = torch.cumsum(xs, 0)
        start = _run_starts(flags)
        incl = incl - torch.where(start > 0, incl[(start - 1).clamp(min=0)],
                                  torch.zeros_like(incl))
    elif dtype == torch.uint64:  # unsigned order through the sign flip
        incl = (_pair_scan(xs.view(torch.int64) ^ _MIN64, flags > 0, op)
                ^ _MIN64).view(dtype)
    else:
        incl = _pair_scan(xs, flags > 0, op)
    return _shift_exclusive(incl, x, flags, op, dtype) if exclusive else incl


def flags_from_segment_ids(ids: torch.Tensor) -> torch.Tensor:
    """Segment-start flags (int32 0/1) from a vector of segment ids: a
    segment starts wherever the id differs from its predecessor."""
    s = signed_view(ids)
    head = torch.ones(1, dtype=torch.int32, device=ids.device)
    return torch.cat([head, (s[1:] != s[:-1]).to(torch.int32)])


def segmented_scan_1d(x: torch.Tensor, flags: torch.Tensor, *,
                      sum_dtype=None, op: str = "add",
                      exclusive: bool = True) -> torch.Tensor:
    """Per-segment running sum/min/max over a 1-D tensor.

    flags: same length, nonzero marks a segment start; row 0 always starts
    one. sum_dtype defaults to x's dtype; 64-bit integer and float64 take
    the plain formulation. exclusive=False gives the inclusive form. The JAX
    options block_rows, interpret and use_pallas have no counterpart here:
    CUDA tensors run the kernel, CPU tensors its plain version.
    """
    if op not in OPS:
        raise BadArgsError(f"unknown op {op!r}; known: {OPS}")
    sd = canonicalize(sum_dtype if sum_dtype is not None else x.dtype)
    if flags.shape != x.shape:
        raise BadArgsError(f"flags shape {tuple(flags.shape)} != values "
                           f"shape {tuple(x.shape)}")
    fi = (flags != 0).to(torch.int32)
    if sd == torch.float64 or (intmath.is_int(sd) and sd.itemsize == 8):
        return _segmented_scan_wide(x, fi, sd, op, exclusive)
    if intmath.is_int(sd):
        xi = intmath.astype(x, torch.int32)
        if intmath.is_unsigned(x.dtype) and op != "add":
            xi = xi ^ _MIN32
    elif sd == torch.float32:
        xi = x.to(torch.float32)
    else:
        raise BadDtypeError(f"unsupported sum dtype {sd}")
    res = seg_scan_carry(xi.contiguous(), fi, op, exclusive and op == "add")
    if op != "add" and intmath.is_unsigned(sd):
        res = res ^ _MIN32
    if intmath.is_int(sd):
        res = intmath.astype(
            res.view(torch.uint32) if intmath.is_unsigned(sd) else res, sd)
    if exclusive and op != "add":
        return _shift_exclusive(res, x, fi, op, sd)
    return res
