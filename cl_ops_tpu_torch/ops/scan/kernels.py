"""Prefix sums: scan_1d on the single-pass scan_carry kernels.

Counterpart of `cl_ops_tpu/ops/scan/kernels.py`. The integer single-pass
path (`single_pass=True`) runs one CUDA kernel, `csrc/scan.cu` scan_carry,
in two forms: 32-bit sums mod 2^32 ("scan_carry", replacing
`_scan_carry_kernel`) and 64-bit sums mod 2^64 ("scan_carry_wide", replacing
`_wide_scan_carry_kernel`, on native 64-bit integers instead of two limbs).
Each reads its input once and writes its output once: 8n bytes for 32-bit
sums, 16n for 64-bit sums; the cross-block carry is a decoupled look-back
(see the note at the top of csrc/scan.cu).

float64 sums are a plain torch.cumsum, as the JAX package leaves them to
XLA. The 3-phase path (`single_pass=False`, and every float32 sum) needs
`_scan_block_kernel` / `_wide_scan_block_kernel`, which are not ported yet:
it raises BadArgsError.

`scan_carry` runs the plain PyTorch version on CPU tensors and launches the
kernel on CUDA tensors, adding one to `launches[<name>]` per launch.
"""

from __future__ import annotations

import ctypes

import torch

from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.platform import build_library

KERNELS = ("scan_carry", "scan_carry_wide")

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
        lib.clo_scan_status_bytes.argtypes = [ll, i]
        lib.clo_scan_status_bytes.restype = ll
        # (x, out, n, value_bytes, exclusive, status, stream)
        lib.clo_scan_carry.argtypes = [p, p, ll, i, i, p, p]
        lib.clo_scan_carry.restype = i
        # (x, flags, out, n, is_float, op, exclusive, status, stream)
        lib.clo_seg_scan_carry.argtypes = [p, p, p, ll, i, i, i, p, p]
        lib.clo_seg_scan_carry.restype = i
        _lib = lib
    return _lib


def run_scan_kernel(fn_name: str, x: torch.Tensor, *args) -> None:
    """Call `fn_name`(*args, status, stream) of the scan library on x's
    device with a freshly zeroed look-back status buffer for x."""
    lib = load_kernels()
    status = torch.zeros(lib.clo_scan_status_bytes(x.numel(),
                                                   x.element_size()),
                         dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):  # the library launches on it
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(*args, status.data_ptr(), stream)
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


# --- kernel and plain version --------------------------------------------------

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
        run_scan_kernel("clo_scan_carry", x, x.data_ptr(), out.data_ptr(),
                        x.numel(), x.element_size(), int(exclusive))
        launches["scan_carry" if x.dtype == torch.int32
                 else "scan_carry_wide"] += 1
    return out


# --- scan_1d -------------------------------------------------------------------

def _unported(kernel: str, line: int) -> BadArgsError:
    return BadArgsError(
        f"the 3-phase scan needs {kernel} (cl_ops_tpu/ops/scan/kernels.py:"
        f"{line}), which is not ported yet; integer sums take "
        "single_pass=True")


def scan_traffic_bytes(n: int, sum_dtype) -> int:
    """Bytes the scan_carry kernel of scan_1d(single_pass=True) moves: one
    read of its input and one write of its sums, 4 or 8 bytes each."""
    return n * 2 * (8 if canonicalize(sum_dtype).itemsize == 8 else 4)


def scan_1d(x: torch.Tensor, *, sum_dtype, exclusive: bool = True,
            single_pass: bool = False) -> torch.Tensor:
    """Prefix sum over a 1-D tensor, in `sum_dtype`.

    Integer sums wrap mod 2^bits of sum_dtype (inputs convert as numpy's
    astype does); exclusive=False gives the inclusive form. Integer sums run
    the single-pass kernel and need single_pass=True; float64 sums are a
    torch.cumsum. The JAX options block_rows and interpret are TPU tiling
    and Pallas settings with no counterpart here.
    """
    if x.dim() != 1:
        raise BadArgsError(f"scan_1d expects 1-D input, got {tuple(x.shape)}")
    sd = canonicalize(sum_dtype)
    if sd == torch.float64:
        xs = x.to(torch.float64)
        acc = torch.cumsum(xs, 0)
        return acc - xs if exclusive else acc
    if not intmath.is_int(sd):
        raise _unported("_scan_block_kernel", 148)
    if not intmath.is_int(x.dtype):
        raise BadDtypeError(f"integer sums take integer input, got {x.dtype}")
    wide = sd.itemsize == 8
    if not single_pass:
        raise _unported("_wide_scan_block_kernel", 241) if wide else \
            _unported("_scan_block_kernel", 148)
    work = torch.int64 if wide else torch.int32
    res = scan_carry(intmath.astype(x, work).contiguous(), exclusive)
    if wide:
        return res.view(sd)
    # the sums are u32 bits for unsigned sum types, i32 values otherwise
    return intmath.astype(res.view(torch.uint32) if intmath.is_unsigned(sd)
                          else res, sd)
