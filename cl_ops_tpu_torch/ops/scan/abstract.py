"""Scan abstraction: named impls, dtype specialization, host/device entry.

Counterpart of `cl_ops_tpu/ops/scan/abstract.py` (the reference's
`clo_scan_abstract.c:74-362`): a registry of named implementations, each
Scan specialized on (elem type, sum type), the `scan_with_device_data` /
`scan_with_host_data` entry points, and kernel introspection (number of
kernels, their names, shared memory per kernel).

Implementations:
  * "blelloch" — the 3-phase scan: block sums and their scan in plain
    torch, then the scan_block kernel (scan_1d(single_pass=False)). The
    kernel names mirror the reference's three kernels.
  * "lookback" — the single-pass scan_carry kernel
    (scan_1d(single_pass=True)); float sums take the 3-phase path.
  * "xla" — the vendor baseline, torch.cumsum, in the role of the JAX
    package's jnp.cumsum (integer sums wrap through utils/intmath.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.dtypes import (canonicalize, default_sum_dtype,
                                          type_info)
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.core.registry import Registry, parse_options
from cl_ops_tpu_torch.ops.scan import kernels
from cl_ops_tpu_torch.utils import intmath


@dataclasses.dataclass(frozen=True)
class ScanImplDef:
    """Vtable analog of CloScanImplDef (clo_scan_abstract.in.h:41-103).

    make_fn(elem_dtype, sum_dtype, options) -> fn(x, exclusive) -> sums.
    vmem_usage(kernel_name, numel, sum_dtype) -> shared-memory bytes per
    block of that kernel (the name is the JAX one, for the reader).
    """

    name: str
    make_fn: Callable[..., Callable]
    kernel_names: tuple[str, ...]
    vmem_usage: Callable[[str, int, torch.dtype], int]


scan_impls: Registry[ScanImplDef] = Registry("scan")


class Scan:
    """A dtype-specialized scanner (analog of `struct clo_scan`)."""

    def __init__(self, impl: ScanImplDef, elem_dtype, sum_dtype,
                 options: dict[str, str]):
        self._impl = impl
        self.elem_dtype = canonicalize(elem_dtype)
        self.sum_dtype = (canonicalize(sum_dtype) if sum_dtype is not None
                          else default_sum_dtype(self.elem_dtype))
        self._options = options
        self._fn = impl.make_fn(self.elem_dtype, self.sum_dtype, options)

    # -- introspection (parity: clo_scan_abstract.in.h:144-170) -------------
    @property
    def name(self) -> str:
        return self._impl.name

    @property
    def num_kernels(self) -> int:
        return len(self._impl.kernel_names)

    def kernel_name(self, i: int) -> str:
        return self._impl.kernel_names[i]

    def vmem_usage(self, kernel_name: str, numel: int) -> int:
        """Shared-memory bytes per block of one kernel pass: the CUDA
        counterpart of the JAX package's VMEM query and of
        clo_scan_get_localmem_usage (clo_scan_abstract.in.h:158-162). The
        phases that run as plain torch report 0."""
        if kernel_name not in self._impl.kernel_names:
            raise BadArgsError(f"{self.name} has no kernel {kernel_name!r}")
        return self._impl.vmem_usage(kernel_name, numel, self.sum_dtype)

    # -- entry points --------------------------------------------------------
    def scan_with_device_data(self, x: torch.Tensor, *,
                              exclusive: bool = True) -> torch.Tensor:
        """Scan a tensor where it lies (parity: clo_scan_with_device_data)."""
        if x.dim() != 1:
            raise BadArgsError(f"scan expects 1-D input, got shape "
                               f"{tuple(x.shape)}")
        if x.dtype != self.elem_dtype:
            raise BadArgsError(f"input dtype {x.dtype} != specialized elem "
                               f"dtype {self.elem_dtype}")
        return self._fn(x, exclusive)

    def scan_with_host_data(self, x, *, exclusive: bool = True,
                            device=None) -> np.ndarray:
        """Host round trip: numpy in, scan on `device` (None = "cuda"),
        numpy out (parity: clo_scan_with_host_data)."""
        np_dt = type_info(self.elem_dtype).np_dtype or np.uint16
        dev = interop.to_torch(np.asarray(x, np_dt), device, self.elem_dtype)
        return interop.to_numpy(self.scan_with_device_data(
            dev, exclusive=exclusive))

    __call__ = scan_with_device_data


def scan_new(name: str = "blelloch",
             options: str | dict[str, Any] | None = None,
             elem_dtype="uint", sum_dtype=None) -> Scan:
    """Create a scanner by name (parity: clo_scan_new, clo_scan_abstract.c:74).

    Args:
      name: "blelloch" (3-phase: block sums, their scan, one block-scan
        kernel), "lookback" (single-pass kernel) or "xla" (torch.cumsum).
      options: reference-style option string or dict. The JAX options
        block_rows and interpret set TPU tiling and Pallas interpretation
        and are accepted and ignored here.
      elem_dtype: input element type (OpenCL-style name or dtype).
      sum_dtype: accumulator/output type; defaults to the widening rule
        (uint -> ulong etc., like clo_scan_bench's defaults).
    """
    impl = scan_impls.get(name)()
    return Scan(impl, elem_dtype, sum_dtype, parse_options(options))


def scan_names() -> list[str]:
    return scan_impls.names()


def _scan_1d_fn(single_pass: bool):
    def make_fn(elem_dtype, sum_dtype, options):
        def fn(x, exclusive):
            return kernels.scan_1d(x, sum_dtype=sum_dtype,
                                   exclusive=exclusive,
                                   single_pass=single_pass)
        return fn
    return make_fn


def _wide(sum_dtype: torch.dtype) -> bool:
    return sum_dtype.itemsize == 8


# --- blelloch: block sums (torch), their scan (torch), scan_block ------------------

def _blelloch_smem(kernel_name, numel, sum_dtype):
    if kernel_name != "block_scan_base_add":
        return 0  # phases 1-2 run as plain torch
    return kernels.smem_bytes(
        "scan_block_wide" if _wide(sum_dtype) else "scan_block",
        8 if _wide(sum_dtype) else 4)


# The reference's three kernels (workgroupScan / workgroupSumsScan /
# addWorkgroupSums, clo_scan_blelloch.cl:49-211): phases 1-2 are torch
# glue, phase 3 the scan_block kernel that fuses the block scan with the
# base add.
scan_impls.register("blelloch")(lambda: ScanImplDef(
    name="blelloch",
    make_fn=_scan_1d_fn(single_pass=False),
    kernel_names=("block_sums", "block_sums_scan", "block_scan_base_add"),
    vmem_usage=_blelloch_smem,
))


# --- lookback: the single-pass scan_carry kernel ---------------------------------

def _lookback_smem(kernel_name, numel, sum_dtype):
    if not intmath.is_int(sum_dtype) or sum_dtype == torch.float64:
        return _blelloch_smem("block_scan_base_add", numel, sum_dtype)
    return kernels.smem_bytes(
        "scan_carry_wide" if _wide(sum_dtype) else "scan_carry",
        8 if _wide(sum_dtype) else 4)


scan_impls.register("lookback")(lambda: ScanImplDef(
    name="lookback",
    make_fn=_scan_1d_fn(single_pass=True),
    kernel_names=("carry_scan",),
    vmem_usage=_lookback_smem,
))


# --- xla: torch.cumsum (the vendor baseline) -------------------------------------

def _xla_make_fn(elem_dtype, sum_dtype, options):
    def fn(x, exclusive):
        if intmath.is_int(sum_dtype):
            xs = intmath.astype(x, sum_dtype)
            inc = intmath.cumsum(xs)
            return intmath.sub(inc, xs) if exclusive else inc
        xs = x.to(sum_dtype)
        inc = torch.cumsum(xs, 0)
        return inc - xs if exclusive else inc
    return fn


scan_impls.register("xla")(lambda: ScanImplDef(
    name="xla",
    make_fn=_xla_make_fn,
    kernel_names=("cumsum",),
    vmem_usage=lambda k, n, s: 0,
))
