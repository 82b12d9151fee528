"""Scan operator family: prefix sums and segmented scans (counterpart of
`cl_ops_tpu/ops/scan/`).

  scan_new(...)                — clo_scan_new ("blelloch", "lookback", "xla")
  Scan.scan_with_device_data   — scan a tensor where it lies
  Scan.scan_with_host_data     — numpy in, numpy out
  scan_names()                 — impl registry
  scan_1d(...)                 — prefix sum; single-pass or 3-phase
  segmented_scan_1d(...)       — per-segment running sum/min/max
  flags_from_segment_ids(ids)  — segment-start flags
"""

from cl_ops_tpu_torch.ops.scan.abstract import (Scan, ScanImplDef,
                                                scan_impls, scan_names,
                                                scan_new)
from cl_ops_tpu_torch.ops.scan.kernels import scan_1d
from cl_ops_tpu_torch.ops.scan.segmented import (flags_from_segment_ids,
                                                 segmented_scan_1d)

__all__ = ["Scan", "ScanImplDef", "flags_from_segment_ids", "scan_1d",
           "scan_impls", "scan_names", "scan_new", "segmented_scan_1d"]
