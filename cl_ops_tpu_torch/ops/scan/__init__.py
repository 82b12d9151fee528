"""Scan operator family: prefix sums and segmented scans (counterpart of
`cl_ops_tpu/ops/scan/`).

  scan_1d(...)                 — prefix sum; integer sums single-pass
  segmented_scan_1d(...)       — per-segment running sum/min/max
  flags_from_segment_ids(ids)  — segment-start flags

scan_new and the 3-phase scan come with the scans slice.
"""

from cl_ops_tpu_torch.ops.scan.kernels import scan_1d
from cl_ops_tpu_torch.ops.scan.segmented import (flags_from_segment_ids,
                                                 segmented_scan_1d)

__all__ = ["flags_from_segment_ids", "scan_1d", "segmented_scan_1d"]
