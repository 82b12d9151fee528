"""Filter + stream compaction.

Counterpart of `cl_ops_tpu/ops/exec/filter.py` (BASELINE.json: "Prefix-sum
filter: ... compaction over 64M rows w/ 10% selectivity"). Compaction is a
stable partition (`ops/scan/kernels.partition`): kept rows contiguous at
the front, dropped rows after them, both in their original order, each
column moved at its own width, and the count from the same kernels. The
JAX package sorts the unique key `(!keep)*n + position` with every column
as payload instead, because XLA's scatter is element-serialized on a TPU;
the sort's output is this partition, bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.scan import kernels as sk
from cl_ops_tpu_torch.utils.profiling import spanned


@spanned("clo.op:filter")
def filter_compact(data: torch.Tensor, predicate: Callable, *extra_cols):
    """Keep rows where predicate(data) holds, compacted to the front.

    Args:
      data: 1-D tensor the predicate reads.
      predicate: elementwise tensor function data -> bool mask.
      *extra_cols: additional same-length columns carried through.

    Returns:
      (count, packed_data, *packed_cols): count is a 0-d int64 tensor; the
      rows past `count` are the dropped rows, also in their original order.
    """
    n = data.shape[0]
    cols = (data, *extra_cols)
    if n >= 2 ** 31:
        raise BadArgsError(f"filter_compact takes n < 2^31, got {n}")
    if any(c.shape != data.shape or c.device != data.device for c in cols):
        raise BadArgsError("columns differ in shape or device")
    if not psort.cols_encodable(*cols):
        raise BadDtypeError("filter_compact columns must be int, uint or "
                            "float of 1, 2, 4 or 8 bytes")
    mask = predicate(data).to(torch.bool).contiguous()
    return sk.partition(mask, [c.contiguous() for c in cols])


def count_where(data: torch.Tensor, predicate: Callable) -> torch.Tensor:
    """Count rows satisfying the predicate (no compaction)."""
    return predicate(data).sum(dtype=torch.int64)
