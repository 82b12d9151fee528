"""Filter + stream compaction.

Counterpart of `cl_ops_tpu/ops/exec/filter.py` (BASELINE.json: "Prefix-sum
filter: ... compaction over 64M rows w/ 10% selectivity"). Compaction rides
ONE unique i32 key `(!keep)*n + position` through the fused bitonic sort: a
stable partition with kept rows contiguous at the front, in their original
order. The count is a plain reduction.
"""

from __future__ import annotations

from typing import Callable

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError, BadDtypeError
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.utils.profiling import spanned

# flag*n + pos stays exact while 2n < _PACK_MAX; beyond it the rank uses
# two columns. Module-level so tests can shrink it to cover the wide path.
_PACK_MAX = 2 ** 31


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
    mask = predicate(data)
    drop = 1 - mask.to(torch.int32)
    count = mask.sum(dtype=torch.int64)
    enc, spec = psort.cols_to_i32(cols)
    if 2 * n < _PACK_MAX:
        keys = (psort.flag_pos_key(drop, n),)
    else:  # two-column rank: (flag, position) lexicographic
        keys = (drop, torch.arange(n, dtype=torch.int32, device=data.device))
    # the rank prefix is unique and < 2n, so payload columns skip the
    # comparator (num_keys) and pads still sort last on it (pad_safe)
    out = psort.sort_i32_cols((*keys, *enc), num_keys=len(keys),
                              pad_safe=True)
    return (count, *psort.cols_from_i32(out[len(keys):], spec))


def count_where(data: torch.Tensor, predicate: Callable) -> torch.Tensor:
    """Count rows satisfying the predicate (no compaction)."""
    return predicate(data).sum(dtype=torch.int64)
