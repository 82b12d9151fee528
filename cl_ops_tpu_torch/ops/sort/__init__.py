"""Sort operator family (counterpart of `cl_ops_tpu/ops/sort/`).

  sort_new(...)                 — clo_sort_new
  Sorter.sort_with_device_data  — sort a tensor where it lies (+ values)
  Sorter.sort_with_host_data    — numpy in, numpy out
  sort_names()                  — impl registry ("abitonic", "gselect",
                                  "satradix", "sbitonic", "xla")
"""

from cl_ops_tpu_torch.ops.sort import keys
from cl_ops_tpu_torch.ops.sort.abstract import (Sorter, SortImplDef, SortSpec,
                                                sort_impls, sort_names,
                                                sort_new)
# Implementations self-register on import.
from cl_ops_tpu_torch.ops.sort import bitonic as _bitonic  # noqa: F401
from cl_ops_tpu_torch.ops.sort import gselect as _gselect  # noqa: F401
from cl_ops_tpu_torch.ops.sort import satradix as _satradix  # noqa: F401
from cl_ops_tpu_torch.ops.sort import xla_impl as _xla  # noqa: F401

__all__ = ["SortImplDef", "SortSpec", "Sorter", "keys", "sort_impls",
           "sort_names", "sort_new"]
