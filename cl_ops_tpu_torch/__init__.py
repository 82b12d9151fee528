"""cl_ops_tpu_torch — the PyTorch/CUDA port of cl_ops_tpu for NVIDIA Hopper.

Same entry points and results as the JAX package `cl_ops_tpu`, which stays
beside it as the reference; every Pallas kernel of the JAX package has a
CUDA C++ counterpart for sm_90a (`csrc/`), built with nvcc at first CUDA
use. Functions given tensors run where their tensors lie (CPU tensors take
each kernel's plain PyTorch version); entry points that take host data or
generate data run on "cuda" unless given `device=`.

Layer map (mirrors cl_ops_tpu):
  core/     — dtype registry, op registries, errors
  utils/    — bit helpers, wrapping integer math, device selection, kernel
              build
  interop   — bit-exact numpy <-> torch hand-over
  ops/      — rng/ (Threefry); sort/ (five sorters: abitonic, sbitonic,
              satradix, gselect, xla; key limbs, autotune, dma_scatter's
              chunk copy); scan/ (scan_new, single-pass and 3-phase scans,
              segmented scans); exec/ (filter, sorted and dense GROUP BY,
              join, window functions, top-k, DISTINCT)
  models/   — pipelines: generate_table, sort_pipeline and four queries
              (analytics_query, star_query, q1_query, rollup_query)
  csrc/     — six CUDA sources: bitonic.cu, scan.cu, bandprobe.cu,
              radix.cu, dense_agg.cu, chunk_copy.cu

Quick start:
  from cl_ops_tpu_torch.ops.sort import sort_new
  out = sort_new("abitonic").sort_with_host_data(np_array)   # on the GPU
"""

from cl_ops_tpu_torch.core import dtypes, errors, registry  # noqa: F401
from cl_ops_tpu_torch.defer import DeferredOverflowError, verify_deferred
from cl_ops_tpu_torch.utils import bits  # noqa: F401

__version__ = "0.1.0"

__all__ = ["DeferredOverflowError", "bits", "dtypes", "errors", "registry",
           "verify_deferred", "__version__"]
