"""Measurement + verification harness (ref L4: src/benchmarks/).

Counterpart of `cl_ops_tpu/bench`. CLIs (argparse analogs of the
reference's GOption executables), each on the card unless given
`--device cpu`:
  python -m cl_ops_tpu_torch.bench.sort_bench   — clo_sort_bench parity
  python -m cl_ops_tpu_torch.bench.scan_bench   — clo_scan_bench parity
  python -m cl_ops_tpu_torch.bench.rng_bench    — clo_rng_bench parity
  python -m cl_ops_tpu_torch.bench.plot_rng     — scripts/clo_rng_plot.py parity
  python -m cl_ops_tpu_torch.bench.headline     — bench.py's one JSON line
"""

from cl_ops_tpu_torch.bench.common import (compare_values, rand_array,
                                           throughput_m, time_async,
                                           write_tsv)

__all__ = ["compare_values", "rand_array", "throughput_m", "time_async",
           "write_tsv"]
