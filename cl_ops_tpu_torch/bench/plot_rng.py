"""Visual RNG quality plot — parity with scripts/clo_rng_plot.py.

Counterpart of `cl_ops_tpu/bench/plot_rng.py`: loads one or more TSV
matrices produced by
`python -m cl_ops_tpu_torch.bench.rng_bench --output file-tsv` and renders
each as a grayscale image grid for visual randomness inspection
(`scripts/clo_rng_plot.py:31-64`). Needs matplotlib; returns 1 without it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("files", nargs="+", help="TSV matrices (one per RNG)")
    p.add_argument("--out", default=None,
                   help="save PNG instead of showing a window")
    args = p.parse_args(argv)

    try:
        import matplotlib
        if args.out:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1

    n = len(args.files)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, squeeze=False,
                             figsize=(4 * cols, 4 * rows))
    for i, path in enumerate(args.files):
        m = np.loadtxt(path, delimiter="\t")
        ax = axes[i // cols][i % cols]
        ax.imshow(m, cmap="gray", interpolation="nearest", aspect="auto")
        ax.set_title(path)
        ax.axis("off")
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    if args.out:
        fig.savefig(args.out, dpi=120, bbox_inches="tight")
        print(f"wrote {args.out}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
