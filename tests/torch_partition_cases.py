"""Inputs at the edges of the partition kernels' design (ops/scan/kernels.py
`partition`, csrc/scan.cu), shared by the CPU tests (`test_torch_filter.py`:
the plain version against numpy's `concatenate([c[m], c[~m]])`) and the
card tests (`test_torch_cuda.py`: the kernels against the plain version):
lengths around a tile and past a count block's tiles, masks that keep
nothing, everything, every other row or only the rows at tile edges, and
columns of every width."""

import numpy as np

from cl_ops_tpu_torch.ops.scan import kernels as sk

TILE = sk.PART_TILE
LENGTHS = (0, 1, TILE - 1, TILE, TILE + 1, (1 << 20) + 3)
MASKS = ("none", "all", "alternating", "tile edges")
WIDTHS = (np.uint8, np.int16, np.float32, np.int64)


def mask(name, n):
    pos = np.arange(n)
    return {"none": np.zeros(n, dtype=bool),
            "all": np.ones(n, dtype=bool),
            "alternating": pos % 2 == 0,
            "tile edges": (pos % TILE == 0) | (pos % TILE == TILE - 1),
            }[name]


def columns(n, seed, dtypes=WIDTHS):
    """One column of each dtype, its bits drawn at random (float bits
    included, NaNs and all)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n * np.dtype(d).itemsize,
                         dtype=np.uint8).view(d) for d in dtypes]


def expected(m, cols):
    """The definition: the kept rows, then the dropped rows, in order."""
    return [np.concatenate([c[m], c[~m]]) for c in cols]
