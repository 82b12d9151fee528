"""Band-probe inputs at the edges of the probe_band kernel's design, shared
by the CPU tests (`test_torch_bandprobe.py`: the plain version against a
numpy oracle of the definition, and the JAX kernel where its entry points
reach the case) and the card tests (`test_torch_cuda.py`: the kernel
against the plain version). Each case is int32 numpy arrays; `oracle`
computes the definition directly, one probe block at a time."""

import numpy as np
import torch

from cl_ops_tpu_torch.ops.exec import bandprobe as bp

BLOCK = 128 * bp.ROW  # 16384 probes: two kernel chunks
NAMES = ("row before the window", "probes below every window row",
         "nb = 0", "nb = 1", "clamped window, whole side",
         "clamped window, sub-window", "equal high limbs",
         "ragged probe blocks", "equal runs across chunk edges",
         "unsorted chunk among sorted")


def _sorted_build(rng, nb, n_limbs, hi):
    keys = rng.integers(-hi, hi, (nb, n_limbs)).astype(np.int32)
    return keys[np.lexsort(keys.T[::-1])] if nb else keys


def _sorted_starts(build, probes, block):
    """window_starts over each block's first and last probe, as
    probe_banded_sorted computes them."""
    heads = np.arange(0, len(probes), block)
    tails = np.minimum(heads + block, len(probes)) - 1
    starts, ovf = bp.window_starts(
        [torch.from_numpy(np.ascontiguousarray(c)) for c in build.T],
        [torch.from_numpy(probes[heads, l]) for l in range(build.shape[1])],
        [torch.from_numpy(probes[tails, l]) for l in range(build.shape[1])])
    assert not bool(ovf)
    return starts.numpy()


def case(name):
    """(build limbs (nb, L), values (nb, V), probe limbs (m, L), starts,
    probe_block) of one named case; sorted probes unless the name says
    otherwise."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n_limbs, n_vals, block = 1, 2, BLOCK
    if name == "row before the window":
        # windows start at build rows 4096 and 8192; probes sit just below
        # them and on the row before, so eq and val_prev read it
        nb, n_limbs = 5 * bp.BUILD_BLOCK + 123, 2
        build = _sorted_build(rng, nb, 2, 40)
        probes = np.concatenate([
            build[rng.integers(off - 300, off + 300, BLOCK)]
            for off in (bp.BUILD_BLOCK, 2 * bp.BUILD_BLOCK)])
        for j, off in enumerate((bp.BUILD_BLOCK, 2 * bp.BUILD_BLOCK)):
            probes[j * BLOCK:j * BLOCK + 50] = build[off - 1]
        probes = probes[np.lexsort(probes.T[::-1])]
        starts = np.array([1, 2], np.int32)
    elif name == "probes below every window row":
        nb = 3 * bp.WINDOW + 77
        build = _sorted_build(rng, nb, 1, 2 ** 30)
        probes = np.sort(np.concatenate([
            rng.integers(-2 ** 31, build[8192, 0], BLOCK // 2),
            build[rng.integers(8192, 12000, BLOCK // 2), 0]]))[:, None]
        starts = np.array([2], np.int32)  # window from row 8192
    elif name == "nb = 0":
        build = np.zeros((0, 1), np.int32)
        probes = np.sort(rng.integers(-5, 5, (3000, 1)), axis=0)
        starts = np.zeros(1, np.int32)
        block = 4096
    elif name == "nb = 1":
        build = np.array([[7]], np.int32)
        probes = rng.integers(5, 10, (3000, 1)).astype(np.int32)
        starts = np.zeros(6, np.int32)
        block = 512
    elif name == "clamped window, whole side":
        nb = 2 * bp.BUILD_BLOCK + 5  # window [4096, nb)
        build = _sorted_build(rng, nb, 1, 3000)
        probes = rng.integers(-3100, 3100, (20000, 1)).astype(np.int32)
        starts = np.array([1, 1], np.int32)
    elif name == "clamped window, sub-window":
        nb = 5 * bp.BUILD_BLOCK + 5  # window [8192, nb)
        build = _sorted_build(rng, nb, 1, 3000)
        probes = np.sort(rng.integers(-1000, 3100, (BLOCK, 1)), axis=0)
        starts = np.array([2], np.int32)
    elif name == "equal high limbs":
        nb, n_limbs, n_vals = 20000, 2, 3
        build = _sorted_build(rng, nb, 2, 2 ** 31)
        build[:, 0] = np.repeat([-1, 0, 1], [6000, 8000, 6000])
        build = build[np.lexsort(build.T[::-1])]
        probes = build[rng.integers(0, nb, 3 * BLOCK)]
        probes[::3, 1] += 1  # off by one in the low limb
        probes = probes[np.lexsort(probes.T[::-1])]
        starts = _sorted_starts(build, probes, block)
    elif name == "ragged probe blocks":
        nb, n_vals = 30000, 3
        build = _sorted_build(rng, nb, 1, 2 ** 20)
        probes = np.sort(rng.integers(-2 ** 20, 2 ** 20, (3 * BLOCK + 100, 1)),
                         axis=0).astype(np.int32)
        starts = _sorted_starts(build, probes, block)
    elif name == "equal runs across chunk edges":
        nb, n_vals = 40000, 1
        build = _sorted_build(rng, nb, 1, 5000)
        # 3000-probe runs of 14 keys from the first 10000 rows, so each
        # 16K-probe block spans less than a window
        probes = np.sort(np.repeat(build[rng.integers(0, 10000, 14), 0],
                                   3000))[:, None]
        starts = _sorted_starts(build, probes, block)
    elif name == "unsorted chunk among sorted":
        # 8192 shuffled probes, not aligned to any run or chunk, whose
        # ranges span the whole window, among sorted ones
        nb = bp.WINDOW + 1
        build = _sorted_build(rng, nb, 1, 2 ** 31)
        probes = np.sort(rng.integers(-2 ** 31, 2 ** 31, (4 * BLOCK, 1)),
                         axis=0).astype(np.int32)
        starts = _sorted_starts(build, probes, block)
        probes[20000:28192] = rng.integers(build[0, 0], build[-1, 0],
                                           (8192, 1))
    else:
        raise KeyError(name)
    vals = rng.integers(-2 ** 31, 2 ** 31, (len(build), n_vals)).astype(
        np.int32)
    return (build.astype(np.int32), vals, probes.astype(np.int32),
            starts.astype(np.int32), block)


def as_torch(build, vals, probes, starts, device="cpu"):
    """The case as probe_band's arguments on `device`."""
    def cols(a):
        return [torch.from_numpy(np.ascontiguousarray(c)).to(device)
                for c in a.T]
    return (cols(build), cols(vals), cols(probes),
            torch.from_numpy(starts).to(device))


def _composite(a):
    if a.shape[1] == 1:
        return a[:, 0].astype(np.int64)
    return a[:, 0].astype(np.int64) * (1 << 32) + a[:, 1] + (1 << 31)


def oracle(build, vals, probes, starts, block):
    """(count, eq, val_prev columns, val_next columns) by the definition."""
    nb, m = len(build), len(probes)
    bk, pk = _composite(build), _composite(probes)
    count = np.zeros(m, np.int64)
    for i, s in enumerate(starts):
        offs = int(s) * bp.BUILD_BLOCK
        rows = slice(i * block, min((i + 1) * block, m))
        count[rows] = offs + np.searchsorted(bk[offs:offs + bp.WINDOW],
                                             pk[rows], side="right")
    if nb == 0:
        zero = [np.zeros(m, np.int32)] * vals.shape[1]
        return count.astype(np.int32), count > 0, zero, zero
    prev = np.maximum(count - 1, 0)
    nxt = np.minimum(count, nb - 1)
    eq = (count > 0) & (bk[prev] == pk)
    return (count.astype(np.int32), eq, [v[prev] for v in vals.T],
            [v[nxt] for v in vals.T])
