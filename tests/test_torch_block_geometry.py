"""The tile geometry of the block_sort and block_merge kernels.

`bitonic_kernels.block_geometry` mirrors csrc/bitonic.cu block_rows and
block_smem (the library's loader compares the two on the card). Here, on the
CPU: every tile that the wrappers admit gets a launchable geometry.
"""

import pytest
import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs several processes
    side by side (pytest-xdist), and torch's own threads would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_po2(x):
    return x > 0 and x & (x - 1) == 0


@pytest.mark.parametrize("n_cols", range(1, bk.MAX_COLS + 1))
def test_every_admitted_tile_has_a_launchable_geometry(n_cols):
    lengths = [length for c, length in bk.block_tiles() if c == n_cols]
    assert lengths == [1 << i for i in range(len(lengths))]
    largest = lengths[-1]
    # block_tiles is exactly what _check admits: the next tile is refused
    cols = [torch.zeros(4 * largest, dtype=torch.int32)] * n_cols
    bk._check(cols, None, largest, smem_block=largest)
    with pytest.raises(BadArgsError):
        bk._check(cols, None, 2 * largest, smem_block=2 * largest)
    for length in lengths:
        threads, rows, smem = bk.block_geometry(n_cols, length)
        assert threads * rows == length
        assert _is_po2(rows) and _is_po2(threads)
        assert threads <= 1024
        assert smem <= bk.SMEM_MAX
        assert smem >= n_cols * length * 4
        if rows > 1:
            assert threads >= 32  # whole warps
            if n_cols <= 4:
                # no step between 32 R and T (a shared-memory pass)
                assert threads <= 32 * rows
        else:
            assert length <= 512
    # the main path's default merge blocks take the full rows
    assert bk.block_geometry(n_cols, largest)[1] == {
        1: 32, 2: 32, 3: 32, 4: 16}.get(n_cols, 8)


def test_seven_columns_run_unpadded():
    # 7 x 8192 rows: 229,376 bytes unpadded, 236,544 padded
    for length in (8192, 4096):
        assert bk.block_geometry(7, length)[2] == 7 * length * 4
    assert bk.block_geometry(6, 8192)[2] == 6 * (8192 + 256) * 4
    assert 7 * (8192 + 256) * 4 > bk.SMEM_MAX


@pytest.mark.parametrize("n_cols", range(1, bk.MAX_COLS + 1))
def test_multi_stage_admits_block_merges_tiles(n_cols):
    """multi_stage_ runs block_sort's kernel at its merge tile, so it takes
    exactly the tiles block_merge_ takes (block_tiles), each at
    block_geometry(n_cols, merge); on the CPU a tile with no stage to run
    (2 * block > merge) is accepted and leaves the rows as they are."""
    lengths = [length for c, length in bk.block_tiles() if c == n_cols]
    largest = lengths[-1]
    cols = [torch.arange(4 * largest, dtype=torch.int32).flip(0)
            for _ in range(n_cols)]
    want = [c.clone() for c in cols]
    bk.reset_launches()
    for merge in lengths:
        bk.multi_stage_(cols, merge, merge)
        bk.block_merge_(cols, 1, 0)  # no step: a 1-row merge tile
    for merge in (2 * largest, 4 * largest):
        with pytest.raises(BadArgsError):
            bk.multi_stage_(cols, 1, merge)
        with pytest.raises(BadArgsError):
            bk.block_merge_(cols, merge, 0)
    assert all(torch.equal(c, w) for c, w in zip(cols, want))
    assert bk.launches == dict.fromkeys(bk.KERNELS, 0)  # plain versions
    # the merge tile's geometry: the main path's default at each width
    threads, rows, _ = bk.block_geometry(n_cols, largest)
    assert threads * rows == largest and threads <= 1024
