"""The slice as a whole: generate_table, sort_pipeline and a filter over a
generated table, cl_ops_tpu_torch against cl_ops_tpu (Pallas kernels in
interpret mode), bit for bit."""

import numpy as np
import pytest
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import CloOpsError
from cl_ops_tpu_torch.models import pipeline as tpl
from cl_ops_tpu_torch.ops.exec import filter_compact

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jpl = pytest.importorskip("cl_ops_tpu.models.pipeline")
jflt = pytest.importorskip("cl_ops_tpu.ops.exec.filter")

SEEDS = [0, 7, 2 ** 33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spaces", [(1 << 20, 1 << 10), (1000, 7)])
def test_generate_table_matches_reference(seed, spaces):
    ks, vs = spaces
    wk, wv = jpl.generate_table(3000, seed, key_space=ks, value_space=vs)
    gk, gv = tpl.generate_table(3000, seed, key_space=ks, value_space=vs,
                                device="cpu")
    assert gk.dtype == gv.dtype == torch.uint32
    np.testing.assert_array_equal(interop.to_numpy(gk), np.asarray(wk))
    np.testing.assert_array_equal(interop.to_numpy(gv), np.asarray(wv))


@pytest.mark.parametrize("seed", SEEDS)
def test_sort_pipeline_matches_reference(seed):
    wk, wok = jpl.sort_pipeline(4096, seed, use_pallas=True)
    gk, gok = tpl.sort_pipeline(4096, seed, device="cpu")
    assert bool(wok) and bool(gok)
    np.testing.assert_array_equal(interop.to_numpy(gk), np.asarray(wk))


def test_filter_over_generated_table():
    wk, wv = jpl.generate_table(5000, 3)
    want = jflt.filter_compact(wv, lambda v: v < jnp.uint32(512), wk,
                               use_pallas=True)
    gk, gv = tpl.generate_table(5000, 3, device="cpu")
    got = filter_compact(gv, lambda v: interop.widen_u32(v) < 512, gk)
    assert int(got[0]) == int(want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(interop.to_numpy(g), np.asarray(w))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(CloOpsError):
        tpl.generate_table(16)
    with pytest.raises(CloOpsError):
        interop.to_torch(np.arange(4))
