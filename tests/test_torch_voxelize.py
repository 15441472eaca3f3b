"""Port dense-cell voxelizer against pillars_tpu's voxelize_cells.

cell/kept/count/points/num_pillars must be exact (integer logic and a stable
sort on a unique key). The per-cell mean is summed in another order (one
segment sum here; a centre-relative cumsum difference at B=1 and a segmented
scan at B>1 there), so it agrees to ~1e-5 on the points whose cell is valid;
the mean of invalid points is unused and differs by design.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.ops.voxelize import make_cell_voxelizer as torch_vox
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.ops.voxelize import make_cell_voxelizer as jax_vox
from torch_parity import crowded_clouds

torch.set_num_threads(2)

MEAN_ATOL = 1e-5


@pytest.mark.parametrize("b", [1, 2])
def test_voxelize_cells_matches_jax(b):
    maxpts = 2048
    n_valid = np.array([2000, 1500][:b], np.int32)
    pts = crowded_clouds(b, b, maxpts, n_valid)
    want = jax_vox(JaxConfig.default().model.voxel)(jnp.asarray(pts),
                                                   jnp.asarray(n_valid))
    got = torch_vox(TorchConfig.default().model.voxel)(
        torch.from_numpy(pts), torch.from_numpy(n_valid))
    for name in ("points", "cell", "kept", "count", "num_pillars"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    valid = np.asarray(want.cell) < 80 * 64 * 2
    np.testing.assert_allclose(got.mean.numpy()[valid],
                               np.asarray(want.mean)[valid], atol=MEAN_ATOL)
    assert np.asarray(want.count).max() == 50  # the clump hit the cap
    assert not np.asarray(want.kept)[valid].all()


def test_voxelize_cells_empty_cloud():
    pts = np.zeros((1, 64, 3), np.float32)
    got = torch_vox(TorchConfig.default().model.voxel)(
        torch.from_numpy(pts), torch.tensor([0], dtype=torch.int32))
    assert int(got.num_pillars) == 0
    assert not got.kept.any()
    assert (got.cell == 80 * 64 * 2).all()
