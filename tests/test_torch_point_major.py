"""The port's point-major front end against pillars_tpu's on the CPU:
voxelize_points / voxelize_batch, PointwisePFN, the canvas scatter and the
coords-based anchors mask, on the same NumPy-seeded clouds and weights.

Tolerances: integers, masks and the sorted points are exact (integer logic
and a sort on a unique key). point_mean and voxel_mean: 1e-5, because the
per-pillar sums are taken in another order (one segment sum here, a
segmented associative scan there) on values relative to the cell centre.
PointwisePFN: 1e-5 (the same f32 products summed in another order). The
canvas: 1e-6 (at most two pillars share a canvas cell; their sum does not
depend on the order). The anchors mask: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.models.pfn import PointwisePFN as TorchPFN
from pillars_torch.ops.anchors import anchors_mask as torch_anchors_mask
from pillars_torch.ops.scatter import scatter_to_canvas as torch_scatter
from pillars_torch.ops.scatter import scatter_to_canvas_batched
from pillars_torch.ops.voxelize import make_point_voxelizer
from pillars_torch.weights import convert_tree
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.models.pfn import PointwisePFN as JaxPFN
from pillars_tpu.ops.anchors import anchors_mask as jax_anchors_mask
from pillars_tpu.ops.scatter import scatter_to_canvas_batched as jax_scatter
from torch_parity import (crowded_clouds, fast_config, randomize_variables,
                          small_config)

torch.set_num_threads(2)

MEAN_ATOL = 1e-5
EXACT = ("points", "point_pillar", "point_kept", "point_zyx", "num_points",
         "coords", "pillar_mask")


def _voxelize_both(b, maxpts=2048, seed=None, n_valid=(2000, 1500)):
    n_valid = np.array(n_valid[:b], np.int32)
    pts = crowded_clouds(b if seed is None else seed, b, maxpts, n_valid)
    jcfg = fast_config(JaxConfig.default()).override("model.voxel.max_points",
                                                     maxpts)
    tcfg = fast_config(TorchConfig.default()).override(
        "model.voxel.max_points", maxpts)
    want = jax.device_get(JaxDetector(jcfg).voxelize_batch(
        jnp.asarray(pts), jnp.asarray(n_valid)))
    got = TorchDetector(tcfg, device="cpu").voxelize_batch(
        torch.from_numpy(pts), torch.from_numpy(n_valid))
    return want, got, jcfg, tcfg


@pytest.mark.parametrize("b", [1, 2])
def test_voxelize_points_matches_jax(b):
    want, got, _, _ = _voxelize_both(b)
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("point_mean", "voxel_mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=MEAN_ATOL, err_msg=name)
    assert np.asarray(want.num_points).max() == 50  # the clump hit the cap
    kept = np.asarray(want.point_kept)
    valid = np.asarray(want.point_zyx)[..., 0] < 2
    assert not kept[valid].all()
    # the sentinel segment carries a real-looking pillar id, not kept
    n_real = np.asarray(want.pillar_mask).sum(axis=1)
    pid = np.asarray(got.point_pillar)
    for i in range(b):
        assert (pid[i][~valid[i]] == n_real[i]).all()
        assert not kept[i][~valid[i]].any()


def test_voxelize_points_empty_cloud():
    vcfg = TorchConfig.default().model.voxel
    got = make_point_voxelizer(vcfg)(torch.zeros((1, 64, 3)),
                                     torch.tensor([0], dtype=torch.int32))
    assert not got.point_kept.any()
    assert not got.pillar_mask.any()
    assert (got.point_pillar == 0).all()


def test_voxelize_points_big_grid_raises():
    """A grid of more cells than max_voxels used to raise; now nothing
    does, and the pillar cap holds (test_torch_voxelize_big_grid.py has the
    comparison with the JAX package)."""
    vcfg = TorchConfig.default().override("model.voxel.max_voxels",
                                          1000).model.voxel
    pts = crowded_clouds(3, 1, 2048, np.array([2000], np.int32))
    got = make_point_voxelizer(vcfg)(torch.from_numpy(pts),
                                     torch.tensor([2000], dtype=torch.int32))
    assert got.pillar_mask.shape == (1, 1000)
    assert got.pillar_mask.all()  # 2000 points fill more than 1000 cells
    assert int(got.point_pillar.max()) == 1000  # the spare id, never kept
    assert not got.point_kept[got.point_pillar == 1000].any()


@pytest.mark.parametrize("b", [1, 2])
def test_pointwise_pfn(b):
    want_v, _, _, _ = _voxelize_both(b, seed=10 + b)
    jcfg = small_config(JaxConfig).override("model.pfn.dense_cell", False)
    tcfg = small_config(TorchConfig).override("model.pfn.dense_cell", False)
    p = want_v.pillar_mask.shape[1]
    flat = lambda a: np.array(a).reshape((-1,) + a.shape[2:])  # noqa: E731
    pid = np.asarray(want_v.point_pillar) + (np.arange(b) * p)[:, None]
    args = (flat(want_v.points), flat(pid), flat(want_v.point_kept),
            flat(want_v.point_mean), flat(want_v.point_zyx),
            flat(want_v.num_points), flat(want_v.pillar_mask))
    pfn = JaxPFN(jcfg.model)
    init = pfn.init(jax.random.PRNGKey(0), *args, train=False)
    variables = randomize_variables(jax.device_get(init), seed=b)
    want = np.asarray(pfn.apply(variables, *args, train=False))

    tpfn = TorchPFN(tcfg.model)
    tpfn.load_state_dict(convert_tree(variables["params"],
                                      variables["batch_stats"]))
    with torch.no_grad():
        got = tpfn.eval()(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    mask = flat(want_v.pillar_mask)
    assert (want[~mask] == 0).all() and (want[mask] > 0).any()


@pytest.mark.parametrize("b", [1, 2])
def test_scatter_to_canvas(b):
    want_v, _, jcfg, _ = _voxelize_both(b, seed=20 + b)
    _, ny, nx = jcfg.model.feature_map_size
    coords = np.array(want_v.coords)
    mask = np.array(want_v.pillar_mask)
    r = np.random.RandomState(b)
    feats = r.randn(*mask.shape, 6).astype(np.float32)
    want = np.asarray(jax_scatter(jnp.asarray(feats), jnp.asarray(coords),
                                  jnp.asarray(mask), ny, nx))
    got = scatter_to_canvas_batched(torch.from_numpy(feats),
                                    torch.from_numpy(coords),
                                    torch.from_numpy(mask), ny, nx)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    one = torch_scatter(torch.from_numpy(feats[0]), torch.from_numpy(coords[0]),
                        torch.from_numpy(mask[0]), ny, nx)
    np.testing.assert_allclose(one.numpy(), want[0], atol=1e-6)
    # two z-layers meet at some (y, x): the ADD is exercised
    yx = coords[0][mask[0]][:, 1:]
    assert len(np.unique(yx, axis=0)) < len(yx)


@pytest.mark.parametrize("b", [1, 2])
def test_anchors_mask_batched(b):
    # sparse clouds: the mask is neither all true nor all false
    want_v, _, jcfg, tcfg = _voxelize_both(b, seed=30 + b, n_valid=(60, 40))
    thr = jcfg.eval_input.anchor_area_threshold
    jdet = JaxDetector(jcfg)
    tdet = TorchDetector(tcfg, device="cpu")
    coords, mask = np.array(want_v.coords), np.array(want_v.pillar_mask)
    want = np.asarray(jdet.anchors_mask_batch(jnp.asarray(coords),
                                              jnp.asarray(mask), thr))
    got = tdet.anchors_mask_batch(torch.from_numpy(coords),
                                  torch.from_numpy(mask), thr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    # the gather form (no structured SAT) on one sample
    _, ny, nx = jcfg.model.feature_map_size
    corners = jdet.anchor_set.sat_corners
    want1 = np.asarray(jax_anchors_mask(jnp.asarray(coords[0]),
                                        jnp.asarray(mask[0]), corners, ny,
                                        nx, thr))
    got1 = torch_anchors_mask(torch.from_numpy(coords[0]),
                              torch.from_numpy(mask[0]), corners, ny, nx, thr)
    np.testing.assert_array_equal(got1.numpy(), want1)
