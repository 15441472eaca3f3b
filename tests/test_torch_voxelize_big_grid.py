"""The big-grid branch of the port's ``voxelize_points`` (more cells than
``max_voxels``: the arrival-order pillar cap) against
``pillars_tpu.ops.voxelize.voxelize_points`` on the CPU, on the same
NumPy-seeded clouds.

Tolerances: every integer and mask output and the sorted points are equal
(integer logic and sorts on unique keys); point_mean and voxel_mean within
1e-5 (the per-pillar sums are taken in another order: fixed-point segment
sums here, a segmented associative scan there, both on values relative to the
cell centre).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.ops.voxelize import voxelize_points as torch_voxelize
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.ops.voxelize import voxelize_points as jax_voxelize
from torch_parity import crowded_clouds

torch.set_num_threads(2)

MEAN_ATOL = 1e-5
EXACT = ("points", "point_pillar", "point_kept", "point_zyx", "num_points",
         "coords", "pillar_mask")


def _kwargs(vcfg, max_voxels):
    return dict(voxel_size=np.asarray(vcfg.voxel_size, np.float32),
                point_cloud_range=np.asarray(vcfg.point_cloud_range,
                                             np.float32),
                grid_size=vcfg.grid_size,
                max_points_per_voxel=vcfg.max_points_per_voxel,
                max_voxels=max_voxels)


def _both(pts, n_valid, max_voxels):
    """(JAX per sample stacked, port batched) on pts [B, M, 3]."""
    jv = JaxConfig.default().model.voxel
    tv = TorchConfig.default().model.voxel
    assert jv.grid_size[0] * jv.grid_size[1] * jv.grid_size[2] > max_voxels
    fn = jax.jit(lambda p, n: jax_voxelize(p, n, **_kwargs(jv, max_voxels)))
    per_sample = [jax.device_get(fn(jnp.asarray(pts[i]),
                                    jnp.int32(n_valid[i])))
                  for i in range(len(pts))]
    want = type(per_sample[0])(*(np.stack(f) for f in zip(*per_sample)))
    got = torch_voxelize(torch.from_numpy(pts),
                         torch.from_numpy(np.asarray(n_valid, np.int32)),
                         **_kwargs(tv, max_voxels))
    return want, got


def _assert_equal(want, got):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("point_mean", "voxel_mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=MEAN_ATOL, err_msg=name)


def _revisiting_cloud(seed, maxpts, n_cells_hit):
    """A cloud whose stream visits ``n_cells_hit`` distinct cells once, in
    cell-scrambled order, and then visits all of them again: with a pillar
    cap below ``n_cells_hit`` the second visits fall behind the overflow
    point, so pillars that survive lose points to the cutoff."""
    r = np.random.RandomState(seed)
    vcfg = TorchConfig.default().model.voxel
    nx, ny, _ = vcfg.grid_size
    cells = r.choice(nx * ny, n_cells_hit, replace=False)
    centre = np.stack([(cells % nx + 0.5) * vcfg.voxel_size[0]
                       + vcfg.point_cloud_range[0],
                       (cells // nx + 0.5) * vcfg.voxel_size[1]
                       + vcfg.point_cloud_range[1],
                       np.full(n_cells_hit, -1.0)], 1)
    first = centre + r.uniform(-0.03, 0.03, centre.shape)
    second = centre[r.permutation(n_cells_hit)] + r.uniform(
        -0.03, 0.03, centre.shape)
    p = np.concatenate([first, second]).astype(np.float32)
    pts = np.zeros((1, maxpts, 3), np.float32)
    pts[0, :len(p)] = p
    return pts, np.array([len(p)], np.int32)


def test_fewer_occupied_cells_than_cap():
    """The order statistics read the filler: nothing is cut."""
    n = np.array([300], np.int32)
    pts = crowded_clouds(1, 1, 1024, n)
    want, got = _both(pts, n, max_voxels=1000)
    _assert_equal(want, got)
    n_pillars = int(np.asarray(want.pillar_mask).sum())
    assert 0 < n_pillars < 1000
    valid = np.asarray(want.point_zyx)[..., 0] < 2
    assert (np.asarray(got.point_kept)[valid].sum()
            == np.asarray(want.num_points).sum())


def test_cutoff_drops_points_of_surviving_pillars():
    pts, n = _revisiting_cloud(2, 2048, 600)
    want, got = _both(pts, n, max_voxels=400)
    _assert_equal(want, got)
    # 400 pillars survive, each with its first visit only: the second
    # visits all come after the overflow point (stream position 400)
    assert np.asarray(got.pillar_mask).all()
    np.testing.assert_array_equal(got.num_points.numpy(), 1)
    kept = got.point_kept.numpy()[0]
    assert kept.sum() == 400
    # the same cloud without the cutoff would keep two points per pillar
    uncapped = torch_voxelize(
        torch.from_numpy(pts), torch.from_numpy(n),
        **_kwargs(TorchConfig.default().model.voxel, 20000))
    assert int(uncapped.num_points.max()) == 2


def test_cap_of_one_pillar():
    n = np.array([500], np.int32)
    pts = crowded_clouds(3, 1, 512, n)
    want, got = _both(pts, n, max_voxels=1)
    _assert_equal(want, got)
    assert got.pillar_mask.shape == (1, 1)
    assert int(got.point_kept.sum()) == int(got.num_points[0, 0]) >= 1


def test_cell_over_the_point_cap():
    """The clump of crowded_clouds puts more than 50 points into one cell,
    early enough in the stream to survive the pillar cap."""
    n = np.array([2000], np.int32)
    pts = crowded_clouds(4, 1, 2048, n)
    # bring the clump to the front of the stream
    clump = np.abs(pts[0, :2000] - [3.08, 0.04, 0.535]).max(axis=1) < 0.04
    order = np.concatenate([np.flatnonzero(clump), np.flatnonzero(~clump)])
    pts[0, :2000] = pts[0, order]
    want, got = _both(pts, n, max_voxels=800)
    _assert_equal(want, got)
    assert int(np.asarray(want.num_points).max()) == 50
    assert np.asarray(want.pillar_mask).all()  # the cap was reached


def test_batch_of_two_with_different_counts():
    n = np.array([1800, 700], np.int32)
    pts = crowded_clouds(5, 2, 2048, n)
    want, got = _both(pts, n, max_voxels=900)
    _assert_equal(want, got)
    filled = np.asarray(want.pillar_mask).sum(axis=1)
    assert filled[0] == 900 and filled[1] < 900  # one capped, one not


def test_cap_equal_to_the_point_budget():
    """max_voxels == max_points: the (P+1)-th order statistic does not
    exist and the cutoff is the end of the stream (the 9984 rung of the
    d435i bucket ladder)."""
    n = np.array([512], np.int32)
    pts = crowded_clouds(6, 1, 512, n)
    want, got = _both(pts, n, max_voxels=512)
    _assert_equal(want, got)


def test_same_bits_at_every_padded_width():
    """The fixed-point segment sums do not depend on the padded width."""
    n = np.array([600], np.int32)
    pts = crowded_clouds(7, 1, 2048, n)
    kw = _kwargs(TorchConfig.default().model.voxel, 500)
    outs = [torch_voxelize(torch.from_numpy(pts[:, :w]), torch.from_numpy(n),
                           **kw) for w in (640, 1024, 2048)]
    for out in outs[1:]:
        for name in ("voxel_mean", "num_points", "coords", "pillar_mask"):
            assert torch.equal(getattr(out, name), getattr(outs[0], name))
        assert torch.equal(out.point_mean[:, :600], outs[0].point_mean[:, :600])


def _feature_cloud(amplitude):
    """One crowded cloud of 900 points with an extra feature uniform in
    +-``amplitude``."""
    n = np.array([900], np.int32)
    pts = np.concatenate([crowded_clouds(9, 1, 1024, n),
                          np.zeros((1, 1024, 1), np.float32)], -1)
    r = np.random.RandomState(9)
    pts[0, :900, 3] = r.uniform(-amplitude, amplitude, 900)
    return pts, n


def _jax_and_port(pts, n, max_voxels):
    jv = JaxConfig.default().model.voxel
    kw = _kwargs(TorchConfig.default().model.voxel, max_voxels)
    want = jax.device_get(jax.jit(lambda p, c: jax_voxelize(
        p, c, **_kwargs(jv, max_voxels)))(jnp.asarray(pts[0]),
                                           jnp.int32(n[0])))
    return want, torch_voxelize(torch.from_numpy(pts), torch.from_numpy(n),
                                **kw)


@pytest.mark.parametrize("max_voxels", [500, 20000])
def test_feature_range_of_the_fixed_point_sums(max_voxels):
    """Extra features near the range where the int64 sums keep the finest
    unit (|value| * 50 < 2^23), beyond it (1.7e5) and far beyond it (1e7)
    give the JAX package's means: the unit grows with the batch's largest
    value, so no sum wraps."""
    for amplitude, beyond in ((1.6e5, 1.7e5), (1e7, 1.2e7)):
        pts, n = _feature_cloud(amplitude)
        pts[0, 0, 3] = beyond
        want, got = _jax_and_port(pts, n, max_voxels)
        assert int(got.num_points.max()) == 50  # a full pillar of such values
        for name in EXACT:
            np.testing.assert_array_equal(getattr(got, name).numpy()[0],
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        for name in ("point_mean", "voxel_mean"):
            g = getattr(got, name).numpy()[0]
            w = np.asarray(getattr(want, name))
            np.testing.assert_allclose(g[..., :3], w[..., :3], atol=MEAN_ATOL,
                                       err_msg=name)
            # f32 sums of 50 such values in another order: an ulp or two
            # of the sum, over 50
            np.testing.assert_allclose(g[..., 3], w[..., 3], rtol=1e-6,
                                       atol=0.05 * amplitude / 1.6e5,
                                       err_msg=name)


@pytest.mark.parametrize("max_voxels", [500, 20000])
def test_non_finite_features_where_jax_puts_them(max_voxels):
    """A NaN, an infinity, and both infinities in the three fullest
    pillars: each pillar's feature mean is NaN, infinite or NaN where the
    JAX package's float sums put them, and every other mean is JAX's."""
    pts, n = _feature_cloud(1.0)
    _, plain = _jax_and_port(pts, n, max_voxels)
    kept = plain.point_kept.numpy()[0]
    pillar = plain.point_pillar.numpy()[0]
    counts = plain.num_points.numpy()[0]
    full = np.argsort(-counts, kind="stable")[:3]
    assert counts[full].min() >= 2
    order = plain.points.numpy()[0]
    # the input positions of the first two kept points of each full pillar
    src = [[int(np.flatnonzero((pts[0, :, :3] == order[i, :3]).all(-1))[0])
            for i in np.flatnonzero(kept & (pillar == p))[:2]] for p in full]
    pts[0, src[0][0], 3] = np.nan
    pts[0, src[1][0], 3] = np.inf
    pts[0, src[2][0], 3] = np.inf
    pts[0, src[2][1], 3] = -np.inf
    want, got = _jax_and_port(pts, n, max_voxels)
    for name in ("point_mean", "voxel_mean"):
        g, w = getattr(got, name).numpy()[0], np.asarray(getattr(want, name))
        assert np.isnan(w[..., 3]).any() and np.isinf(w[..., 3]).any()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=name)
        np.testing.assert_allclose(g, w, atol=MEAN_ATOL, err_msg=name)
