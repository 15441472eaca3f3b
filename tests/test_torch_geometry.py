"""Port geometry and anchors against the JAX package on the same inputs.

Tolerances: the decode chain is elementwise f32 in both (exp/sqrt/sin/cos
from different libraries, so a few ulp); anchor tables and masks are exact.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.geometry import boxes as tgb
from pillars_torch.ops import anchors as tanchors
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.geometry import boxes as jgb
from pillars_tpu.ops import anchors as janchors

torch.set_num_threads(2)

ATOL = 2e-6  # a few f32 ulp at coordinates of a few metres


def _encodings_and_anchors(seed, n=257):
    r = np.random.RandomState(seed)
    enc = (r.randn(n, 7) * 0.5).astype(np.float32)
    anchors = np.stack([
        r.uniform(0, 6.4, n), r.uniform(-2.56, 2.56, n),
        np.full(n, -1.465), np.full(n, 0.6), np.full(n, 0.8),
        np.full(n, 1.73), r.choice([0.0, 1.57], n)], 1).astype(np.float32)
    return enc, anchors


@pytest.mark.parametrize("seed", range(3))
def test_decode_corners_standup(seed):
    enc, anchors = _encodings_and_anchors(seed)
    want = np.asarray(jgb.second_box_decode(jnp.asarray(enc),
                                            jnp.asarray(anchors)))
    got = tgb.second_box_decode(torch.from_numpy(enc),
                                torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)

    bev = want[:, [0, 1, 3, 4, 6]]
    jc = jgb.center_to_corner_box2d(jnp.asarray(bev[:, :2]),
                                    jnp.asarray(bev[:, 2:4]),
                                    jnp.asarray(bev[:, 4]))
    tc = tgb.center_to_corner_box2d(torch.from_numpy(bev[:, :2]),
                                    torch.from_numpy(bev[:, 2:4]),
                                    torch.from_numpy(bev[:, 4]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(tgb.corner_to_standup(tc).numpy(),
                               np.asarray(jgb.corner_to_standup(jc)),
                               atol=ATOL)


def test_limit_period_and_corners_3d():
    r = np.random.RandomState(0)
    ang = r.uniform(-10, 10, 100).astype(np.float32)
    np.testing.assert_allclose(
        tgb.limit_period(torch.from_numpy(ang)).numpy(),
        np.asarray(jgb.limit_period(jnp.asarray(ang))), atol=ATOL)
    dims = r.uniform(0.2, 2, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tgb.corners_nd(torch.from_numpy(dims)).numpy(),
        np.asarray(jgb.corners_nd(jnp.asarray(dims))))


def test_box_lidar_to_camera():
    r = np.random.RandomState(1)
    boxes = r.randn(2, 30, 7).astype(np.float32)
    rect = r.randn(2, 4, 4).astype(np.float32)
    trv2c = r.randn(2, 4, 4).astype(np.float32)
    got = tgb.box_lidar_to_camera(torch.from_numpy(boxes),
                                  torch.from_numpy(rect),
                                  torch.from_numpy(trv2c)).numpy()
    for b in range(2):
        want = np.asarray(jgb.box_lidar_to_camera(
            jnp.asarray(boxes[b]), jnp.asarray(rect[b]),
            jnp.asarray(trv2c[b])))
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("yaml_name", [None, "kitti_3class.yaml"])
def test_build_anchors_exact(yaml_name):
    if yaml_name is None:
        tcfg, jcfg = TorchConfig.default(), JaxConfig.default()
    else:
        path = str(pathlib.Path(__file__).resolve().parent.parent
                   / "configs" / yaml_name)
        tcfg, jcfg = TorchConfig.from_yaml(path), JaxConfig.from_yaml(path)
    got = tanchors.build_anchors(tcfg.model)
    want = janchors.build_anchors(jcfg.model)
    for name in ("anchors", "matched_thresholds", "unmatched_thresholds",
                 "sat_corners", "standup_bv"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.sat_structured is None) == (want.sat_structured is None)
    if want.sat_structured is not None:
        for a, b in zip(got.sat_structured, want.sat_structured):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("threshold", [0.0, 1.0, 3.0])
def test_anchors_mask_from_dense_exact(structured, threshold):
    cfg = JaxConfig.default()
    aset = janchors.build_anchors(cfg.model)
    _, ny, nx = cfg.model.feature_map_size
    r = np.random.RandomState(int(threshold))
    dense = (r.uniform(size=(2, ny, nx)) < 0.05).astype(np.float32) * \
        r.randint(1, 3, (2, ny, nx)).astype(np.float32)
    s = aset.sat_structured if structured else None
    got = tanchors.anchors_mask_from_dense(
        torch.from_numpy(dense), aset.sat_corners, threshold,
        structured=s).numpy()
    for b in range(2):
        want = np.asarray(janchors.anchors_mask_from_dense(
            jnp.asarray(dense[b]), jnp.asarray(aset.sat_corners), threshold,
            structured=s))
        np.testing.assert_array_equal(got[b], want)
    assert got.any() and not got.all()
