"""The port's loss-side geometry and target assignment
(pillars_torch/geometry/boxes.py, ops/targets.py) against pillars_tpu's on
the CPU, with the d435i anchors of Config.default().

Labels and regression weights must be equal; bbox_targets within 1e-6.
The cases: GTs with several tied anchors (force-match ties), invalid GTs,
a GT that overlaps no anchor, an empty anchors mask, rotated GTs (the
standup swap of w and l).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.geometry import boxes as tb
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.geometry import boxes as jb
from pillars_tpu.models.detector import PillarsDetector as JaxDetector

torch.set_num_threads(2)
TARGET_ATOL = 1e-6


def _boxes(r, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = r.uniform(0.3, 6.0, n)
    b[:, 1] = r.uniform(-2.4, 2.4, n)
    b[:, 2] = r.uniform(-1.8, -0.5, n)
    b[:, 3] = r.uniform(0.4, 0.9, n)
    b[:, 4] = r.uniform(0.4, 1.1, n)
    b[:, 5] = r.uniform(1.4, 1.9, n)
    b[:, 6] = r.uniform(-np.pi, np.pi, n)
    return b


def test_box_helpers_match_jax():
    r = np.random.RandomState(0)
    a, g = _boxes(r, 50), _boxes(r, 50)
    g[:10, 6] = np.pi / 4 * np.array([1, -1, 3, -3, 0, 2, -2, 4, 1, 5])
    rb = g[:, [0, 1, 3, 4, 6]]
    np.testing.assert_array_equal(
        tb.rbbox2d_to_near_bbox(torch.from_numpy(rb)).numpy(),
        np.asarray(jb.rbbox2d_to_near_bbox(jnp.asarray(rb))))
    s1 = np.asarray(jb.rbbox2d_to_near_bbox(jnp.asarray(a[:, [0, 1, 3, 4, 6]])))
    s2 = np.array(jb.rbbox2d_to_near_bbox(jnp.asarray(rb)))
    s2[:5] = s1[:5]  # identical boxes: IoU 1
    for eps in (0.0, 1.0):
        np.testing.assert_array_equal(
            tb.iou_matrix(torch.from_numpy(s1), torch.from_numpy(s2),
                          eps).numpy(),
            np.asarray(jb.iou_matrix(jnp.asarray(s1), jnp.asarray(s2), eps)))
    a[:, 3:6] = np.abs(a[:, 3:6])
    np.testing.assert_allclose(
        tb.second_box_encode(torch.from_numpy(g), torch.from_numpy(a)).numpy(),
        np.asarray(jb.second_box_encode(jnp.asarray(g), jnp.asarray(a))),
        rtol=1e-6, atol=1e-6)
    for got, want in zip(
            tb.add_sin_difference(torch.from_numpy(g), torch.from_numpy(a)),
            jb.add_sin_difference(jnp.asarray(g), jnp.asarray(a))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def detectors():
    cfg_kw = (("model.target.max_gt_boxes", 6),)
    jcfg, tcfg = JaxConfig.default(), TorchConfig.default()
    for k, v in cfg_kw:
        jcfg, tcfg = jcfg.override(k, v), tcfg.override(k, v)
    return JaxDetector(jcfg), TorchDetector(tcfg, device="cpu")


def _case(seed, anchors, n_anchor):
    """gt [B=3, 6, 7] with ties, invalid and zero-overlap rows; masks with
    an empty sample."""
    r = np.random.RandomState(seed)
    b, g = 3, 6
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., 3:6] = 1.0
    gt_cls = np.ones((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        gt[i, :4] = _boxes(r, 4)
        valid[i, :4] = True
    # sample 0: GTs larger than the anchors: every anchor inside gives the
    # same overlap, so the force-match takes hundreds of tied anchors
    gt[0, 0] = [3.2, 0.0, -1.5, 2.0, 2.0, 1.7, 0.0]
    gt[0, 2] = [4.5, -1.0, -1.5, 1.0, 1.0, 1.7, 0.0]
    # a GT far outside the grid: zero overlap with every anchor
    gt[0, 1, :2] = [50.0, 50.0]
    # an invalid GT that overlaps: must not count
    gt[0, 4] = _boxes(r, 1)[0]
    # sample 1: a GT on an anchor, turned by pi/2 (w and l swap)
    k = 2 * (32 * 80 + 30)
    gt[1, 0] = anchors[k]
    gt[1, 0, 6] = np.pi / 2
    amask = r.uniform(size=(b, n_anchor)) > 0.2
    amask[2] = False  # empty anchors mask
    return gt, gt_cls, valid, amask


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_targets_match_jax(detectors, seed):
    jdet, tdet = detectors
    anchors = jdet.anchor_set.anchors
    gt, gt_cls, valid, amask = _case(seed, anchors, anchors.shape[0])
    want = jax.jit(jdet.assign_targets)(
        jnp.asarray(gt), jnp.asarray(gt_cls), jnp.asarray(valid),
        jnp.asarray(amask))
    got = tdet.assign_targets(torch.from_numpy(gt), torch.from_numpy(gt_cls),
                              torch.from_numpy(valid),
                              torch.from_numpy(amask))
    labels = np.asarray(want.labels)
    assert got.bbox_targets.shape == (3, 7, anchors.shape[0])
    np.testing.assert_array_equal(got.labels.numpy(), labels)
    np.testing.assert_array_equal(got.reg_weights.numpy(),
                                  np.asarray(want.reg_weights))
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets),
                               rtol=0, atol=TARGET_ATOL)
    # the case covers what it claims
    assert (labels[2] == -1).all()              # empty mask: all don't care
    assert (labels[0] > 0).sum() >= 100         # the tied anchors are all in
    assert (labels == 0).any() and (labels > 0).any()
