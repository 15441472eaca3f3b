"""``configs/kitti_3class.yaml`` in the port: the full 432 x 496 grid (3
classes, 1.29M anchors) end to end at B=1 as tests/test_kitti_scale.py runs
it, and a reduced copy against the JAX package at B=2.

The reduced copy keeps what makes the config: the big-grid voxelizer branch
(more cells than ``max_voxels``), 4 point features, 32 points per pillar,
NMS 1000 / 300 at score 0.05, the three interleaved classes, ``rpn.remat``
and the class-bias prior; it narrows the PFN and the RPN, shortens the point
pad and the pillar budget. Held by ``compare_predictions`` (tests/
torch_parity.py), targets equal and loss parts within 1e-5 relative, with
plain and with separable convs. (It found the port's multi-class positive
loss split summing a strided slice 7e-5 off; models/losses.py copies it.)
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.weights import from_jax_variables, to_jax_variables
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from torch_parity import compare_predictions, randomize_variables

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
YAML = str(ROOT / "configs" / "kitti_3class.yaml")
LOSS_RTOL = 1e-5


def _kitti_clouds(seed, b, maxpts, n):
    """b clouds of n points over the KITTI range with intensity, one car-
    and one pedestrian-sized clump each; zero padding after n."""
    r = np.random.RandomState(seed)
    pts = np.zeros((b, maxpts, 4), np.float32)
    gt = np.zeros((b, 4, 7), np.float32)
    gt[..., 3:6] = 1.0
    for i in range(b):
        boxes = np.array([[r.uniform(10, 40), r.uniform(-15, 15), -1.0, 1.6,
                           3.9, 1.56, r.uniform(-3, 3)],
                          [r.uniform(5, 30), r.uniform(-10, 10), -0.8, 0.6,
                           0.8, 1.73, r.uniform(-3, 3)]], np.float32)
        gt[i, :2] = boxes
        parts = [np.stack([bx[0] + r.uniform(-bx[3] / 2, bx[3] / 2, 400),
                           bx[1] + r.uniform(-bx[4] / 2, bx[4] / 2, 400),
                           bx[2] + r.uniform(-bx[5] / 2, bx[5] / 2, 400)], 1)
                 for bx in boxes]
        m = n - 800
        parts.append(np.stack([r.uniform(0, 69, m), r.uniform(-39, 39, m),
                               r.uniform(-2.5, 0.5, m)], 1))
        cloud = r.permutation(np.concatenate(parts))
        pts[i, :n, :3] = cloud
        pts[i, :n, 3] = r.uniform(0, 1, n)
    classes = np.tile(np.array([[1, 2, 1, 1]], np.int32), (b, 1))
    valid = np.zeros((b, 4), bool)
    valid[:, :2] = True
    return pts, np.full((b,), n, np.int32), gt, classes, valid


def test_full_grid_inference():
    cfg = (TorchConfig.from_yaml(YAML)
           .override("model.voxel.max_points", 16384)
           .override("model.voxel.max_voxels", 8000)
           .override("model.postprocess.nms_pre_max_size", 128)
           .override("model.postprocess.nms_post_max_size", 64))
    det = TorchDetector(cfg, device="cpu")
    assert det.anchors.shape == (432 * 496 * 6, 7)
    assert cfg.model.voxel.grid_size == (432, 496, 1)
    assert not det.dense_cell  # the big grid's point-major path
    state = det.init(torch.Generator().manual_seed(0))
    pts, num, *_ = _kitti_clouds(0, 1, 16384, 8000)
    eye = torch.eye(4)[None]
    out = det.make_inference_fn()(state, torch.from_numpy(pts),
                                  torch.from_numpy(num), eye, eye)
    assert out.boxes_lidar.shape == (1, 64, 7)
    assert torch.isfinite(out.scores).all()
    assert out.valid.dtype == torch.bool


REDUCED = (("model.pfn.num_filters", 16),
           ("model.rpn.layer_nums", [1, 1, 1]),
           ("model.rpn.num_filters", [16, 16, 32]),
           ("model.rpn.num_upsample_filters", [16, 16, 16]),
           ("model.voxel.max_points", 8192),
           ("model.voxel.max_voxels", 3000),
           ("model.target.max_gt_boxes", 4))


@pytest.mark.parametrize("separable", [False, True])
def test_reduced_config_against_jax(separable):
    jcfg, tcfg = JaxConfig.from_yaml(YAML), TorchConfig.from_yaml(YAML)
    for key, value in REDUCED + (("model.rpn.use_separable_conv",
                                  separable),):
        jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
    vcfg = tcfg.model.voxel
    gx, gy, gz = vcfg.grid_size
    assert gx * gy * gz > vcfg.max_voxels  # the big-grid branch
    assert (tcfg.model.num_point_features, vcfg.max_points_per_voxel) == (4,
                                                                         32)
    pp = tcfg.model.postprocess
    assert (pp.nms_pre_max_size, pp.nms_post_max_size,
            pp.nms_score_threshold) == (1000, 300, 0.05)
    tdet = TorchDetector(tcfg, device="cpu")
    params, stats = to_jax_variables(tdet.init(
        torch.Generator().manual_seed(1)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed=9)
    # the box head scaled into a trained head's range: random-init box
    # encodings reach O(60), and exp() of them multiplies the f32 rounding
    # of the convs by 60, past compare_predictions' relative tolerance
    variables["params"]["rpn"]["conv_box"]["kernel"] *= 0.05
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    pts, num, gt, classes, valid = _kitti_clouds(3, 2, 8192, 6000)
    rect = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    jdet = JaxDetector(jcfg)
    want = jax.device_get(jdet.make_inference_fn()(variables, pts, num,
                                                    rect, trv2c))
    got = tdet.make_inference_fn()(state, *(torch.from_numpy(a) for a in
                                            (pts, num, rect, trv2c)))
    assert got.boxes_lidar.shape == (2, 300, 7)
    compare_predictions(want, got)
    assert len(np.unique(np.asarray(want.labels)[np.asarray(want.valid)])
               ) > 1

    thr = tcfg.train_input.anchor_area_threshold

    def jax_side(variables, pts, num, gt, classes, valid):
        vox = jdet.voxelize_batch(pts, num)
        amask = jdet.anchors_mask_batch(vox.coords, vox.pillar_mask, thr)
        t = jdet.assign_targets(gt, classes, valid, amask)
        return t.labels, jdet.loss(jdet.apply(variables, vox), t.labels,
                                   t.bbox_targets)

    labels, jloss = jax.device_get(jax.jit(jax_side)(
        variables, *(jnp.asarray(a) for a in (pts, num, gt, classes,
                                              valid))))
    with torch.no_grad():
        tv = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
        amask = tdet.anchors_mask_batch(tv.coords, tv.pillar_mask, thr)
        t = tdet.assign_targets(*(torch.from_numpy(a) for a in
                                  (gt, classes, valid)), amask)
        tloss = tdet.loss(tdet.apply(state, tv), t.labels, t.bbox_targets)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(labels))
    assert (t.labels.numpy() == 1).any() and (t.labels.numpy() == 2).any()
    for name, g, w in zip(tloss._fields, tloss, jloss):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
