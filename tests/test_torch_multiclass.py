"""The multi-class (3-class KITTI-style) model in the port against the JAX
package (tests/test_multiclass.py's config and cases): anchor interleaving
and per-anchor thresholds equal, head shapes and values, postprocess labels
and the loss, on the CPU.

Tolerances: heads within 1e-4 of their max |value| (the same f32 convs
summed in another order); postprocess equal in labels and validity, scores
within 1e-5 and boxes within 1e-4; targets equal; loss parts within 1e-5
relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.ops.anchors import build_anchors
from pillars_torch.weights import from_jax_variables, to_jax_variables
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.ops.anchors import build_anchors as jax_build_anchors
from test_multiclass import small_3class_config
from torch_parity import randomize_variables

torch.set_num_threads(2)
LOSS_RTOL = 1e-5


def _configs():
    jcfg = small_3class_config()
    tcfg = TorchConfig.default()
    gens = [dataclasses.asdict(g)
            for g in jcfg.model.target.anchor_generators]
    for key, value in (("model.num_class", 3),
                       ("model.class_names", ["Car", "Pedestrian", "Cyclist"]),
                       ("model.voxel.max_voxels", 1024),
                       ("model.voxel.max_points", 4096),
                       ("model.target.anchor_generators", gens)):
        tcfg = tcfg.override(key, value)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def test_anchors_and_thresholds_match_jax():
    jcfg, tcfg = _configs()
    got, want = build_anchors(tcfg.model), jax_build_anchors(jcfg.model)
    for field in ("anchors", "standup_bv", "matched_thresholds",
                  "unmatched_thresholds"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.anchors.shape == (64 * 80 * 6, 7)
    first6 = got.anchors[:6]
    np.testing.assert_allclose(first6[[0, 2, 4], 3:6],
                               [[1.6, 3.9, 1.56], [0.6, 0.8, 1.73],
                                [0.6, 1.76, 1.73]], rtol=1e-6)
    np.testing.assert_allclose(first6[[1, 3, 5], 6], 1.57)
    np.testing.assert_allclose(got.matched_thresholds[:6],
                               [0.6, 0.6, 0.5, 0.5, 0.5, 0.5])
    assert tcfg.model.num_anchors_per_loc == 6
    assert tcfg.model.num_anchors == 64 * 80 * 6


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    tdet = TorchDetector(tcfg, device="cpu")
    params, stats = to_jax_variables(tdet.init(
        torch.Generator().manual_seed(0)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed=8)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    return dict(jdet=JaxDetector(jcfg), tdet=tdet, variables=variables,
                state=state)


def _clouds(b, n=1000):
    r = np.random.RandomState(b)
    pts = np.zeros((b, 4096, 3), np.float32)
    pts[:, :n, 0] = r.uniform(0.2, 6.2, (b, n))
    pts[:, :n, 1] = r.uniform(-2.4, 2.4, (b, n))
    pts[:, :n, 2] = r.uniform(-2.5, 0.5, (b, n))
    return pts, np.full((b,), n, np.int32)


def test_head_shapes_and_values(models):
    pts, num = _clouds(2)
    jdet, tdet = models["jdet"], models["tdet"]
    jv = jax.jit(jdet.voxelize_batch)(jnp.asarray(pts), jnp.asarray(num))
    want = jax.device_get(jax.jit(lambda v, x: jdet.apply(v, x))(
        models["variables"], jv))
    with torch.no_grad():
        tv = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
        got = tdet.apply(models["state"], tv)
    shapes = {"box_preds": 42, "cls_preds": 18, "dir_cls_preds": 12}
    assert set(got) == set(want) == set(shapes)
    for key, ch in shapes.items():
        assert got[key].shape == want[key].shape == (2, 64, 80, ch), key
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


def test_postprocess_labels(models):
    """One activated pedestrian anchor (class 1) among six per location:
    the label, score and decoded box of the JAX package."""
    jdet, tdet = models["jdet"], models["tdet"]
    ny, nx = tdet.ny, tdet.nx
    cls = np.full((1, ny, nx, 18), -10.0, np.float32)
    box = np.zeros((1, ny, nx, 42), np.float32)
    dirp = np.zeros((1, ny, nx, 12), np.float32)
    yy, xx, a = 5, 7, 2
    cls[0, yy, xx, a * 3 + 1] = 5.0
    cls[0, 20, 30, 4 * 3 + 2] = 3.0  # a cyclist anchor
    preds = {"box_preds": box, "cls_preds": cls, "dir_cls_preds": dirp}
    n_anchor = tdet.anchors.shape[0]
    eye = np.eye(4, dtype=np.float32)[None]
    want = jax.device_get(jax.jit(jdet.postprocess)(
        {k: jnp.asarray(v) for k, v in preds.items()},
        jnp.ones((1, n_anchor), bool), jnp.asarray(eye), jnp.asarray(eye)))
    got = tdet.postprocess({k: torch.from_numpy(v) for k, v in preds.items()},
                           torch.ones((1, n_anchor), dtype=torch.bool),
                           torch.from_numpy(eye), torch.from_numpy(eye))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy()[v],
                                  np.asarray(want.labels)[v])
    assert list(got.labels.numpy()[0, :2]) == [1, 2]
    assert got.scores[0, 0] == pytest.approx(1 / (1 + np.exp(-5.0)),
                                             rel=1e-4)
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], atol=1e-5)
    np.testing.assert_allclose(got.boxes_lidar.numpy()[v],
                               np.asarray(want.boxes_lidar)[v], atol=1e-4)
    np.testing.assert_allclose(
        got.boxes_lidar[0, 0, 3:6].numpy(),
        tdet.anchors[(yy * nx + xx) * 6 + a, 3:6].numpy(), rtol=1e-4)


def test_targets_and_loss(models):
    """A car and a pedestrian per sample: targets of both classes equal to
    the JAX package's, and every loss part within 1e-5 relative."""
    jdet, tdet = models["jdet"], models["tdet"]
    pts, num = _clouds(2, 800)
    gt = np.zeros((2, 8, 7), np.float32)
    gt[..., 3:6] = 1.0
    gt[:, 0] = [3.0, 0.0, -1.78, 1.6, 3.9, 1.56, 0.1]
    gt[:, 1] = [1.5, 1.0, -1.465, 0.6, 0.8, 1.73, 0.5]
    gt_classes = np.ones((2, 8), np.int32)
    gt_classes[:, 1] = 2
    gt_valid = np.zeros((2, 8), bool)
    gt_valid[:, :2] = True

    def jax_side(variables, pts, num, gt, gt_classes, gt_valid):
        vox = jdet.voxelize_batch(pts, num)
        amask = jdet.anchors_mask_batch(vox.coords, vox.pillar_mask, 1.0)
        t = jdet.assign_targets(gt, gt_classes, gt_valid, amask)
        out = jdet.loss(jdet.apply(variables, vox), t.labels,
                        t.bbox_targets)
        return t.labels, out

    labels, want = jax.device_get(jax.jit(jax_side)(
        models["variables"], *(jnp.asarray(a) for a in
                               (pts, num, gt, gt_classes, gt_valid))))
    with torch.no_grad():
        tv = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
        amask = tdet.anchors_mask_batch(tv.coords, tv.pillar_mask, 1.0)
        t = tdet.assign_targets(*(torch.from_numpy(a) for a in
                                  (gt, gt_classes, gt_valid)), amask)
        got = tdet.loss(tdet.apply(models["state"], tv), t.labels,
                        t.bbox_targets)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(labels))
    assert (t.labels.numpy() == 1).any() and (t.labels.numpy() == 2).any()
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    assert np.isfinite(float(got.loss))
