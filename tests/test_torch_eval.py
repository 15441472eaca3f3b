"""The port's offline evaluation against pillars_tpu's on the CPU: the NumPy
copies (KITTI AP, prediction -> anno conversion, host geometry, the synthetic
generator) give the JAX package's results exactly, and the port's
``Evaluator.run`` gives the JAX ``Evaluator.run``'s annos on regenerated hard
validation scenes with the trained checkpoint at full width: names equal,
scores and locations within 1e-4 (f32 convs summed in another order, then
sigmoid and the box decode).
"""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.data import synthetic
from pillars_torch.eval import kitti_ap
from pillars_torch.eval.predict_to_anno import predictions_to_annos
from pillars_torch.geometry import np_boxes
from pillars_torch.geometry.rotated_iou import rotated_iou_np
from pillars_torch.models.detector import PillarsDetector, Predictions
from pillars_torch.train.trainer import Evaluator
from pillars_torch.weights import from_jax_variables, load_params
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.data import synthetic as jax_synthetic
from pillars_tpu.eval import kitti_ap as jax_kitti_ap
from pillars_tpu.eval.predict_to_anno import (
    predictions_to_annos as jax_predictions_to_annos)
from pillars_tpu.geometry import np_boxes as jax_np_boxes
from pillars_tpu.geometry.rotated_iou import (
    rotated_iou_np as jax_rotated_iou_np)
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from pillars_tpu.train.trainer import Evaluator as JaxEvaluator

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
ANNO_ATOL = 1e-4


def random_annos(seed, n_frames=12):
    """Ground truth and noisy detections with misses, false positives,
    occlusion levels and small boxes, so every difficulty gate bites."""
    r = np.random.RandomState(seed)
    gts, dts = [], []
    for _ in range(n_frames):
        n = r.randint(1, 5)
        loc = np.stack([np.linspace(-3, 3, n), r.uniform(1.0, 1.5, n),
                        r.uniform(2, 6, n)], 1)
        dims = np.tile([0.8, 1.7, 0.6], (n, 1)) * r.uniform(0.9, 1.1, (n, 1))
        rot = r.uniform(-np.pi, np.pi, n)
        bbox = np.zeros((n, 4))
        bbox[:, 2] = 100.0
        bbox[:, 3] = r.choice([20.0, 30.0, 200.0], n)
        gts.append({"name": np.array(["Pedestrian"] * n),
                    "truncated": r.choice([0.0, 0.2, 0.4], n),
                    "occluded": r.randint(0, 3, n), "alpha": np.zeros(n),
                    "bbox": bbox, "dimensions": dims, "location": loc,
                    "rotation_y": rot, "score": np.ones(n)})
        keep = r.uniform(size=n) > 0.2
        m = int(keep.sum()) + 1  # one false positive per frame
        d_loc = np.concatenate([loc[keep] + r.normal(0, 0.08, (m - 1, 3)),
                                [[5.0, 1.2, 9.0]]])
        d_dims = np.concatenate([dims[keep], [[0.8, 1.7, 0.6]]])
        d_rot = np.concatenate([rot[keep] + r.normal(0, 0.2, m - 1), [0.3]])
        d_bbox = np.tile([400.0, 200.0, 500.0, 400.0], (m, 1))
        dts.append({"name": np.array(["Pedestrian"] * m),
                    "truncated": np.zeros(m), "occluded": np.zeros(m, int),
                    "alpha": r.uniform(-1, 1, m), "bbox": d_bbox,
                    "dimensions": d_dims, "location": d_loc,
                    "rotation_y": d_rot, "score": r.uniform(0.1, 1.0, m)})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_ap_equals_jax_package(seed):
    gts, dts = random_annos(seed)
    want = jax_kitti_ap.get_official_eval_result(gts, dts, ["Pedestrian"],
                                                 compute_bbox=False)
    got = kitti_ap.get_official_eval_result(gts, dts, ["Pedestrian"],
                                            compute_bbox=False)
    assert got[0] == want[0]
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    assert 0.0 < np.asarray(want[2]).mean() < 100.0  # mid-curve, not trivial
    assert (kitti_ap.aggregate_eval_score(*got[2:][::-1])
            == jax_kitti_ap.aggregate_eval_score(*want[2:][::-1]))
    assert (kitti_ap.get_coco_eval_result(gts, dts, ["Pedestrian"],
                                          compute_bbox=False)[0]
            == jax_kitti_ap.get_coco_eval_result(gts, dts, ["Pedestrian"],
                                                 compute_bbox=False)[0])


def test_python_matcher_equals_native(monkeypatch):
    """With no C toolchain the loader gives None and the NumPy matcher
    serves: the same AP either way."""
    from pillars_torch import native

    gts, dts = random_annos(2)
    with_lib = kitti_ap.get_official_eval_result(gts, dts, ["Pedestrian"],
                                                 compute_bbox=False)
    monkeypatch.setattr(native, "load", lambda: None)
    assert not native.available()
    without = kitti_ap.get_official_eval_result(gts, dts, ["Pedestrian"],
                                                compute_bbox=False)
    for g, w in zip(without[2:], with_lib[2:]):
        np.testing.assert_allclose(g, w, atol=1e-9)


def test_host_geometry_copies_equal_jax_package():
    r = np.random.RandomState(3)
    b1 = np.concatenate([r.uniform(-2, 2, (7, 2)), r.uniform(0.5, 2, (7, 2)),
                         r.uniform(-3, 3, (7, 1))], 1).astype(np.float32)
    b2 = np.concatenate([r.uniform(-2, 2, (5, 2)), r.uniform(0.5, 2, (5, 2)),
                         r.uniform(-3, 3, (5, 1))], 1).astype(np.float32)
    for criterion in (-1, 0, 1, 2):
        np.testing.assert_array_equal(
            rotated_iou_np(b1, b2, criterion),
            jax_rotated_iou_np(b1, b2, criterion))
    assert rotated_iou_np(b1[:0], b2).shape == (0, 5)
    boxes = np.concatenate([r.uniform(-2, 2, (6, 3)), r.uniform(0.5, 2, (6, 3)),
                            r.uniform(-3, 3, (6, 1))], 1).astype(np.float32)
    rect = np.eye(4, dtype=np.float32)
    v2c = jax_synthetic.VELO2CAM.astype(np.float32)
    np.testing.assert_array_equal(
        np_boxes.box_camera_to_lidar(boxes, rect, v2c),
        jax_np_boxes.box_camera_to_lidar(boxes, rect, v2c))
    pts = r.uniform(-3, 3, (200, 3)).astype(np.float32)
    np.testing.assert_array_equal(np_boxes.points_in_rbbox(pts, boxes),
                                  jax_np_boxes.points_in_rbbox(pts, boxes))
    np.testing.assert_array_equal(
        np_boxes.box_collision_test(
            np_boxes.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                            boxes[:, 6]),
            np_boxes.center_to_corner_box2d(boxes[:, :2] + 0.3, boxes[:, 3:5],
                                            boxes[:, 6])),
        jax_np_boxes.box_collision_test(
            jax_np_boxes.center_to_corner_box2d(boxes[:, :2], boxes[:, 3:5],
                                                boxes[:, 6]),
            jax_np_boxes.center_to_corner_box2d(boxes[:, :2] + 0.3,
                                                boxes[:, 3:5], boxes[:, 6])))


def test_predictions_to_annos_equals_jax_package():
    r = np.random.RandomState(4)
    b, k = 3, 20
    lidar = np.concatenate([r.uniform(-1, 7, (b, k, 3)),
                            r.uniform(0.4, 2, (b, k, 3)),
                            r.uniform(-3, 3, (b, k, 1))], -1).astype(np.float32)
    preds = Predictions(lidar, lidar[..., [1, 2, 0, 4, 5, 3, 6]].copy(),
                        r.uniform(size=(b, k)).astype(np.float32),
                        np.zeros((b, k), np.int32), r.uniform(size=(b, k)) > 0.5)
    preds.valid[2] = False  # a frame without detections
    limit = Config.default().model.postprocess.post_center_limit_range
    idx = np.array([7, 8, 9])
    want = jax_predictions_to_annos(preds, idx, ["Pedestrian"], limit)
    got = predictions_to_annos(preds, idx, ["Pedestrian"], limit)
    assert len(want) == len(got) == b
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    # the port's own Predictions of tensors convert alike
    as_tensors = Predictions(*(torch.from_numpy(np.asarray(a)) for a in preds))
    again = predictions_to_annos(as_tensors, idx, ["Pedestrian"], limit)
    np.testing.assert_array_equal(again[0]["score"], want[0]["score"])


@pytest.mark.parametrize("profile", ["easy", "hard"])
def test_synthetic_generator_is_byte_equal(tmp_path, profile):
    ours = synthetic.generate_dataset(str(tmp_path / "torch"), num_train=3,
                                      num_test=2, seed=11, profile=profile)
    theirs = jax_synthetic.generate_dataset(str(tmp_path / "jax"),
                                            num_train=3, num_test=2, seed=11,
                                            profile=profile)
    n_files = 0
    for path in sorted(pathlib.Path(theirs).rglob("*")):
        if not path.is_file():
            continue
        twin = pathlib.Path(ours) / path.relative_to(theirs)
        # the info pickles hold no absolute path, so they are equal too
        assert filecmp.cmp(path, twin, shallow=False), path
        n_files += 1
    assert n_files >= 3 * 5 + 3
    assert (synthetic.split_checksum(ours)
            == synthetic.split_checksum(theirs))
    assert (synthetic.split_checksum(ours)
            != synthetic.split_checksum(ours, "training"))


def _with_dataset(cfg, root):
    for key, value in (("eval_input.dataset_root", root),
                       ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
                       ("eval_input.batch_size", 2),
                       ("eval_input.num_workers", 0),
                       ("runtime.num_devices", 1)):
        cfg = cfg.override(key, value)
    return cfg


def test_evaluator_run_equals_jax_evaluator(tmp_path):
    root = synthetic.generate_dataset(str(tmp_path / "hard"), num_train=2,
                                      num_test=6, seed=7, profile="hard")
    jcfg = _with_dataset(JaxConfig.default(), root)
    tcfg = _with_dataset(Config.default(), root)
    params, stats = jax_load_params(WEIGHTS)
    want, want_gt = JaxEvaluator(jcfg, JaxDetector(jcfg)).run(
        {"params": params, "batch_stats": stats}, progress=False)
    ev = Evaluator(tcfg, PillarsDetector(tcfg, device="cpu"),
                   measure_time=True)
    got, got_gt = ev.run(from_jax_variables(*load_params(WEIGHTS), tcfg),
                         progress=False,
                         save_path=str(tmp_path / "result.pkl"))
    assert len(want) == len(got) == len(got_gt) == len(want_gt) == 6
    assert sum(len(a["name"]) for a in want) >= 6
    for w, g in zip(want, got):
        assert list(g["name"]) == list(w["name"])
        np.testing.assert_array_equal(g["batch_idx"], w["batch_idx"])
        for key in ("score", "location", "dimensions", "rotation_y", "alpha"):
            np.testing.assert_allclose(g[key], w[key], atol=ANNO_ATOL,
                                       rtol=0, err_msg=key)
    assert (tmp_path / "result.pkl").stat().st_size > 0
    assert {"t_preprocess", "t_network", "t_predict", "t_anno",
            "t_full_sample"} <= set(ev.last_stage_ms)
    # and the score of both, through each package's own AP code
    result = ev.evaluate(from_jax_variables(*load_params(WEIGHTS), tcfg),
                         max_samples=4)
    assert result[0].startswith("Pedestrian AP@0.70")
    assert 0.0 <= result[4] <= 100.0
    assert ev.last_proxies


def test_no_annos_mode_returns_predictions_only(tmp_path):
    root = synthetic.generate_dataset(str(tmp_path / "d"), num_train=1,
                                      num_test=2, seed=1)
    cfg = _with_dataset(Config.default(), root).override(
        "eval_input.no_annos_mode", True)
    ev = Evaluator(cfg, PillarsDetector(cfg, device="cpu"))
    state = from_jax_variables(*load_params(WEIGHTS), cfg)
    dt, gt = ev.run(state, progress=False)
    assert len(dt) == 2 and gt == []
    assert ev.evaluate(state)[1:] == (0.0, 0.0, 0.0, 0.0)


def test_bn_recal_raises(tmp_path):
    cfg = Config.default().override("eval_input.bn_recal_batches", 2)
    with pytest.raises(NotImplementedError, match="bn_recal_batches"):
        Evaluator(cfg, PillarsDetector(cfg, device="cpu"))
