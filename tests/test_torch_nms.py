"""Port NMS and postprocess against the JAX package, ties included.

The keep mask is integer logic over the same f32 IoU arithmetic: exact.
Postprocess outputs: valid/labels and the selected slots exact; boxes and
scores to a few f32 ulp (exp/sin/cos from different libraries).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.ops.nms import keep_mask_plain, nms_standup
from pillars_torch.utils import tracing
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.ops import nms as jnms
from pillars_tpu.ops.nms_pallas import nms_keep_mask_pallas
from torch_parity import standup_box_sets

torch.set_num_threads(2)


def _lax_keep_mask(boxes_s, valid_s, thresh):
    """The lax branch of pillars_tpu/ops/nms.py::nms_standup."""
    k = boxes_s.shape[0]
    iou = jnms._pixel_iou_matrix(boxes_s)
    overlap = (iou > thresh) & valid_s[:, None] & valid_s[None, :]

    def body(i, kept):
        suppressed = jnp.any(overlap[:, i] & kept & (jnp.arange(k) < i))
        return kept.at[i].set(valid_s[i] & ~suppressed)

    return jax.lax.fori_loop(0, k, body, jnp.zeros((k,), dtype=bool))


@pytest.mark.parametrize("k", [100, 128])
@pytest.mark.parametrize("thr", [0.3, 0.5])
def test_keep_mask_plain_matches_lax_and_pallas(k, thr):
    boxes, _, valid = standup_box_sets(k, 3, k)
    got = keep_mask_plain(torch.from_numpy(boxes), torch.from_numpy(valid),
                          thr).numpy()
    for i in range(3):
        bj, vj = jnp.asarray(boxes[i]), jnp.asarray(valid[i])
        np.testing.assert_array_equal(got[i], np.asarray(
            _lax_keep_mask(bj, vj, thr)))
        np.testing.assert_array_equal(got[i], np.asarray(
            nms_keep_mask_pallas(bj, vj, thr, interpret=True)))
    assert got.any() and not got[valid].all()


@pytest.mark.parametrize("post", [20, 50])
def test_nms_standup_matches_jax_with_tied_scores(post):
    boxes, scores, valid = standup_box_sets(post, 2, 100)
    idx, ok = nms_standup(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(valid), 0.5, post)
    for i in range(2):
        want_idx, want_ok = jnms.nms_standup(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), 0.5, post)
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(want_ok))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))


def test_postprocess_ties_with_saturated_scores():
    """Many cls logits large enough that sigmoid is exactly 1.0 in f32: the
    top-k and NMS order among equal scores must follow the JAX package
    (lower anchor index first in top-k; reversed ascending argsort in
    NMS)."""
    jcfg, tcfg = JaxConfig.default(), TorchConfig.default()
    _, ny, nx = jcfg.model.feature_map_size
    T = jcfg.model.num_anchors_per_loc
    r = np.random.RandomState(0)
    b = 2
    box = (r.randn(b, ny, nx, T * 7) * 0.3).astype(np.float32)
    cls = r.randn(b, ny, nx, T).astype(np.float32) - 4.0
    hot = r.uniform(size=cls.shape) < 0.02
    cls[hot] = 40.0  # sigmoid(40) == 1.0 in f32
    dirc = r.randn(b, ny, nx, T * 2).astype(np.float32)
    amask = r.uniform(size=(b, ny * nx * T)) < 0.9
    rect = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    trv2c = rect + r.randn(b, 4, 4).astype(np.float32) * 0.01
    assert (1 / (1 + np.exp(-cls[hot].astype(np.float32))) == 1.0).all()
    assert hot.reshape(b, -1).sum(1).min() > 100  # more ties than top-k

    preds = {"box_preds": box, "cls_preds": cls, "dir_cls_preds": dirc}
    want = JaxDetector(jcfg).postprocess(
        {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(amask),
        jnp.asarray(rect), jnp.asarray(trv2c))
    got = TorchDetector(tcfg, device="cpu").postprocess(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        torch.from_numpy(amask), torch.from_numpy(rect),
        torch.from_numpy(trv2c))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy()[v],
                                  np.asarray(want.labels)[v])
    np.testing.assert_array_equal(got.scores.numpy()[v],
                                  np.asarray(want.scores)[v])
    for name in ("boxes_lidar", "boxes_camera"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=1e-6, atol=2e-6, err_msg=name)
    assert (np.asarray(want.scores)[v] == 1.0).sum() > 10


def test_keep_mask_wrapper_on_cpu_takes_the_plain_twin():
    from pillars_torch.ops import nms_cuda

    boxes, _, valid = standup_box_sets(3, 2, 40)
    before = tracing.counters()["nms_keep_mask.launches"]
    got = nms_cuda.nms_keep_mask(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), 0.5)
    # no kernel launched
    assert tracing.counters()["nms_keep_mask.launches"] == before
    assert torch.equal(got, keep_mask_plain(torch.from_numpy(boxes),
                                            torch.from_numpy(valid), 0.5))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    import shutil

    import torch.utils.cpp_extension as cpp_extension

    from pillars_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("nms_keep_mask")
