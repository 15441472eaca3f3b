"""The port's make_inference_fn against pillars_tpu's on the same clouds and
weights, on the CPU: a reduced random-init model and the trained d435i
checkpoint at Config.default() widths (reduced point pad), B=1 and B=2.

valid and labels must be equal; scores and boxes on valid slots within the
tolerances of ``torch_parity.compare_predictions``.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.weights import (from_jax_variables, load_params,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import (compare_predictions, d435i_clouds,
                          randomize_variables, small_config)

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
def _run_both(jcfg, tcfg, variables, state, batch, n, seed):
    maxpts = jcfg.model.voxel.max_points
    pts, num = d435i_clouds(seed, batch, maxpts, n)
    rect = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        variables, pts, num, rect, trv2c))
    fn = TorchDetector(tcfg, device="cpu").make_inference_fn()
    got = fn(state, torch.from_numpy(pts), torch.from_numpy(num),
             torch.from_numpy(rect), torch.from_numpy(trv2c))
    assert got.boxes_lidar.shape == (
        batch, tcfg.model.postprocess.nms_post_max_size, 7)
    return want, got


@pytest.mark.parametrize("batch", [1, 2])
def test_inference_reduced_random_init(batch):
    jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
    det = JaxDetector(jcfg)
    variables = randomize_variables(
        jax.device_get(det.init(jax.random.PRNGKey(0))), seed=11)
    state = from_jax_variables(variables["params"],
                               variables["batch_stats"], tcfg)
    want, got = _run_both(jcfg, tcfg, variables, state, batch, 1800,
                          seed=batch)
    compare_predictions(want, got)


@pytest.mark.parametrize("batch", [1, 2])
def test_inference_default_widths_trained_weights(batch):
    jcfg = JaxConfig.default().override("model.voxel.max_points", 4096)
    tcfg = TorchConfig.default().override("model.voxel.max_points", 4096)
    params, stats = jax_load_params(WEIGHTS)
    variables = {"params": params, "batch_stats": stats}
    state = from_jax_variables(*load_params(WEIGHTS), tcfg)
    want, got = _run_both(jcfg, tcfg, variables, state, batch, 4000,
                          seed=10 + batch)
    compare_predictions(want, got)


def test_other_front_ends_and_compute_dtypes(tmp_path):
    """The front ends that raised before SECOND's slice run against the
    JAX package (the dense [P, N, D] layout, SimpleVoxel on either
    voxelizer); bfloat16 builds a Trainer and a train-mode apply returns
    bfloat16 heads and float32 statistics (held against the JAX package in
    tests/test_torch_bf16_train.py); a compute dtype that is neither
    float32 nor bfloat16 raises."""
    for key, value, pointwise in (("model.pfn.pointwise", False, False),
                                  ("model.pfn.simple_mean", True, True),
                                  ("model.pfn.simple_mean", True, False)):
        jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
        for k, v in (("model.pfn.dense_cell", False),
                     ("model.pfn.pointwise", pointwise), (key, value)):
            jcfg, tcfg = jcfg.override(k, v), tcfg.override(k, v)
        # the tree's structure from the port's init (flax's runs eagerly)
        params, stats = to_jax_variables(TorchDetector(
            tcfg, device="cpu").init(torch.Generator().manual_seed(0)))
        variables = randomize_variables(
            {"params": params, "batch_stats": stats}, seed=12)
        state = from_jax_variables(variables["params"],
                                   variables["batch_stats"], tcfg)
        want, got = _run_both(jcfg, tcfg, variables, state, 2, 1800, seed=6)
        compare_predictions(want, got)
    from pillars_torch.train.trainer import Trainer

    cfg = TorchConfig.default().override("runtime.compute_dtype", "bfloat16")
    det = TorchDetector(cfg, device="cpu")
    assert det.dtype == torch.bfloat16
    from pillars_torch.data import synthetic

    root = synthetic.generate_dataset(str(tmp_path / "data"), num_train=2,
                                      num_test=1, seed=0)
    tcfg = cfg
    for key, value in (
            ("train_input.dataset_root", root),
            ("train_input.info_path", f"{root}/kitti_infos_train.pkl"),
            ("train_input.sampler.info_path",
             f"{root}/kitti_dbinfos_train.pkl"),
            ("eval_input.dataset_root", root),
            ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
            ("out_dir", str(tmp_path / "runs"))):
        tcfg = tcfg.override(key, value)
    trainer = Trainer(tcfg, device="cpu")
    assert trainer.detector.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32
               for p in trainer.state.params.values())
    pts, num = d435i_clouds(3, 1, cfg.model.voxel.max_points, 500)
    v = det.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    preds, stats = det.apply(det.init(torch.Generator().manual_seed(0)), v,
                             train=True)
    assert all(t.dtype == torch.bfloat16 for t in preds.values())
    assert all(t.dtype == torch.float32 for t in stats.values()
               if t.is_floating_point())
    with pytest.raises(ValueError, match="compute_dtype"):
        TorchDetector(cfg.override("runtime.compute_dtype", "float16"),
                      device="cpu")


def test_no_card_without_explicit_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TorchDetector(TorchConfig.default())


def test_point_major_entry_points_on_the_default_config():
    """The default (dense-cell) config still has the point-major network
    that the JAX package trains through: ``voxelize_batch``,
    ``anchors_mask_batch`` and ``apply`` give the JAX package's outputs on
    ``Config.default()`` (max_points cut), B=2. Heads within 1e-4 of their
    max |value|; the anchors mask equal. A config of the dense-layout
    front end keeps its dense-cell inference, and its voxelization and
    apply are the JAX package's."""
    jcfg = JaxConfig.default().override("model.voxel.max_points", 2048)
    tcfg = TorchConfig.default().override("model.voxel.max_points", 2048)
    jdet, tdet = JaxDetector(jcfg), TorchDetector(tcfg, device="cpu")
    assert jdet.dense_cell and tdet.dense_cell
    variables = randomize_variables(
        jax.device_get(jdet.init(jax.random.PRNGKey(0))), seed=21)
    state = from_jax_variables(variables["params"],
                               variables["batch_stats"], tcfg)
    pts, num = d435i_clouds(4, 2, 2048, 1900)
    thr = jcfg.eval_input.anchor_area_threshold
    jv = jdet.voxelize_batch(pts, num)
    want = jax.device_get(jdet.apply(variables, jv))
    want_mask = np.asarray(jdet.anchors_mask_batch(jv.coords,
                                                   jv.pillar_mask, thr))
    tv = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    with torch.no_grad():
        got = tdet.apply(state, tv)
    np.testing.assert_array_equal(
        tdet.anchors_mask_batch(tv.coords, tv.pillar_mask, thr).numpy(),
        want_mask)
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    # a dense-cell config of the dense-layout front end: inference stays on
    # the dense cell, apply runs PillarFeatureNet, both as the JAX package's
    jcfg = jcfg.override("model.pfn.pointwise", False)
    other = tcfg.override("model.pfn.pointwise", False)
    det, jdet = TorchDetector(other, device="cpu"), JaxDetector(jcfg)
    assert det.dense_cell and jdet.dense_cell
    jv = jax.jit(jdet.voxelize_batch)(pts, num)
    tv = det.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    for name, g, w in zip(jv._fields, tv, jax.device_get(jv)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    want = jax.device_get(jax.jit(jdet.apply)(variables, jv))
    with torch.no_grad():
        got = det.apply(state, tv)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
