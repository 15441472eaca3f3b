"""The port's point-major inference paths against pillars_tpu's on the CPU.

Fast path (``pfn.dense_cell`` false, ``rpn.use_pallas_blocks`` true): the
port's ``make_inference_fn`` (the fused blocks' plain twin on the CPU)
against the JAX package's ``voxelize_batch`` -> ``anchors_mask_batch`` ->
``_forward_fast`` -> ``postprocess``, with the Pallas blocks in interpret
mode, for a reduced random-init model at B=1 and B=2 and for the trained
checkpoint at full width at B=1. Non-fast point-major path
(``use_pallas_blocks`` false): against the JAX package's
``make_inference_fn``.

Tolerances are those of the dense-cell path (``torch_parity.
compare_predictions``): valid and labels equal, scores 1e-5, boxes 1e-4
plus 2e-5 relative.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.weights import from_jax_variables, load_params
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.ops import rpn_pallas
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import (compare_predictions, d435i_clouds, fast_config,
                          randomize_variables, small_config)

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")


def _inputs(batch, maxpts, n, seed):
    pts, num = d435i_clouds(seed, batch, maxpts, n)
    rect = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    return pts, num, rect, trv2c


def _jax_fast(jcfg, variables, pts, num, rect, trv2c, monkeypatch):
    """The JAX package's fast path, its Pallas blocks in interpret mode."""
    monkeypatch.setattr(rpn_pallas, "fused_rpn_blocks", functools.partial(
        rpn_pallas.fused_rpn_blocks, interpret=True))
    det = JaxDetector(jcfg)
    thr = jcfg.eval_input.anchor_area_threshold

    @jax.jit
    def run(p, n, r, t):
        v = det.voxelize_batch(p, n)
        amask = det.anchors_mask_batch(v.coords, v.pillar_mask, thr)
        return det.postprocess(det._forward_fast(variables, v), amask, r, t)

    return jax.device_get(run(pts, num, rect, trv2c))


def _torch_run(tcfg, state, pts, num, rect, trv2c):
    det = TorchDetector(tcfg, device="cpu")
    assert det.fast == tcfg.model.rpn.use_pallas_blocks
    out = det.make_inference_fn()(state, *map(torch.from_numpy,
                                              (pts, num, rect, trv2c)))
    assert out.boxes_lidar.shape == (
        pts.shape[0], tcfg.model.postprocess.nms_post_max_size, 7)
    return out


def _small_variables(jcfg):
    det = JaxDetector(jcfg)
    return randomize_variables(jax.device_get(det.init(jax.random.PRNGKey(0))),
                               seed=11)


@pytest.mark.parametrize("batch", [1, 2])
def test_fast_path_reduced_random_init(batch, monkeypatch):
    jcfg = fast_config(small_config(JaxConfig))
    tcfg = fast_config(small_config(TorchConfig))
    variables = _small_variables(jcfg)
    state = from_jax_variables(variables["params"],
                               variables["batch_stats"], tcfg)
    args = _inputs(batch, jcfg.model.voxel.max_points, 1800, seed=batch)
    want = _jax_fast(jcfg, variables, *args, monkeypatch)
    compare_predictions(want, _torch_run(tcfg, state, *args))


def test_fast_path_trained_weights_full_width(monkeypatch):
    jcfg, tcfg = fast_config(JaxConfig.default()), fast_config(
        TorchConfig.default())
    params, stats = jax_load_params(WEIGHTS)
    variables = {"params": params, "batch_stats": stats}
    state = from_jax_variables(*load_params(WEIGHTS), tcfg)
    args = _inputs(1, jcfg.model.voxel.max_points, 19200, seed=0)
    want = _jax_fast(jcfg, variables, *args, monkeypatch)
    compare_predictions(want, _torch_run(tcfg, state, *args))


@pytest.mark.parametrize("batch", [1, 2])
def test_point_major_apply_path(batch):
    jcfg = small_config(JaxConfig).override("model.pfn.dense_cell", False)
    tcfg = small_config(TorchConfig).override("model.pfn.dense_cell", False)
    variables = _small_variables(jcfg)
    state = from_jax_variables(variables["params"],
                               variables["batch_stats"], tcfg)
    args = _inputs(batch, jcfg.model.voxel.max_points, 1800, seed=5 + batch)
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        variables, *args))
    compare_predictions(want, _torch_run(tcfg, state, *args))


def test_fast_path_folds_the_blocks_once_per_state():
    """The detector keeps the folded blocks while it is given the same
    state: a second cloud folds nothing, a changed state folds again, and
    the predictions are those of a detector that never saw the old state."""
    tcfg = fast_config(small_config(TorchConfig))
    jcfg = fast_config(small_config(JaxConfig))
    variables = _small_variables(jcfg)
    state = from_jax_variables(variables["params"],
                               variables["batch_stats"], tcfg)
    det = TorchDetector(tcfg, device="cpu")
    fn = det.make_inference_fn()
    clouds = [tuple(map(torch.from_numpy, _inputs(
        1, tcfg.model.voxel.max_points, 1800, seed=s))) for s in (3, 4)]
    first = [fn(state, *c) for c in clouds]
    assert det.folded_blocks.folds == 1
    state["rpn.block2.bn0.weight"].mul_(0.5)
    second = [fn(state, *c) for c in clouds]
    assert det.folded_blocks.folds == 2
    fresh = TorchDetector(tcfg, device="cpu").make_inference_fn()
    for got, c in zip(second, clouds):
        want = fresh(state, *c)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert any(not torch.equal(a.scores, b.scores)
               for a, b in zip(first, second))
