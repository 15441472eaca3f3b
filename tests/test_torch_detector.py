"""The port's make_inference_fn against pillars_tpu's on the same clouds and
weights, on the CPU: a reduced random-init model and the trained d435i
checkpoint at Config.default() widths (reduced point pad), B=1 and B=2.

valid and labels must be equal. Scores and boxes on valid slots agree to
float32 rounding accumulated through the network (the same convs summed in
another order): SCORE_ATOL, and BOX_ATOL plus BOX_RTOL (random-init
encodings reach exp() of large values, so boxes of 1e5 m occur there).
"""

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
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import d435i_clouds, randomize_variables, small_config

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
SCORE_ATOL = 1e-5
BOX_ATOL = 1e-4
BOX_RTOL = 2e-5


def _compare(want, got):
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy()[v],
                                  np.asarray(want.labels)[v])
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], atol=SCORE_ATOL)
    for name in ("boxes_lidar", "boxes_camera"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=BOX_RTOL, atol=BOX_ATOL,
                                   err_msg=name)


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
    _compare(want, got)


@pytest.mark.parametrize("batch", [1, 2])
def test_inference_default_widths_trained_weights(batch):
    jcfg = JaxConfig.default().override("model.voxel.max_points", 4096)
    tcfg = TorchConfig.default().override("model.voxel.max_points", 4096)
    params, stats = jax_load_params(WEIGHTS)
    variables = {"params": params, "batch_stats": stats}
    state = from_jax_variables(*load_params(WEIGHTS), tcfg)
    want, got = _run_both(jcfg, tcfg, variables, state, batch, 4000,
                          seed=10 + batch)
    _compare(want, got)


def test_unported_configs_raise():
    cfg = TorchConfig.default().override("model.pfn.dense_cell", False)
    with pytest.raises(NotImplementedError):
        TorchDetector(cfg, device="cpu")
    cfg = TorchConfig.default().override("runtime.compute_dtype", "bfloat16")
    with pytest.raises(NotImplementedError):
        TorchDetector(cfg, device="cpu")


def test_no_card_without_explicit_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TorchDetector(TorchConfig.default())
