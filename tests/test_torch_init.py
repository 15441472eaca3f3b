"""``PillarsDetector.init`` of the port: a state from the modules' own
initialisers and an explicit generator. Not flax's values for any seed; the
same keys, shapes, constants and distributions as the JAX package's ``init``
(tests/test_cls_bias_prior.py has the JAX side of the prior)."""

import numpy as np
import pytest
import torch

import jax

from pillars_torch.config import Config
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.weights import from_jax_variables
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from torch_parity import fast_config

torch.set_num_threads(2)


def _init(cfg, seed=0):
    det = PillarsDetector(cfg, device="cpu")
    return det, det.init(torch.Generator().manual_seed(seed), batch_size=1)


@pytest.fixture(scope="module")
def jax_state():
    v = jax.device_get(JaxDetector(JaxConfig.default()).init(
        jax.random.PRNGKey(0), batch_size=1))
    return from_jax_variables(v["params"], v["batch_stats"], Config.default())


def test_keys_and_shapes_equal_the_converted_jax_init(jax_state):
    for cfg in (Config.default(), fast_config(Config.default())):
        _, state = _init(cfg)
        assert state.keys() == jax_state.keys()
        for k, v in state.items():
            assert v.shape == jax_state[k].shape, k
            assert v.dtype == jax_state[k].dtype, k


def test_seeded_and_reproducible():
    _, a = _init(Config.default(), seed=5)
    _, b = _init(Config.default(), seed=5)
    _, c = _init(Config.default(), seed=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pfn.dense.weight"], c["pfn.dense.weight"])
    # the generator advances: a second draw from it differs
    g = torch.Generator().manual_seed(5)
    det = PillarsDetector(Config.default(), device="cpu")
    first, second = det.init(g), det.init(g)
    assert torch.equal(first["pfn.dense.weight"], a["pfn.dense.weight"])
    assert not torch.equal(first["pfn.dense.weight"],
                           second["pfn.dense.weight"])


def test_constants_match_the_jax_init(jax_state):
    _, state = _init(Config.default())
    n_const = 0
    for k, v in state.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("bias", "running_mean", "running_var",
                    "num_batches_tracked") or v.ndim == 1:
            assert torch.equal(v, jax_state[k]), k
            n_const += 1
    assert n_const > 100
    assert (state["rpn.conv_cls.bias"] == 0).all()


def test_kernels_follow_the_jax_distribution(jax_state):
    """Uniform in +-sqrt(6 / fan_in) with flax's fan_in: the bounds and the
    spread agree with the flax draw, kernel by kernel."""
    _, state = _init(Config.default())
    n_kernels = 0
    for k, v in state.items():
        if not (k.endswith("weight") and v.ndim > 1):
            continue
        ref = jax_state[k]
        bound = float(ref.abs().max())
        if v.numel() >= 1024:
            assert float(v.abs().max()) == pytest.approx(bound, rel=0.02), k
            assert float(v.std()) == pytest.approx(float(ref.std()),
                                                   rel=0.1), k
        else:  # depthwise 3x3 kernels of few channels: the bound only
            assert float(v.abs().max()) <= np.sqrt(6.0 / 9) + 1e-6, k
        assert abs(float(v.mean())) < 0.1 * bound, k
        n_kernels += 1
    assert n_kernels >= 39  # every conv, deconv, head and Dense kernel


def test_cls_bias_prior():
    cfg = Config.default().override("model.rpn.cls_bias_prior", 0.01)
    det, state = _init(cfg)
    np.testing.assert_allclose(state["rpn.conv_cls.bias"].numpy(),
                               -np.log(0.99 / 0.01), rtol=1e-6)
    assert (state["rpn.conv_box.bias"] == 0).all()
    # a fresh detector scores background near the prior, not near 0.5
    rng = np.random.RandomState(0)
    n = 2000
    pts = np.zeros((1, cfg.model.voxel.max_points, 3), np.float32)
    pts[0, :n] = np.stack([rng.uniform(0, 6.4, n), rng.uniform(-2.56, 2.56, n),
                           rng.uniform(-1.5, 1.0, n)], 1)
    with torch.inference_mode():
        preds, _ = det._forward_dense(
            state, torch.from_numpy(pts), torch.tensor([n], dtype=torch.int32),
            cfg.eval_input.anchor_area_threshold)
    scores = torch.sigmoid(preds["cls_preds"].float()).ravel()
    assert float(scores.median()) < 5 * 0.01


def test_init_state_runs_end_to_end():
    cfg = Config.default().override("model.voxel.max_points", 2048)
    det, state = _init(cfg)
    pts = np.random.RandomState(1).uniform(
        [0, -2.5, -2], [6.4, 2.5, 1], (1, 2048, 3)).astype(np.float32)
    eye = np.eye(4, dtype=np.float32)[None]
    out = det.make_inference_fn()(state, pts, np.asarray([2048], np.int32),
                                  eye, eye)
    assert out.boxes_lidar.shape == (
        1, cfg.model.postprocess.nms_post_max_size, 7)
    assert torch.isfinite(out.scores[out.valid]).all()
