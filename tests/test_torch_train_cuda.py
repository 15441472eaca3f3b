"""Training on the card: the train step at full d435i width, B=2, from the
trained checkpoint, against the port on the CPU, and the fold cache of the
fast inference path after an optimizer step.

Tolerances (the same f32 math in another order, cuDNN against oneDNN, TF32
off): labels equal, bbox_targets 1e-5; the loss and its parts 1e-4
relative; every gradient leaf 1e-3 of its max |value|; new BN statistics
1e-4 of their max |value|.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_train_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.train.loop import (TrainState, forward_backward,
                                      make_train_step, split_state,
                                      variables)
from pillars_torch.train.optim import AdamW
from torch_parity import fast_config, train_batches

pytestmark = pytest.mark.cuda

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
TARGET_ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
STAT_RTOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _train_state(cfg, device):
    from pillars_torch.weights import from_jax_variables, load_params

    det = PillarsDetector(cfg, device=device)
    params, stats = split_state(det.state_to_device(
        from_jax_variables(*load_params(WEIGHTS), cfg)))
    opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
    return det, TrainState(0, params, stats, opt.init(params)), opt


def _max_rel(got, want):
    return float((got.cpu() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def test_train_step_on_the_card_matches_the_cpu(card):
    cfg = Config.default()
    g = cfg.model.target.max_gt_boxes
    batch = train_batches(11, 1, b=2, maxpts=cfg.model.voxel.max_points,
                          max_gt=g, n=17000)[0]
    thr = cfg.train_input.anchor_area_threshold
    det_c, state_c, _ = _train_state(cfg, card)
    det_h, state_h, _ = _train_state(cfg, "cpu")
    fb_c = forward_backward(det_c, state_c, batch, thr)
    fb_h = forward_backward(det_h, state_h, batch, thr)
    assert torch.equal(fb_c.targets.labels.cpu(), fb_h.targets.labels)
    assert int((fb_h.targets.labels > 0).sum()) > 0
    assert float((fb_c.targets.bbox_targets.cpu()
                  - fb_h.targets.bbox_targets).abs().max()) <= TARGET_ATOL
    for name, a, b in zip(fb_h.loss._fields, fb_c.loss, fb_h.loss):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=name)
    for name, want in fb_h.grads.items():
        assert _max_rel(fb_c.grads[name], want) <= GRAD_RTOL, name
    for name, want in fb_h.batch_stats.items():
        if want.is_floating_point():
            assert _max_rel(fb_c.batch_stats[name], want) <= STAT_RTOL, name

    # the whole step on the card: a new state on the card, inputs untouched
    before = {k: v.clone() for k, v in state_c.params.items()}
    opt = AdamW(cfg.train.optimizer, 2)
    new, metrics = make_train_step(det_c, opt)(state_c, batch)
    assert all(torch.equal(state_c.params[k], before[k]) for k in before)
    assert all(t.device.type == card.type for t in new.params.values())
    assert np.isfinite(float(metrics.loss))


def test_fold_cache_after_an_optimizer_step_on_the_card(card):
    cfg = fast_config(Config.default())
    det, state, opt = _train_state(cfg, card)
    assert det.fast
    batch = train_batches(12, 1, b=2, maxpts=cfg.model.voxel.max_points,
                          max_gt=cfg.model.target.max_gt_boxes, n=17000)[0]
    pts = torch.from_numpy(batch["points"]).to(card)
    num = torch.from_numpy(batch["num_points"]).to(card)
    with torch.no_grad():
        vox = det.voxelize_batch(pts, num)
        det._forward_fast(variables(state), vox)
        folds = det.folded_blocks.folds
        state, _ = make_train_step(det, opt)(state, batch)
        got = det._forward_fast(variables(state), vox)
        assert det.folded_blocks.folds == folds + 1
        want = det.apply(variables(state), vox)
    for key in want:
        assert _max_rel(got[key], want[key].cpu()) <= 1e-4, key
