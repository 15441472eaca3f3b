"""Training on the card: the train step at full d435i width, B=2, from the
trained checkpoint, against the port on the CPU, and the fold cache of the
fast inference path after an optimizer step; the captured train step
(``CapturedTrainStep``): replays against the eager step from the same state
(losses and positives equal, gradients of a captured ``gradients`` graph
within 1e-3 of each leaf's max, new BN statistics equal, moments within
1e-3 of each leaf's max, parameters within two learning rates), donation
with and without ``donate``, the detector's captured inference reading the
weights of a replayed step (predictions within 1e-6 of their max against a
fresh clone of the state); ``profile_stages`` against the three stages in
one graph.

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


# replay against eager from the same state: the backward's float atomics
# (index_add_ and scatter gradients) may sum in another order, so the
# gradients and moments are held to the card-vs-CPU criterion; an Adam
# step moves an element by at most about the rate, whatever its gradient
PARAM_ATOL_LR = 2.0
CAPTURE_RTOL = 1e-6


def _clone(state):
    from pillars_torch.train.optim import AdamState

    c = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return TrainState(state.step, c(state.params), c(state.batch_stats),
                      AdamState(state.opt_state.count,
                                c(state.opt_state.mu), c(state.opt_state.nu)))


def _replay_close(got, want, lr):
    for k, w in want.batch_stats.items():
        assert torch.equal(got.batch_stats[k], w), k
    for a, b in ((got.opt_state.mu, want.opt_state.mu),
                 (got.opt_state.nu, want.opt_state.nu)):
        for k, w in b.items():
            assert _max_rel(a[k], w.cpu()) <= GRAD_RTOL, k
    for k, w in want.params.items():
        assert float((got.params[k] - w).abs().max()) <= PARAM_ATOL_LR * lr, k


@pytest.mark.parametrize("variant", ["f32", "bf16", "remat", "metrics"])
def test_captured_step_replays_match_eager(card, variant):
    from pillars_torch.cuda_graph import CapturedCall
    from pillars_torch.train import metrics as tm
    from pillars_torch.train.loop import (BATCH_DTYPES, BATCH_KEYS,
                                          CapturedTrainStep, batch_to_device,
                                          gradients)

    cfg = Config.default()
    if variant == "bf16":
        cfg = cfg.override("runtime.compute_dtype", "bfloat16")
    cfg = cfg.override("model.rpn.remat", variant == "remat")
    det, state, opt = _train_state(cfg, card)
    thr = cfg.train_input.anchor_area_threshold
    metrics = variant == "metrics"
    step = make_train_step(det, opt, with_metrics=metrics)
    assert isinstance(step, CapturedTrainStep)
    tm_state = tm.TrainMetricsState.init(card) if metrics else None
    batches = [batch_to_device(b, card) for b in train_batches(
        13, 3, b=2, maxpts=cfg.model.voxel.max_points,
        max_gt=cfg.model.target.max_gt_boxes, n=17000)]
    lr = float(opt.schedule(0))
    for batch in batches:
        ref = _clone(state)
        if metrics:
            want, _, m_want, _ = step.eager(ref, tm_state, batch)
            state, tm_state, m_got, _ = step(state, tm_state, batch)
        else:
            want, m_want = step.eager(ref, batch)
            state, m_got = step(state, batch)
        for name, g, w in zip(m_want._fields, m_got, m_want):
            assert torch.equal(g, w), name
        _replay_close(state, want, lr)
    assert len(step.graphs) == 1

    # the gradients themselves, captured against eager
    grads = CapturedCall(
        lambda *b: list(gradients(det, state.params, state.batch_stats,
                                  dict(zip(BATCH_KEYS, b)), thr)
                        .grads.values()),
        card, BATCH_DTYPES, context=torch.no_grad)
    args = [batches[0][k] for k in BATCH_KEYS]
    grads(*args)
    got = grads(*args)
    want = gradients(det, state.params, state.batch_stats, batches[0],
                     thr).grads
    for g, (k, w) in zip(got, want.items()):
        assert _max_rel(g, w.cpu()) <= GRAD_RTOL, k


def test_donation_on_the_card(card):
    cfg = Config.default()
    det, state, opt = _train_state(cfg, card)
    batch = train_batches(14, 1, b=2, maxpts=cfg.model.voxel.max_points,
                          max_gt=cfg.model.target.max_gt_boxes, n=17000)[0]
    step = make_train_step(det, opt)
    first = {k: v.clone() for k, v in state.params.items()}
    s1, _ = step(state, batch)
    assert all(torch.equal(state.params[k], v) for k, v in first.items())
    assert all(s1.params[k] is step.static.tensors[f"params/{k}"]
               for k in s1.params)
    copies = step.static.copies
    s2, _ = step(s1, batch)
    assert step.static.copies == copies and s2.step == 2
    kept_step = make_train_step(det, opt, donate=False)
    kept, _ = kept_step(state, batch)
    snapshot = {k: v.clone() for k, v in kept.params.items()}
    kept_step(kept, batch)
    assert all(torch.equal(kept.params[k], v) for k, v in snapshot.items())
    assert not any(kept.params[k] is kept_step.static.tensors[f"params/{k}"]
                   for k in kept.params)


def test_inference_reads_a_replayed_step(card):
    from torch_parity import d435i_clouds

    cfg = Config.default()
    det, state, opt = _train_state(cfg, card)
    batch = train_batches(15, 1, b=2, maxpts=cfg.model.voxel.max_points,
                          max_gt=cfg.model.target.max_gt_boxes, n=17000)[0]
    fn = det.make_inference_fn()
    pts, num = d435i_clouds(3, 1, cfg.model.voxel.max_points, 17000)
    args = [torch.from_numpy(a).to(card) for a in (pts, num)]
    eye = torch.eye(4, device=card)[None]
    step = make_train_step(det, opt)
    before = fn(variables(state), *args, eye, eye)
    for _ in range(3):  # the first call, then replays
        state, _ = step(state, batch)
        got = fn(variables(state), *args, eye, eye)
        fresh = {k: v.clone() for k, v in variables(state).items()}
        want = fn.eager(fresh, *args, eye, eye)
        for name, g, w in zip(want._fields, got, want):
            if w.is_floating_point():
                assert float((g - w).abs().max()) <= (
                    CAPTURE_RTOL * float(w.abs().max())), name
            else:
                assert torch.equal(g, w), name
    assert not torch.equal(got.scores, before.scores)


@pytest.mark.parametrize("path", ["dense_cell", "point_major_fast"])
def test_profile_stages_sum_to_the_captured_path(card, path):
    from pillars_torch.utils.profiling import stage_sum
    from pillars_torch.weights import from_jax_variables, load_params
    from torch_parity import d435i_clouds

    cfg = Config.default() if path == "dense_cell" else fast_config(
        Config.default())
    det = PillarsDetector(cfg)
    state = det.state_to_device(from_jax_variables(*load_params(WEIGHTS),
                                                   cfg))
    pts, num = d435i_clouds(4, 1, cfg.model.voxel.max_points, 17000)
    eye = torch.eye(4)[None]
    got = stage_sum(det, state, torch.from_numpy(pts), torch.from_numpy(num),
                    eye, eye, iters=20)
    assert set(got["stages"]) == {"t_voxel_features",
                                  "t_spatial_features_plus_rpn", "t_nms_func"}
    assert 0.8 * got["whole"] <= got["sum"] <= (
        1.1 * got["whole"] + 3 * got["boundary"]), got
