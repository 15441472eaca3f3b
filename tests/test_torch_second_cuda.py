"""SECOND on the card against the port on the CPU: the sparse rulebooks and
active sets of every stage integer-equal, built and consumed without the
host waiting for the card (``torch.cuda.set_sync_debug_mode("error")``), the
sparse middle's canvas and both SECOND configs' head tensors within 1e-3 of
their max |value| (the same f32 products summed in another order, TF32
off), and one train step's gradients within 1e-3 of each leaf's max.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_second_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS_33 = str(ROOT / "benchmarks" / "second_sparse_synth"
                 / "weights_33.pkl")
HEAD_RTOL = 1e-3
GRAD_RTOL = 1e-3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _sparse(overrides=()):
    from pillars_torch.config import Config

    cfg = Config.from_yaml(str(ROOT / "configs" / "second_sparse_d435i.yaml"))
    for key, value in overrides:
        cfg = cfg.override(key, value)
    return cfg


def _clouds(b, maxpts, n, seed=0):
    r = np.random.RandomState(seed)
    pts = np.zeros((b, maxpts, 3), np.float32)
    for i in range(b):
        pts[i, :n] = np.stack([r.uniform(0, 6.4, n), r.uniform(-2.56, 2.56, n),
                               r.uniform(-3, 3, n)], 1)
    num = np.full((b,), n, np.int32)
    num[-1] = n - 1000
    return torch.from_numpy(pts), torch.from_numpy(num)


def _max_rel(got, want):
    return (float((got.cpu().double() - want.double()).abs().max())
            / max(float(want.abs().max()), 1e-30))


@pytest.mark.parametrize("b", [1, 2])
def test_rulebooks_and_middle_without_host_sync(card, b):
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = _sparse()
    det, cpu = PillarsDetector(cfg, device=card), PillarsDetector(cfg,
                                                                  device="cpu")
    state_cpu = from_jax_variables(*load_params(WEIGHTS_33), cfg)
    state = det.state_to_device(state_cpu)
    pts, num = _clouds(b, cfg.model.voxel.max_points, 15000)
    v_cpu = cpu.voxelize_batch(pts, num)
    v = det.voxelize_batch(pts.to(card), num.to(card))
    mid = det.network.middle
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stages, _ = mid.rulebooks(v.coords, v.pillar_mask)
        with torch.no_grad():
            canvas = torch.func.functional_call(
                det.network, state, (v,), {"canvas_only": True})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want, _ = cpu.network.middle.rulebooks(v_cpu.coords, v_cpu.pillar_mask)
    for got_stage, want_stage in zip(stages, want):
        for g, w in zip(got_stage, want_stage):
            assert torch.equal(g.cpu(), w)
    with torch.no_grad():
        canvas_cpu = torch.func.functional_call(
            cpu.network, state_cpu, (v_cpu,), {"canvas_only": True})
    assert _max_rel(canvas, canvas_cpu) <= HEAD_RTOL


@pytest.mark.parametrize("name", ["second_sparse_d435i", "second_d435i"])
def test_heads_card_vs_cpu(card, name):
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.from_yaml(str(ROOT / "configs" / f"{name}.yaml"))
    det, cpu = PillarsDetector(cfg, device=card), PillarsDetector(cfg,
                                                                  device="cpu")
    state_cpu = cpu.init(torch.Generator().manual_seed(0))
    state = det.state_to_device(state_cpu)
    pts, num = _clouds(2, cfg.model.voxel.max_points, 15000, seed=1)
    with torch.no_grad():
        got = det.apply(state, det.voxelize_batch(pts.to(card),
                                                  num.to(card)))
        want = cpu.apply(state_cpu, cpu.voxelize_batch(pts, num))
    for key, w in want.items():
        assert _max_rel(got[key], w) <= HEAD_RTOL, key


def test_sparse_train_step_card_vs_cpu(card):
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import TrainState, forward_backward, split_state
    from pillars_torch.train.optim import AdamW
    from pillars_torch.weights import from_jax_variables, load_params
    from torch_parity import train_batches

    cfg = _sparse((("model.target.max_gt_boxes", 4),))
    batch = train_batches(4, 1, maxpts=cfg.model.voxel.max_points)[0]
    out = {}
    for dev in (card, "cpu"):
        det = PillarsDetector(cfg, device=dev)
        params, stats = split_state(det.state_to_device(
            from_jax_variables(*load_params(WEIGHTS_33), cfg)))
        opt = AdamW(cfg.train.optimizer, 2)
        out[str(dev)] = forward_backward(
            det, TrainState(0, params, stats, opt.init(params)), batch,
            cfg.train_input.anchor_area_threshold)
    got, want = out[str(card)], out["cpu"]
    assert torch.equal(got.targets.labels.cpu(), want.targets.labels)
    for k, g in want.grads.items():
        assert _max_rel(got.grads[k], g) <= GRAD_RTOL, k
    for k, s in want.batch_stats.items():
        if s.is_floating_point():
            assert _max_rel(got.batch_stats[k], s) <= 1e-4, k
