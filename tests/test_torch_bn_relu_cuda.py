"""The eval BatchNorm + ReLU kernel (``csrc/bn_relu.cu``) on the card: against
its plain twin (cuDNN's eval BN, then ``torch.relu``) at the RPN's shapes of
the KITTI and d435i configs at B=1 and B=8, NCHW and channels-last, at
planes whose size is not a multiple of 4, at channel counts that are not, on
pointers that are not 16-byte aligned, on a layout that is neither, on
negative, zero and large inputs; a captured inference that reads BN values
changed after its capture; 19 launches a replay on the served RPNs, 3 (the
deconvs) on the fast path and none in a captured train step; the wrapper's
refusals.

Tolerance: the kernel computes (x - mean) * (rsqrt(var + eps) * w) + b with
one fma, cuDNN in its own order: max |kernel - twin| <= 1e-6 * max |twin|.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_bn_relu_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.utils import tracing

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")
REL_TOL = 1e-6
EPS = 1e-3

# the RPN's BN inputs: blocks 1-3 and the deconvs' common width
KITTI3 = [(64, 496, 432), (128, 248, 216), (256, 124, 108), (128, 496, 432)]
D435I = [(64, 64, 80), (128, 32, 40), (256, 16, 20), (128, 64, 80)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ops(card):
    from pillars_torch.ops import bn_relu_cuda

    return bn_relu_cuda


def _vectors(c, card, seed):
    g = torch.Generator().manual_seed(seed)
    mean = torch.randn(c, generator=g)
    var = torch.rand(c, generator=g) * 2 + 0.05
    weight = torch.randn(c, generator=g)
    bias = torch.randn(c, generator=g) * 0.5
    return [t.to(card) for t in (mean, var, weight, bias)]


def _check(ops, x, vectors):
    before = tracing.counters()["bn_relu.launches"]
    got = ops.bn_relu(x, *vectors, EPS)
    torch.cuda.synchronize()
    assert tracing.counters()["bn_relu.launches"] == before + 1
    want = ops.bn_relu_plain(x, *vectors, EPS)
    assert got.shape == want.shape and got.dtype == torch.float32
    # the input's layout, or NCHW for a layout that is neither
    layout = (torch.channels_last if not x.is_contiguous() and
              x.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    assert got.is_contiguous(memory_format=layout)
    tol = REL_TOL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert bool((got >= 0).all())
    return got, want


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("shape", KITTI3 + D435I,
                         ids=[f"kitti3_{c}x{h}x{w}" for c, h, w in KITTI3]
                         + [f"d435i_{c}x{h}x{w}" for c, h, w in D435I])
def test_kernel_matches_twin_at_the_rpn_shapes(ops, card, shape, b, layout):
    c, h, w = shape
    x = torch.randn((b, c, h, w), device=card)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    _check(ops, x, _vectors(c, card, seed=c + h))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 5, 3, 3), (2, 6, 7, 9),
                                   (4, 12, 33, 3), (1, 4, 1, 2)])
def test_channels_last_at_any_channel_count(ops, card, shape):
    x = (torch.randn(shape, device=card) * 4).contiguous(
        memory_format=torch.channels_last)
    _check(ops, x, _vectors(shape[1], card, seed=6))


def test_a_layout_that_is_neither(ops, card):
    x = torch.randn((2, 8, 12, 10), device=card).permute(0, 1, 3, 2)
    assert not (x.is_contiguous() or x.is_contiguous(
        memory_format=torch.channels_last))
    _check(ops, x, _vectors(8, card, seed=12))


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 5, 3, 3), (3, 7, 1, 1),
                                   (2, 6, 7, 9), (1, 4, 1, 2), (4, 3, 33, 3)])
def test_kernel_matches_twin_at_planes_not_a_multiple_of_4(ops, card, shape):
    x = torch.randn(shape, device=card) * 4
    _check(ops, x, _vectors(shape[1], card, seed=7))


def test_kernel_on_a_pointer_not_16_byte_aligned(ops, card):
    n, c, h, w = 2, 16, 12, 20
    buf = torch.randn(n * c * h * w + 1, device=card)
    x = buf[1:].view(n, c, h, w)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _check(ops, x, _vectors(c, card, seed=8))
    x = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    _check(ops, x, _vectors(c, card, seed=8))
    # the BN vectors too, on the channels-last kernel's float4 reads
    vectors = [torch.cat([v[:1], v])[1:] for v in _vectors(c, card, seed=8)]
    assert vectors[0].data_ptr() % 16 != 0
    _check(ops, x.clone(memory_format=torch.channels_last), vectors)


def test_negative_zero_and_large_inputs(ops, card):
    c = 8
    mean, var, weight, bias = _vectors(c, card, seed=9)
    weight = weight.abs() + 0.1          # positive scales: signs are known
    mean = torch.zeros_like(mean)
    bias = torch.zeros_like(bias)
    vectors = (mean, var, weight, bias)
    neg = -torch.rand((2, c, 16, 16), device=card) - 1e-3
    got, _ = _check(ops, neg, vectors)
    assert not bool(got.any())
    got, _ = _check(ops, torch.zeros((2, c, 16, 16), device=card), vectors)
    assert not bool(got.any())
    big = torch.full((2, c, 16, 16), 1e30, device=card)
    big[1] = -1e30
    got, want = _check(ops, big, vectors)
    # scale >= 0.1 / sqrt(2.05 + EPS)
    assert bool((got[0] >= 1e28).all()) and not bool(got[1].any())
    # shift and scale where the inputs straddle the mean
    _check(ops, torch.randn((2, c, 16, 16), device=card) * 1e4,
           _vectors(c, card, seed=10))


def test_wrapper_refusals(ops, card, monkeypatch):
    mean, var, weight, bias = _vectors(4, card, seed=11)
    x = torch.randn((1, 4, 8, 8), device=card)
    with pytest.raises(TypeError):
        ops.bn_relu(x.double(), mean, var, weight, bias, EPS)
    with pytest.raises(ValueError):
        ops.bn_relu(x[0], mean, var, weight, bias, EPS)
    with pytest.raises(ValueError):
        ops.bn_relu(x, mean.cpu(), var, weight, bias, EPS)
    with pytest.raises(ValueError):
        ops.bn_relu(x, mean[:3], var, weight, bias, EPS)
    # a launch the card refuses (an empty grid) is reported by the kernel's
    # host function, and a reported error makes the wrapper raise
    y = torch.empty_like(x)
    err = ops._fn()(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                    weight.data_ptr(), bias.data_ptr(), y.data_ptr(), 0, 4,
                    64, EPS, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    monkeypatch.setattr(ops, "_fn", lambda name: (lambda *args: err))
    before = tracing.counters()["bn_relu.launches"]
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        with pytest.raises(RuntimeError):
            ops.bn_relu(t, mean, var, weight, bias, EPS)
    assert tracing.counters()["bn_relu.launches"] == before


def _clouds(cfg, seed):
    """One cloud on the card: a synthetic d435i scene (pedestrians in it)
    for the d435i config, uniform points in the range for another."""
    from pillars_torch.data.stream import synthetic_bank

    maxpts, d = cfg.model.voxel.max_points, cfg.model.num_point_features
    if d == 3:
        cloud = synthetic_bank(1, seed, max_points=maxpts)[0]
    else:
        r = np.random.RandomState(seed)
        lo, hi = np.asarray(cfg.model.voxel.point_cloud_range,
                            np.float32).reshape(2, 3)
        cloud = np.concatenate([r.uniform(lo, hi, (15000, 3)),
                                r.uniform(0, 1, (15000, d - 3))], 1)
    n = len(cloud)
    pts = np.zeros((1, maxpts, d), np.float32)
    pts[0, :n] = cloud
    eye = np.eye(4, dtype=np.float32)[None]
    return [torch.from_numpy(a).cuda()
            for a in (pts, np.asarray([n], np.int32), eye, eye)]


def _same(got, want):
    for name, g, w in zip(want._fields, got, want):
        if w.is_floating_point():
            tol = 1e-6 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol, name
        else:
            assert torch.equal(g, w), name


def _d435i_state(cfg, det):
    from pillars_torch.weights import from_jax_variables, load_params

    return det.state_to_device(from_jax_variables(*load_params(WEIGHTS),
                                                  cfg))


@pytest.mark.parametrize("config,per_replay", [("d435i_dense", 19),
                                               ("kitti3", 5),
                                               ("d435i_fast", 3)])
def test_launches_a_replay(card, ops, config, per_replay):
    """19 on the separable RPN; 5 on kitti3's plain one, whose 14 stride-1
    block convs run their BN + ReLU in the conv kernel
    (test_torch_conv_bn_relu_cuda.py); 3 on the fast path, whose blocks are
    fused (their BN folded) and whose deconvs read the blocks' NHWC output
    and give channels-last tensors."""
    from pillars_torch.cuda_graph import CapturedInference
    from pillars_torch.models.detector import PillarsDetector
    from torch_parity import fast_config

    if config == "kitti3":
        cfg = Config.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
        det = PillarsDetector(cfg)
        state = det.init(torch.Generator().manual_seed(0))
    else:
        cfg = Config.default()
        if config == "d435i_fast":
            cfg = fast_config(cfg)
        det = PillarsDetector(cfg)
        state = _d435i_state(cfg, det)
    fn = det.make_inference_fn()
    assert isinstance(fn, CapturedInference)
    args = _clouds(cfg, seed=3)
    fn(state, *args)                      # eager first call, then capture
    before = tracing.counters()["bn_relu.launches"]
    for _ in range(3):
        fn(state, *args)
    torch.cuda.synchronize()
    assert tracing.counters()["bn_relu.launches"] == before + 3 * per_replay


def test_replay_reads_bn_values_changed_after_capture(card):
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.default()
    det = PillarsDetector(cfg)
    state = _d435i_state(cfg, det)
    fn = det.make_inference_fn()
    args = _clouds(cfg, seed=4)
    fn(state, *args)
    first = fn(state, *args)
    _same(first, fn.eager(state, *args))
    assert first.valid.any()
    # every RPN BN's four vectors changed: graph.state_load copies them in
    other = dict(state)
    g = torch.Generator().manual_seed(5)
    for k, v in state.items():
        if k.startswith("rpn.") and ".bn" in k and v.is_floating_point():
            other[k] = v * (1 + 0.05 * torch.rand(v.shape, generator=g)
                            ).to(v.device)
    got = fn(other, *args)
    want = fn.eager(other, *args)
    _same(got, want)
    assert not torch.equal(got.scores, first.scores)
    _same(fn(state, *args), first)


def test_no_launch_in_a_captured_train_step(card, ops):
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import (CapturedTrainStep, TrainState,
                                          make_train_step, split_state)
    from pillars_torch.train.optim import AdamW
    from torch_parity import train_batches

    cfg = Config.default()
    det = PillarsDetector(cfg)
    params, stats = split_state(_d435i_state(cfg, det))
    opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
    state = TrainState(0, params, stats, opt.init(params))
    step = make_train_step(det, opt)
    assert isinstance(step, CapturedTrainStep)
    batches = train_batches(13, 3, b=2, maxpts=cfg.model.voxel.max_points,
                            max_gt=cfg.model.target.max_gt_boxes, n=17000)
    before = tracing.counters()["bn_relu.launches"]
    for batch in batches:             # eager first call, capture, replays
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    assert len(step.graphs) == 1
    assert tracing.counters()["bn_relu.launches"] == before
