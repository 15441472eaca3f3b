"""The eval 3x3 conv + BN + ReLU kernel (``csrc/conv3x3_bn_relu.cu``) on the
card: against its plain twin (cuDNN's conv with TF32 off, then eval BN and
``torch.relu``) at every stride-1 block conv shape of kitti3 and the SECOND
configs at B=1 and B=2, from NCHW and channels-last inputs, and with the band
path's padding; two launches bit-equal; a captured kitti3 RPN whose 14
stride-1 block convs each take one launch a replay (its 2 strided convs and
3 deconvs the BN + ReLU kernel) and whose heads equal the library path's; a
captured inference that reads conv weights changed after its capture; the
wrapper's refusals.

Tolerance. Each output sums K = 9 * C_in <= 2880 products in float32, the
kernel in one fixed order (a tile shared by blocks as partial sums added in
the order of the chunks), cuDNN in its own; both orders are within
gamma_K = K * u / (1 - K * u) (u = 2**-24) of the exact sum, relative to the
sum of the products' magnitudes. So |kernel - twin| <= 2 * gamma_K *
conv(|x|, |w|) * |scale| + 4 * u * |twin| elementwise (scale the BN's, the
second term the BN + ReLU's own rounding), with the magnitudes' conv
computed by the same cuDNN call.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest
tests/test_torch_conv_bn_relu_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from pillars_torch.config import Config
from pillars_torch.utils import tracing

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS = 1e-3
U = 2.0 ** -24

# (label, C_in, C_out, H, W) of the input of each distinct stride-1 block conv
SHAPES = [
    ("kitti3_block1", 64, 64, 496, 432),
    ("kitti3_block2", 128, 128, 248, 216),
    ("kitti3_block3", 256, 256, 124, 108),
    ("kitti_second_block1_conv0", 320, 64, 200, 176),
    ("kitti_second_block1", 64, 64, 200, 176),
    ("kitti_second_block2", 128, 128, 100, 88),
    ("kitti_second_block3", 256, 256, 50, 44),
    ("second_d435i_block1_conv0", 128, 64, 64, 80),
    ("second_d435i_block1", 64, 64, 64, 80),
    ("second_d435i_block2", 128, 128, 32, 40),
    ("second_d435i_block3", 256, 256, 16, 20),
]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = was


@pytest.fixture(scope="module")
def ops(card):
    from pillars_torch.ops import conv_cuda

    return conv_cuda


def _inputs(b, c_in, c_out, h, w, card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((b, c_in, h, w), device=card, generator=g)
    weight = torch.randn((c_out, c_in, 3, 3), device=card,
                         generator=g) / (3 * c_in ** 0.5)
    vec = [torch.randn(c_out, device=card, generator=g) * 0.1,
           torch.rand(c_out, device=card, generator=g) + 0.1,
           torch.randn(c_out, device=card, generator=g),
           torch.randn(c_out, device=card, generator=g)]
    return x, weight, vec


def _check(ops, x, weight, vec, padding):
    before = tracing.counters()["conv3x3_bn_relu.launches"]
    got = ops.conv3x3_bn_relu(x, weight, *vec, EPS, padding=padding)
    torch.cuda.synchronize()
    assert tracing.counters()["conv3x3_bn_relu.launches"] == before + 1
    want = ops.conv3x3_bn_relu_plain(x, weight, *vec, EPS, 1, padding)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.is_contiguous()
    k = 9 * x.shape[1]
    gamma_k = k * U / (1 - k * U)
    mags = F.conv2d(x.abs(), weight.abs(), None, 1, padding)
    scale = (torch.rsqrt(vec[1] + EPS) * vec[2]).abs()[None, :, None, None]
    bound = 2 * gamma_k * mags * scale + 4 * U * want.abs() + 1e-30
    over = ((got - want).abs() - bound).max().item()
    assert over <= 0, f"over the bound by {over}"
    assert bool((got >= 0).all())
    return got, want


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_twin_at_the_block_shapes(ops, card, shape, b,
                                                  layout):
    _, c_in, c_out, h, w = shape
    x, weight, vec = _inputs(b, c_in, c_out, h, w, card, seed=c_in + h)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    _check(ops, x, weight, vec, 1)


@pytest.mark.parametrize("c_in", [8, 24, 48])
@pytest.mark.parametrize("c_out", [64, 128, 256])
def test_band_padding_odd_grids_and_other_layouts(ops, card, c_out, c_in):
    """Padding (0, 1) (parallel/spatial.py's bands), grids that end inside a
    tile, C_in in chunks of 8 and 16, and a layout that is neither NCHW nor
    channels-last."""
    x, weight, vec = _inputs(2, c_in, c_out, 13, 23, card, seed=c_out)
    _check(ops, x, weight, vec, (0, 1))
    _check(ops, x.contiguous(memory_format=torch.channels_last), weight,
           vec, 1)
    odd = x.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    assert not (odd.is_contiguous() or odd.is_contiguous(
        memory_format=torch.channels_last))
    _check(ops, odd, weight, vec, 1)


def test_two_launches_are_bit_equal(ops, card):
    for _, c_in, c_out, h, w in SHAPES[:3]:
        x, weight, vec = _inputs(1, c_in, c_out, h, w, card, seed=1)
        first = ops.conv3x3_bn_relu(x, weight, *vec, EPS)
        second = ops.conv3x3_bn_relu(x, weight, *vec, EPS)
        assert torch.equal(first, second)


def test_negative_large_and_non_finite_inputs(ops, card):
    x, weight, vec = _inputs(1, 16, 64, 9, 12, card, seed=5)
    vec[2] = vec[2].abs() + 0.1
    vec[0] = torch.zeros_like(vec[0])
    vec[3] = torch.zeros_like(vec[3])
    got, _ = _check(ops, x * 1e15, weight.abs(), vec, 1)
    assert bool((got > 0).any())
    got = ops.conv3x3_bn_relu(-x.abs(), weight.abs(), *vec, EPS)
    assert not bool(got.any())
    nan = x.clone()
    nan[0, 3, 4, 5] = float("nan")
    got = ops.conv3x3_bn_relu(nan, weight, *vec, EPS)
    want = ops.conv3x3_bn_relu_plain(nan, weight, *vec, EPS)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())


def test_wrapper_refusals(ops, card, monkeypatch):
    x, weight, vec = _inputs(1, 16, 64, 8, 8, card, seed=6)
    with pytest.raises(TypeError):
        ops.conv3x3_bn_relu(x.double(), weight, *vec, EPS)
    with pytest.raises(ValueError):
        ops.conv3x3_bn_relu(x, weight.cpu(), *vec, EPS)
    with pytest.raises(ValueError):
        ops.conv3x3_bn_relu(x, weight[:32], *[v[:32] for v in vec], EPS)
    with pytest.raises(ValueError):
        ops.conv3x3_bn_relu(x, weight, *vec, EPS, stride=2)
    # a launch the card refuses is reported by the host function, and a
    # reported error makes the wrapper raise and count nothing
    monkeypatch.setattr(ops, "_fn", lambda: (lambda *args: 98))
    before = tracing.counters()["conv3x3_bn_relu.launches"]
    with pytest.raises(RuntimeError):
        ops.conv3x3_bn_relu(x, weight, *vec, EPS)
    assert tracing.counters()["conv3x3_bn_relu.launches"] == before


def _kitti3():
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
    det = PillarsDetector(cfg)
    return cfg, det, det.init(torch.Generator().manual_seed(0))


def test_kitti3_rpn_heads_match_the_library_path(card, monkeypatch):
    """The RPN module at kitti3's grid, B=2: 14 launches a call, and every
    head as the library path (cuDNN convs, TF32 off, and the BN + ReLU
    kernel) computes it."""
    from pillars_torch.models import rpn as rpn_mod

    _, det, state = _kitti3()
    net = det.network.rpn
    det.network.load_state_dict(state)
    canvas = torch.randn((2, 496, 432, 64), device=card,
                         generator=torch.Generator(device=card)
                         .manual_seed(7)).relu()
    with torch.no_grad():
        before = tracing.counters()["conv3x3_bn_relu.launches"]
        got = net(canvas)
        torch.cuda.synchronize()
        assert tracing.counters()["conv3x3_bn_relu.launches"] == before + 14
        monkeypatch.setattr(rpn_mod._Block, "takes_kernel",
                            lambda self, i, x, padding=None: False)
        want = net(canvas)
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-5 * scale, (k, err, scale)


def _cloud(cfg, seed, card):
    maxpts, d = cfg.model.voxel.max_points, cfg.model.num_point_features
    r = np.random.RandomState(seed)
    lo, hi = np.asarray(cfg.model.voxel.point_cloud_range,
                        np.float32).reshape(2, 3)
    cloud = np.concatenate([r.uniform(lo, hi, (15000, 3)),
                            r.uniform(0, 1, (15000, d - 3))], 1)
    pts = np.zeros((1, maxpts, d), np.float32)
    pts[0, :len(cloud)] = cloud
    eye = np.eye(4, dtype=np.float32)[None]
    return [torch.from_numpy(a).to(card)
            for a in (pts, np.asarray([len(cloud)], np.int32), eye, eye)]


def test_a_replay_launches_14_and_reads_weights_changed_after_capture(card):
    from pillars_torch.cuda_graph import CapturedInference

    cfg, det, state = _kitti3()
    fn = det.make_inference_fn()
    assert isinstance(fn, CapturedInference)
    args = _cloud(cfg, 3, card)
    fn(state, *args)                      # eager first call, then capture
    first = fn(state, *args)
    before = {k: tracing.counters()[k] for k in
              ("conv3x3_bn_relu.launches", "bn_relu.launches")}
    for _ in range(3):
        fn(state, *args)
    torch.cuda.synchronize()
    after = tracing.counters()
    assert after["conv3x3_bn_relu.launches"] == (
        before["conv3x3_bn_relu.launches"] + 3 * 14)
    assert after["bn_relu.launches"] == before["bn_relu.launches"] + 3 * 5
    # every block conv's weights changed: graph.state_load copies them in
    other = dict(state)
    g = torch.Generator().manual_seed(5)
    for k, v in state.items():
        if k.startswith("rpn.block") and ".conv" in k:
            other[k] = v * (1 + 0.05 * torch.rand(v.shape, generator=g)
                            ).to(v.device)
    got = fn(other, *args)
    want = fn.eager(other, *args)
    for name, gt, wt in zip(want._fields, got, want):
        if wt.is_floating_point():
            assert torch.equal(gt, wt), name
    assert not torch.equal(got.scores, first.scores)
