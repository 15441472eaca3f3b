"""BatchNorm + ReLU on the CPU: ``BatchNorm.forward_relu`` (models/layers.py)
is ``torch.relu(bn(x))`` bit for bit wherever it does not launch the CUDA
kernel, the kernel wrapper's plain twin (ops/bn_relu_cuda.py) is the library
composition, the RPN's blocks and deconvs compute what they computed with
that composition, and nothing on the CPU counts a kernel launch. The kernel
itself runs only on the card: ``tests/test_torch_bn_relu_cuda.py``.
"""

import pytest
import torch
from torch.nn import functional as F

from pillars_torch.config import Config
from pillars_torch.models.layers import BatchNorm
from pillars_torch.models.rpn import RPN, _Block, _Deconv
from pillars_torch.ops import bn_relu_cuda
from pillars_torch.utils import tracing

EPS = 1e-3


def _bn(features=6, seed=0, dtype=None):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(features, EPS, 0.99, dtype=dtype)
    with torch.no_grad():
        bn.weight.copy_(torch.randn(features, generator=g))
        bn.bias.copy_(torch.randn(features, generator=g))
        bn.running_mean.copy_(torch.randn(features, generator=g))
        bn.running_var.copy_(torch.rand(features, generator=g) + 0.1)
    return bn


def _x(shape, seed=1, layout="contiguous"):
    g = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        return 3 * torch.randn(shape, generator=g)
    # the same values, laid out NHWC: an NCHW view that is not contiguous
    n, c, h, w = shape
    x = (3 * torch.randn((n, h, w, c), generator=g)).permute(0, 3, 1, 2)
    assert not x.is_contiguous()
    return x


MODES = ["eval_f32", "eval_bf16", "train", "requires_grad"]


@pytest.mark.parametrize("layout", ["contiguous", "non_contiguous"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_relu_is_relu_of_bn(mode, layout):
    bn = _bn(dtype=torch.bfloat16 if mode == "eval_bf16" else None)
    bn.train(mode == "train")
    x = _x((2, 6, 5, 7), layout=layout)
    if mode == "requires_grad":
        x.requires_grad_(True)
    before = tracing.counters()["bn_relu.launches"]
    got = bn.forward_relu(x)
    got_stats = bn.new_stats
    want = torch.relu(bn(x))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert tracing.counters()["bn_relu.launches"] == before
    if mode == "train":
        for g, w in zip(got_stats, bn.new_stats):
            assert torch.equal(g, w)
    if mode in ("train", "requires_grad"):
        assert got.requires_grad
        wrt = [bn.weight, bn.bias] + ([x] if x.requires_grad else [])
        grads = torch.autograd.grad(got.sum(), wrt)
        wants = torch.autograd.grad(torch.relu(bn(x)).sum(), wrt)
        for g, w in zip(grads, wants):
            assert torch.equal(g, w)


@pytest.mark.parametrize("shape", [(2, 6, 5, 7), (1, 6, 1, 1), (3, 6, 4, 8)])
def test_wrapper_twin_is_the_library_composition(shape):
    bn = _bn(seed=3)
    x = _x(shape, seed=4)
    before = tracing.counters()["bn_relu.launches"]
    args = (bn.running_mean, bn.running_var, bn.weight.detach(),
            bn.bias.detach(), EPS)
    got = bn_relu_cuda.bn_relu(x, *args)
    want = torch.relu(F.batch_norm(x, bn.running_mean, bn.running_var,
                                   bn.weight.detach(), bn.bias.detach(),
                                   False, 0.0, EPS))
    assert torch.equal(got, want)
    assert torch.equal(bn_relu_cuda.bn_relu_plain(x, *args), want)
    assert tracing.counters()["bn_relu.launches"] == before
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()


def test_wrapper_rejects_an_unsupported_device():
    bn = _bn()
    x = _x((1, 6, 2, 2)).to("meta")
    with pytest.raises(ValueError):
        bn_relu_cuda.bn_relu(x, bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, EPS)


def _reference_block(block, x):
    """The block as it was written before ``forward_relu``."""
    for i in range(block.num_layers + 1):
        x = torch.relu(getattr(block, f"bn{i}")(getattr(block, f"conv{i}")(x)))
    return x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("separable", [False, True])
def test_block_and_deconv_unchanged_on_the_cpu(separable, train):
    torch.manual_seed(5)
    block = _Block(4, 8, 2, 2, EPS, separable)
    deconv = _Deconv(8, 4, 2, EPS)
    for m in (block, deconv):
        for sub in m.modules():
            if isinstance(sub, BatchNorm):
                with torch.no_grad():
                    sub.running_mean.uniform_(-0.5, 0.5)
                    sub.running_var.uniform_(0.5, 1.5)
                    sub.weight.uniform_(-1.5, 1.5)
                    sub.bias.uniform_(-0.5, 0.5)
        m.train(train)
    x = torch.randn(2, 4, 12, 10)
    before = tracing.counters()["bn_relu.launches"]
    with torch.no_grad():
        got = block(x)
        assert torch.equal(got, _reference_block(block, x))
        up = deconv(got)
        assert torch.equal(up, torch.relu(deconv.bn(deconv.deconv(got))))
    assert tracing.counters()["bn_relu.launches"] == before
    assert (up == 0).any() and (up > 0).any()


def test_no_launch_is_counted_on_the_cpu():
    """An eval RPN forward at the d435i widths under inference mode (the
    served path's mode): the counter, which ``tracing.counters`` reports as
    ``bn_relu.launches``, does not move."""
    cfg = Config.default()
    rpn = RPN(cfg.model).eval()
    _, ny, nx = cfg.model.feature_map_size
    before = tracing.counters()
    with torch.inference_mode():
        out = rpn(torch.randn(1, ny, nx, cfg.model.pfn.num_filters))
    after = tracing.counters()
    assert out["cls_preds"].shape[:3] == (1, ny, nx)
    assert "bn_relu.launches" in after
    assert after["bn_relu.launches"] == before["bn_relu.launches"]
