"""Shared building blocks (pillars_tpu/models/layers.py).

Compute dtype. The JAX package's modules take flax's ``dtype``; the port's
take ``dtype`` (None: float32 throughout, or ``torch.bfloat16``) and round
where flax does. A Dense or a conv (:class:`Linear`, :class:`Conv2d`,
:class:`ConvTranspose2d`, :class:`Conv3d`) casts its input AND its float32
weight to the dtype, so the op runs and returns in it (flax's
``promote_dtype``; float32 accumulation, one rounding of the output). A
BatchNorm computes in float32 from the float32 statistics and rounds its
output once; in train mode it takes the batch statistics in float32 from
the rounded activations (flax's ``force_float32_reductions``), and the
gradient flows through them. The parameters and statistics stay float32.

Over several ranks (pillars_torch/parallel/), a BatchNorm whose ``group``
is set takes its train-mode statistics over the ranks of that process
group: each rank's sums of x, x^2 and its row count go through one
all-reduce before the mean and variance (SyncBatchNorm's semantics, the
statistics of the global batch), and the gradient flows back through it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from pillars_torch.ops.bn_relu_cuda import bn_relu
from pillars_torch.parallel.collectives import all_reduce_sum


def promote(dtype: Optional[torch.dtype], *tensors):
    """flax's ``promote_dtype``: ``tensors`` cast to ``dtype`` (None: as
    they are)."""
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) for t in tensors)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or in its own dtype where that is wider (the
    dtype of train-mode BN statistics)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Linear(nn.Linear):
    """``nn.Linear`` (no bias) computing in ``dtype`` (flax
    ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(*promote(self.compute_dtype, x, self.weight))


class _PromotedConv:
    """A torch conv (no bias) computing in ``dtype``."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        return self._conv_forward(*promote(self.compute_dtype, x,
                                           self.weight), None)


class Conv2d(_PromotedConv, nn.Conv2d):
    """``nn.Conv2d`` (no bias) computing in ``dtype``; ``padding`` given to
    a call replaces the module's (the spatial RPN pads only x)."""

    def forward(self, x, padding=None):
        if padding is None:
            return super().forward(x)
        x, w = promote(self.compute_dtype, x, self.weight)
        return F.conv2d(x, w, None, self.stride, padding, self.dilation,
                        self.groups)


class Conv3d(_PromotedConv, nn.Conv3d):
    """``nn.Conv3d`` (no bias) computing in ``dtype``."""


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no bias, kernel == stride) computing in
    ``dtype``."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        x, w = promote(self.compute_dtype, x, self.weight)
        return F.conv_transpose2d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def depthwise_shift_add(x: torch.Tensor, weight: torch.Tensor, stride: int,
                        padding: int) -> torch.Tensor:
    """The JAX package's ``depthwise_shift_add``: a 3x3 depthwise conv as 9
    shifted products summed in (dy, dx) order, each product and each sum in
    ``x``'s dtype (in bfloat16 each rounds). x [B, C, H, W], weight
    [C, 1, 3, 3]; ``padding`` an int or (along y, along x)."""
    py, px = (padding, padding) if isinstance(padding, int) else padding
    xp = F.pad(x, (px, px, py, py))
    oh = (xp.shape[2] - 3) // stride + 1
    ow = (xp.shape[3] - 3) // stride + 1
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, :, dy:dy + (oh - 1) * stride + 1:stride,
                     dx:dx + (ow - 1) * stride + 1:stride]
            term = tap * weight[:, 0, dy, dx][None, :, None, None]
            out = term if out is None else out + term
    return out


class SeparableConv(nn.Module):
    """Depthwise-separable 3x3 conv (keras SeparableConv2D, depth multiplier
    1, no bias): a grouped 3x3 ``depthwise`` then a 1x1 ``pointwise``, NCHW,
    each in ``dtype`` (the depthwise output rounds before the pointwise).

    ``padding`` is applied by the depthwise conv (the RPN pads explicitly
    where the JAX package does). The JAX package's ``depthwise_shift_add``
    lowering (``shift_add``) is the same math in float32, where this module
    keeps the grouped conv; in bfloat16 it rounds after every tap, and the
    module follows it there."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 padding: int = 1, dtype: Optional[torch.dtype] = None,
                 shift_add: bool = False):
        super().__init__()
        self.depthwise = Conv2d(in_ch, in_ch, 3, stride=stride,
                                padding=padding, groups=in_ch, dtype=dtype)
        self.pointwise = Conv2d(in_ch, features, 1, dtype=dtype)
        self.shift_add = shift_add and dtype is not None

    def forward(self, x, padding=None):
        """``padding``: an int or (along y, along x) that replaces the
        depthwise conv's."""
        dw = self.depthwise
        if self.shift_add:
            x = depthwise_shift_add(*promote(dw.compute_dtype, x, dw.weight),
                                    dw.stride[0],
                                    dw.padding[0] if padding is None
                                    else padding)
        else:
            x = dw(x, padding)
        return self.pointwise(x)


class BatchNorm(nn.Module):
    """BatchNorm over the channels of NCHW activations, with flax's
    conventions.

    Eval: the running statistics. Train: the batch's, mean E[x] and the
    biased variance max(E[x^2] - E[x]^2, 0) (flax's fast variance), and the
    running update ``new = momentum * old + (1 - momentum) * batch``
    (flax's ``momentum``, the complement of torch's). The state keys are
    torch's (``weight``, ``bias``, ``running_mean``, ``running_var`` and,
    with ``count_batches``, ``num_batches_tracked``), so checkpoints and the
    fold of the fused blocks read it as they read ``nn.BatchNorm2d``.

    Train mode does not touch the buffers: the updated statistics are left
    in :attr:`new_stats` (detached) for the caller to collect, the
    counterpart of flax's ``mutable=["batch_stats"]``.

    ``group``: the process group whose ranks share the train-mode
    statistics (None: this process's batch alone)."""

    def __init__(self, features: int, eps: float, momentum: float,
                 count_batches: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.group = None
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.count_batches = count_batches
        if count_batches:
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long))
        self.new_stats: Optional[Tuple[torch.Tensor, ...]] = None

    def _record(self, mean, var):
        m = self.momentum
        with torch.no_grad():
            self.new_stats = (m * self.running_mean + (1 - m) * mean.detach(),
                              m * self.running_var + (1 - m) * var.detach())
            if self.count_batches:
                self.new_stats += (self.num_batches_tracked + 1,)

    def _moments(self, s1, s2, count):
        """Mean and biased variance from this rank's sums of x and x^2 and
        its row count, summed over :attr:`group` in one collective when
        it is set."""
        if self.group is not None:
            f = s1.shape[0]
            packed = all_reduce_sum(
                torch.cat([s1, s2, count.reshape(1).to(s1.dtype)]),
                self.group)
            s1, s2, count = packed[:f], packed[f:2 * f], packed[2 * f]
        count = torch.clamp(count.to(s1.dtype), min=1.0)
        mean = s1 / count
        var = torch.clamp(s2 / count - mean * mean, min=0.0)
        return mean, var

    def forward(self, x):
        if not self.training and self.compute_dtype is not None:
            # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale)
            # + bias in float32, rounded once
            shape = [1, -1] + [1] * (x.ndim - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = ((x.float() - self.running_mean.reshape(shape))
                 * mul.reshape(shape) + self.bias.reshape(shape))
            return y.to(self.compute_dtype)
        if not self.training:
            # one fused library kernel, as nn.BatchNorm2d in eval
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        # flax's force_float32_reductions: the statistics in at least
        # float32 from the activations, the output rounded once
        xf = at_least_f32(x)
        axes = [0] + list(range(2, x.ndim))
        if self.group is None:  # mean() launches fewer kernels than sums
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                              min=0.0)
        else:
            mean, var = self._moments(
                xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                torch.full((), float(x.numel() // x.shape[1]),
                           dtype=xf.dtype, device=xf.device))
        self._record(mean, var)
        shape = [1, -1] + [1] * (x.ndim - 2)
        inv = torch.rsqrt(var + self.eps)
        y = ((x - mean.reshape(shape)) * (inv * self.weight).reshape(shape)
             + self.bias.reshape(shape))
        return y.to(self.compute_dtype or x.dtype)

    def forward_relu(self, x):
        """``torch.relu(self(x))``. On a 4-D tensor (NCHW or channels-last)
        that :func:`takes_kernel`, one kernel pass (ops/bn_relu_cuda.py) in
        place of the library BN and the ReLU; the same function, to float32
        rounding."""
        if x.dim() == 4 and takes_kernel(self, x, *self.parameters()):
            return bn_relu(x, self.running_mean, self.running_var,
                           self.weight, self.bias, self.eps)
        return torch.relu(self(x))


def takes_kernel(bn: BatchNorm, x: torch.Tensor, *tensors) -> bool:
    """The rule by which an eval module takes its hand-written kernel in
    place of its library ops: its BatchNorm ``bn`` in eval and computing in
    float32, its input ``x`` a float32 CUDA tensor, and no gradient wanted
    of ``x`` or of ``tensors`` (its other inputs and its parameters).
    Training, bfloat16 and the CPU take the module's own computation."""
    return (not bn.training and bn.compute_dtype is None and x.is_cuda
            and x.dtype == torch.float32
            and not (torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, *tensors))))


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the LAST axis whose batch statistics count only the
    rows a mask selects (pillars_tpu/models/layers.py::MaskedBatchNorm):
    padding pillars of the static [P, N, F] layout stay out of them, padded
    points of real pillars add their zeros, as in the reference's ragged
    layout. Train: mean and max(E[x^2] - E[x]^2, 0) over the selected rows;
    eval: the running statistics. Computes in float32 and returns ``dtype``
    (None: ``x``'s). Keys as :class:`BatchNorm`'s, without a batch count."""

    def __init__(self, features: int, eps: float, momentum: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, eps, momentum, count_batches=False,
                         dtype=dtype)

    def forward(self, x, mask):
        """x [..., F]; mask broadcastable to x[..., 0] (True = real)."""
        if self.training:
            xf = at_least_f32(x)
            m = torch.broadcast_to(mask, x.shape[:-1]).to(xf.dtype)[..., None]
            axes = tuple(range(x.ndim - 1))
            mean, var = self._moments(
                (xf * m).sum(dim=axes), (xf * xf * m).sum(dim=axes), m.sum())
            self._record(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.compute_dtype or x.dtype)


def collect_batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics that a train-mode forward of ``module`` left
    in its :class:`BatchNorm` layers, as ``state_dict`` entries
    (``num_batches_tracked``, where kept, advanced by one); clears them."""
    out = {}
    for name, sub in module.named_modules():
        if isinstance(sub, BatchNorm) and sub.new_stats is not None:
            prefix = f"{name}." if name else ""
            for key, t in zip(("running_mean", "running_var",
                               "num_batches_tracked"), sub.new_stats):
                out[prefix + key] = t
            sub.new_stats = None
    return out
