"""Shared building blocks (pillars_tpu/models/layers.py)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn


class SeparableConv(nn.Module):
    """Depthwise-separable 3x3 conv (keras SeparableConv2D, depth multiplier
    1, no bias): a grouped 3x3 ``depthwise`` then a 1x1 ``pointwise``, NCHW.

    ``padding`` is applied by the depthwise conv (the RPN pads explicitly
    where the JAX package does). The JAX package's ``depthwise_shift_add``
    lowering is the same math, so this module serves both settings."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, 3, stride=stride,
                                   padding=padding, groups=in_ch, bias=False)
        self.pointwise = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


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
    counterpart of flax's ``mutable=["batch_stats"]``."""

    def __init__(self, features: int, eps: float, momentum: float,
                 count_batches: bool = True):
        super().__init__()
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

    def forward(self, x):
        if not self.training:
            # one fused library kernel, as nn.BatchNorm2d in eval
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps)
        axes = [0] + list(range(2, x.ndim))
        mean = x.mean(dim=axes)
        var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
        self._record(mean, var)
        shape = [1, -1] + [1] * (x.ndim - 2)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean.reshape(shape)) * (inv * self.weight).reshape(shape)
                + self.bias.reshape(shape))


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the LAST axis whose batch statistics count only the
    rows a mask selects (pillars_tpu/models/layers.py::MaskedBatchNorm):
    padding pillars of the static [P, N, F] layout stay out of them, padded
    points of real pillars add their zeros, as in the reference's ragged
    layout. Train: mean and max(E[x^2] - E[x]^2, 0) over the selected rows;
    eval: the running statistics. Keys as :class:`BatchNorm`'s, without a
    batch count."""

    def __init__(self, features: int, eps: float, momentum: float):
        super().__init__(features, eps, momentum, count_batches=False)

    def forward(self, x, mask):
        """x [..., F]; mask broadcastable to x[..., 0] (True = real)."""
        if self.training:
            m = torch.broadcast_to(mask, x.shape[:-1]).to(x.dtype)[..., None]
            axes = tuple(range(x.ndim - 1))
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dim=axes) / count
            var = torch.clamp((x * x * m).sum(dim=axes) / count - mean * mean,
                              min=0.0)
            self._record(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


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
