"""Shared building blocks (pillars_tpu/models/layers.py)."""

from __future__ import annotations

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
