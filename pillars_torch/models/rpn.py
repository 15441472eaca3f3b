"""RPN in eval mode (pillars_tpu/models/rpn.py; reference
model/voxelnet.py:517-717).

Three downsample blocks of separable convs, each conv followed by BN+ReLU;
three ConvTranspose up-branches; 1x1 heads applied per branch and summed
(the same math as a head on the concat, without materializing it).
:class:`RPNTail` is the part after the blocks, for the path whose blocks run
fused (ops/rpn_blocks.py). The modules take and return NHWC like the JAX
package; inside they are NCHW.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from pillars_torch.config import ModelConfig
from pillars_torch.models.layers import SeparableConv


class _SplitHead(nn.Module):
    """1x1 head over a list of branches: sum_i conv1x1(u_i, W[:, slice_i])
    + bias. ``weight`` is the whole [Co, sum(Ci), 1, 1] kernel."""

    def __init__(self, in_chs: List[int], features: int):
        super().__init__()
        self.in_chs = list(in_chs)
        self.weight = nn.Parameter(torch.empty(features, sum(in_chs), 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight)

    def forward(self, ups):
        acc = None
        for u, w in zip(ups, self.weight.split(self.in_chs, dim=1)):
            term = nn.functional.conv2d(u, w)
            acc = term if acc is None else acc + term
        return acc + self.bias[None, :, None, None]


class _Block(nn.Module):
    """One downsample block: a strided 3x3 conv (zero pad 1 on each side,
    the reference's ZeroPadding2D + valid conv) then ``num_layers`` SAME
    3x3 convs, each followed by BN+ReLU."""

    def __init__(self, in_ch: int, features: int, num_layers: int,
                 stride: int, bn_eps: float, separable: bool):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers + 1):
            cin = in_ch if i == 0 else features
            s = stride if i == 0 else 1
            conv = (SeparableConv(cin, features, s, padding=1) if separable
                    else nn.Conv2d(cin, features, 3, stride=s, padding=1,
                                   bias=False))
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", nn.BatchNorm2d(features, eps=bn_eps))

    def forward(self, x):
        for i in range(self.num_layers + 1):
            x = getattr(self, f"conv{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return x


class _Deconv(nn.Module):
    """Up-branch: ConvTranspose (kernel == stride) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 bn_eps: float):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_ch, features, stride,
                                         stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=bn_eps)

    def forward(self, x):
        return torch.relu(self.bn(self.deconv(x)))


class RPNTail(nn.Module):
    """Deconv branches + heads only (pillars_tpu/models/rpn.py::RPNTail):
    the rest of the RPN after the downsample blocks, which the fast
    inference path runs as fused kernels (ops/rpn_blocks.py). Child names
    match :class:`RPN`'s, so the ``rpn.*`` entries of a state_dict load
    into it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        rcfg = cfg.rpn
        for i in range(3):
            self.add_module(f"deconv{i + 1}", _Deconv(
                rcfg.num_filters[i], rcfg.num_upsample_filters[i],
                rcfg.upsample_strides[i], rcfg.bn_eps))
        ups = list(rcfg.num_upsample_filters)
        n_anchor = cfg.num_anchors_per_loc
        num_cls = n_anchor * (cfg.num_class if cfg.encode_background_as_zeros
                              else cfg.num_class + 1)
        self.conv_box = _SplitHead(ups, n_anchor * cfg.box_code_size)
        self.conv_cls = _SplitHead(ups, num_cls)
        self.use_dir = cfg.postprocess.use_direction_classifier
        if self.use_dir:
            self.conv_dir_cls = _SplitHead(ups, n_anchor * 2)

    def forward(self, b1, b2, b3) -> Dict[str, torch.Tensor]:
        """NHWC block outputs -> head outputs, NHWC."""
        return self.heads([b.permute(0, 3, 1, 2) for b in (b1, b2, b3)])

    def heads(self, blocks) -> Dict[str, torch.Tensor]:
        """NCHW block outputs -> head outputs, NHWC."""
        ups = [getattr(self, f"deconv{i + 1}")(b)
               for i, b in enumerate(blocks)]
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        out = {"box_preds": nhwc(self.conv_box(ups)),
               "cls_preds": nhwc(self.conv_cls(ups))}
        if self.use_dir:
            out["dir_cls_preds"] = nhwc(self.conv_dir_cls(ups))
        return out


class RPN(RPNTail):
    """The three downsample blocks, then :class:`RPNTail`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        rcfg = cfg.rpn
        cin = cfg.pfn.num_filters
        for i in range(3):
            self.add_module(f"block{i + 1}", _Block(
                cin, rcfg.num_filters[i], rcfg.layer_nums[i],
                rcfg.layer_strides[i], rcfg.bn_eps,
                rcfg.use_separable_conv))
            cin = rcfg.num_filters[i]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """x: [B, ny, nx, C] canvas -> head outputs, NHWC."""
        x = x.permute(0, 3, 1, 2).contiguous()
        blocks = []
        for i in range(3):
            x = getattr(self, f"block{i + 1}")(x)
            blocks.append(x)
        return self.heads(blocks)
