"""RPN (pillars_tpu/models/rpn.py; reference model/voxelnet.py:517-717).

Three downsample blocks of separable convs, each conv followed by BN+ReLU;
three ConvTranspose up-branches; 1x1 heads applied per branch and summed
(the same math as a head on the concat, without materializing it).
:class:`RPNTail` is the part after the blocks, for the path whose blocks run
fused (ops/rpn_blocks.py). The modules take and return NHWC like the JAX
package; inside they are NCHW. BatchNorm follows flax's conventions in train
mode (models/layers.py). Each BN + ReLU goes through
``BatchNorm.forward_relu``: in float32 eval on the card one kernel pass
(ops/bn_relu_cuda.py), elsewhere ``torch.relu(bn(x))``. A plain stride-1
block conv that :meth:`_Block.takes_kernel` runs with its BN + ReLU as one
kernel instead (ops/conv_cuda.py).

``rpn.remat`` recomputes each block and deconv in the backward
(``torch.utils.checkpoint``); with ``rpn.remat_bf16`` the seven boundary
tensors it keeps (the canvas, three block and three deconv outputs) are
stored as bfloat16 and upcast where they are read, so every conv, BN and
gradient still computes in f32. That applies only to a float32 network.

``dtype`` (``runtime.compute_dtype``): every conv, deconv and head computes
in it and every BN rounds to it, as flax's ``dtype`` does
(models/layers.py); the heads come out in it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pillars_torch.config import ModelConfig
from pillars_torch.models.layers import (BatchNorm, Conv2d, ConvTranspose2d,
                                         SeparableConv, promote,
                                         takes_kernel)
from pillars_torch.ops import conv_cuda


def _upcast(x):
    return x.float() if x.dtype == torch.bfloat16 else x


def _remat(module: nn.Module, x, kwargs=None):
    """``module(x, **kwargs)``, recomputed in the backward instead of
    stored. The module's tensors go in as explicit inputs and its mode is
    restored for the recomputation, so that reads what the forward read
    (also under ``torch.func.functional_call``, which has returned by
    then)."""
    names, tensors = zip(*(list(module.named_parameters())
                           + list(module.named_buffers())))
    training = module.training

    def run(x, *ts):
        was = module.training
        module.train(training)
        try:
            return torch.func.functional_call(module, dict(zip(names, ts)),
                                              (x,), kwargs or {})
        finally:
            module.train(was)

    # the forward draws no random numbers: no RNG state to save, which a
    # captured CUDA graph could not read
    return checkpoint(run, x, *tensors, use_reentrant=False,
                      preserve_rng_state=False)


class _SplitHead(nn.Module):
    """1x1 head over a list of branches: sum_i conv1x1(u_i, W[:, slice_i])
    + bias, summed in branch order in ``dtype`` (in bfloat16 each sum
    rounds); with ``concat`` one conv over the branches' concat (the JAX
    package's ``rpn.no_concat_heads`` off). ``weight`` is the whole
    [Co, sum(Ci), 1, 1] kernel."""

    def __init__(self, in_chs: List[int], features: int,
                 dtype: Optional[torch.dtype] = None, concat: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, sum(in_chs), 1, 1))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight)
        self.dtype = dtype
        self.concat = concat

    def forward(self, ups):
        if self.dtype is None:
            ups = [_upcast(u) for u in ups]
        if self.concat:
            ups = [torch.cat(ups, dim=1)]
        ups = promote(self.dtype, *ups)
        weight, bias = promote(self.dtype, self.weight, self.bias)
        acc = None
        for u, w in zip(ups, weight.split([u.shape[1] for u in ups], dim=1)):
            term = nn.functional.conv2d(u, w)
            acc = term if acc is None else acc + term
        return acc + bias[None, :, None, None]


class _Block(nn.Module):
    """One downsample block: a strided 3x3 conv (zero pad 1 on each side,
    the reference's ZeroPadding2D + valid conv) then ``num_layers`` SAME
    3x3 convs, each followed by BN+ReLU."""

    def __init__(self, in_ch: int, features: int, num_layers: int,
                 stride: int, bn_eps: float, separable: bool,
                 bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None,
                 shift_add: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.upcast = dtype is None  # rpn.remat_bf16's boundaries
        for i in range(num_layers + 1):
            cin = in_ch if i == 0 else features
            s = stride if i == 0 else 1
            conv = (SeparableConv(cin, features, s, padding=1, dtype=dtype,
                                  shift_add=shift_add) if separable
                    else Conv2d(cin, features, 3, stride=s, padding=1,
                                dtype=dtype))
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", BatchNorm(features, bn_eps, bn_momentum,
                                                dtype=dtype))

    def fits(self, i: int, padding=None) -> bool:
        """Whether conv ``i`` (at ``padding``, else its own) is of a form
        the conv kernel computes (ops/conv_cuda.py): a plain float32 conv,
        stride 1. Strided and separable convs and bfloat16 are not."""
        conv = getattr(self, f"conv{i}")
        return (isinstance(conv, Conv2d) and conv.compute_dtype is None
                and conv_cuda.takes(conv.weight.shape, conv.stride,
                                    padding or conv.padding, conv.groups,
                                    conv.dilation))

    def takes_kernel(self, i: int, x, padding=None) -> bool:
        """Whether conv ``i`` and its BN + ReLU run as one launch of the
        conv kernel on ``x``: :meth:`fits`, under
        models/layers.py::takes_kernel (eval, float32, CUDA, no gradient
        wanted); training and the CPU do not."""
        bn = getattr(self, f"bn{i}")
        return self.fits(i, padding) and takes_kernel(
            bn, x, getattr(self, f"conv{i}").weight, *bn.parameters())

    def forward(self, x, halo=None):
        """``halo``: for a band of rows (parallel/spatial.py), the function
        that adds one neighbour row on each side; each conv then pads only
        along x."""
        if self.upcast:
            x = _upcast(x)
        padding = None if halo is None else (0, 1)
        for i in range(self.num_layers + 1):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            if halo is not None:
                x = halo(x)
            if self.takes_kernel(i, x, padding):
                x = conv_cuda.conv3x3_bn_relu(
                    x, conv.weight, bn.running_mean, bn.running_var,
                    bn.weight, bn.bias, bn.eps,
                    padding=padding or conv.padding)
            else:
                x = bn.forward_relu(conv(x) if halo is None
                                    else conv(x, padding=padding))
        return x


class _Deconv(nn.Module):
    """Up-branch: ConvTranspose (kernel == stride) + BN + ReLU."""

    def __init__(self, in_ch: int, features: int, stride: int,
                 bn_eps: float, bn_momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.deconv = ConvTranspose2d(in_ch, features, stride, stride=stride,
                                      dtype=dtype)
        self.bn = BatchNorm(features, bn_eps, bn_momentum, dtype=dtype)
        self.upcast = dtype is None  # rpn.remat_bf16's boundaries

    def forward(self, x):
        return self.bn.forward_relu(self.deconv(_upcast(x) if self.upcast
                                                else x))


class RPNTail(nn.Module):
    """Deconv branches + heads only (pillars_tpu/models/rpn.py::RPNTail):
    the rest of the RPN after the downsample blocks, which the fast
    inference path runs as fused kernels (ops/rpn_blocks.py). Child names
    match :class:`RPN`'s, so the ``rpn.*`` entries of a state_dict load
    into it."""

    def __init__(self, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        rcfg = cfg.rpn
        for i in range(3):
            self.add_module(f"deconv{i + 1}", _Deconv(
                rcfg.num_filters[i], rcfg.num_upsample_filters[i],
                rcfg.upsample_strides[i], rcfg.bn_eps, rcfg.bn_momentum,
                dtype=dtype))
        ups = list(rcfg.num_upsample_filters)
        n_anchor = cfg.num_anchors_per_loc
        num_cls = n_anchor * (cfg.num_class if cfg.encode_background_as_zeros
                              else cfg.num_class + 1)
        head = dict(dtype=dtype, concat=not rcfg.no_concat_heads)
        self.conv_box = _SplitHead(ups, n_anchor * cfg.box_code_size, **head)
        self.conv_cls = _SplitHead(ups, num_cls, **head)
        self.use_dir = cfg.postprocess.use_direction_classifier
        if self.use_dir:
            self.conv_dir_cls = _SplitHead(ups, n_anchor * 2, **head)

    def forward(self, b1, b2, b3) -> Dict[str, torch.Tensor]:
        """NHWC block outputs -> head outputs, NHWC."""
        return self.heads([b.permute(0, 3, 1, 2) for b in (b1, b2, b3)])

    def heads(self, blocks) -> Dict[str, torch.Tensor]:
        """NCHW block outputs -> head outputs, NHWC."""
        ups = [getattr(self, f"deconv{i + 1}")(b)
               for i, b in enumerate(blocks)]
        return self.apply_heads(ups)

    def apply_heads(self, ups) -> Dict[str, torch.Tensor]:
        """NCHW up-branches -> head outputs, NHWC."""
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        out = {"box_preds": nhwc(self.conv_box(ups)),
               "cls_preds": nhwc(self.conv_cls(ups))}
        if self.use_dir:
            out["dir_cls_preds"] = nhwc(self.conv_dir_cls(ups))
        return out


class RPN(RPNTail):
    """The three downsample blocks, then :class:`RPNTail`. ``in_ch``: the
    canvas channels (default the PFN's filters)."""

    def __init__(self, cfg: ModelConfig, in_ch: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cfg, dtype)
        rcfg = cfg.rpn
        cin = cfg.pfn.num_filters if in_ch is None else in_ch
        for i in range(3):
            self.add_module(f"block{i + 1}", _Block(
                cin, rcfg.num_filters[i], rcfg.layer_nums[i],
                rcfg.layer_strides[i], rcfg.bn_eps,
                rcfg.use_separable_conv, rcfg.bn_momentum, dtype=dtype,
                shift_add=rcfg.depthwise_shift_add))
            cin = rcfg.num_filters[i]

    def forward(self, x, halo=None) -> Dict[str, torch.Tensor]:
        """x: [B, ny, nx, C] canvas -> head outputs, NHWC. With ``halo``
        (parallel/spatial.py), ``x`` is a band of the canvas's rows and the
        heads come out for that band: every 3x3 conv of the blocks reads
        one row of each neighbour band through ``halo``."""
        rcfg = self.cfg.rpn
        # as the JAX package: the boundaries are bf16 whenever both flags
        # are set on a float32 network; recomputation matters only where a
        # backward follows
        remat = rcfg.remat and torch.is_grad_enabled()
        bf16 = rcfg.remat and rcfg.remat_bf16 and self.dtype is None

        def cast(a):
            return a.to(torch.bfloat16) if bf16 else a

        def call(module, a, kwargs=None):
            if remat:
                return _remat(module, a, kwargs)
            return module(a, **(kwargs or {}))

        # one bf16 copy of each boundary feeds both the deconv and the next
        # block, so each is stored once
        x = cast(x.permute(0, 3, 1, 2).contiguous())
        ups = []
        block_kwargs = None if halo is None else {"halo": halo}
        for i in range(3):
            x = cast(call(getattr(self, f"block{i + 1}"), x, block_kwargs))
            ups.append(cast(call(getattr(self, f"deconv{i + 1}"), x)))
        return self.apply_heads(ups)
