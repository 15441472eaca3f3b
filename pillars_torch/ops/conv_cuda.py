"""Wrapper of the eval 3x3 conv + BatchNorm + ReLU kernel
(``csrc/conv3x3_bn_relu.cu``), and its plain twin.

``conv3x3_bn_relu`` computes ``relu(batch_norm(conv2d(x, weight)))`` with the
BN's running statistics, over float32 [N, C_in, H, W], in one pass: the
RPN's plain stride-1 block convs (models/rpn.py::_Block). The kernel takes
what those convs are, and the wrapper raises on anything else, whatever the
device: a 3x3 kernel without bias, groups and dilation 1, stride 1, padding
1 or the band path's (0, 1) (parallel/spatial.py), C_out in :data:`COUT`
and C_in a multiple of :data:`CIN_MULTIPLE` (a chunk of the kernel's
reduction). Stride 2 stays with cuDNN, which is faster there (the source's
note). The input is read in any layout; the output is NCHW. It has no TPU
counterpart: the JAX package leaves its convs and BN to XLA. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain twin
:func:`conv3x3_bn_relu_plain`. The counter ``conv3x3_bn_relu.launches``
(utils/tracing.py) counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from pillars_torch.ops import _build
from pillars_torch.utils import tracing

COUT = (64, 128, 256)
CIN_MULTIPLE = 8
PADDINGS = ((1, 1), (0, 1))  # (along y, along x)


class _Args(ctypes.Structure):
    """``ConvArgs`` of csrc/conv3x3_bn_relu.cu, field for field."""

    _fields_ = ([("x", ctypes.c_void_p)]
                + [(name, ctypes.c_longlong)
                   for name in ("sxn", "sxc", "sxh", "sxw")]
                + [(name, ctypes.c_void_p) for name in (
                    "w", "mean", "var", "gamma", "beta", "y", "ws",
                    "counters")]
                + [(name, ctypes.c_int) for name in (
                    "n", "cin", "h", "w_", "cout", "ho", "wo", "pad_y",
                    "tiles_x", "tiles_y")]
                + [("eps", ctypes.c_float)])


@functools.cache
def _fn():
    fn = _build.load("conv3x3_bn_relu").conv3x3_bn_relu
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def takes(weight_shape, stride, padding, groups: int = 1,
          dilation=1) -> bool:
    """Whether the kernel computes a conv of this form: ``weight_shape``
    [C_out, C_in, kh, kw]; ``stride``, ``padding`` and ``dilation`` an int
    or (along y, along x)."""
    c_out, c_in, kh, kw = weight_shape
    return ((kh, kw) == (3, 3) and groups == 1 and _pair(dilation) == (1, 1)
            and _pair(stride) == (1, 1) and _pair(padding) in PADDINGS
            and c_out in COUT and c_in > 0 and c_in % CIN_MULTIPLE == 0)


def conv3x3_bn_relu_plain(x, weight, mean, var, bn_weight, bn_bias,
                          eps: float, stride=1, padding=1):
    """The three library ops the kernel replaces: ``conv2d`` (no bias),
    eval ``batch_norm`` over dim 1, then ``relu``."""
    return torch.relu(F.batch_norm(
        F.conv2d(x, weight, None, stride, _pair(padding)), mean, var,
        bn_weight, bn_bias, False, 0.0, eps))


def _check(x, weight, vectors, stride, padding):
    """The output's (Ho, Wo), or a raise for what the kernel does not
    take."""
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"x and weight must be 4-D, got {list(x.shape)} "
                         f"and {list(weight.shape)}")
    if not takes(weight.shape, stride, padding):
        raise ValueError(
            f"the kernel takes a 3x3 conv with C_out in {COUT}, C_in a "
            f"multiple of {CIN_MULTIPLE}, stride 1 and padding in "
            f"{PADDINGS}; got weight {list(weight.shape)}, stride {stride}, "
            f"padding {padding}")
    if x.shape[1] != weight.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, weight "
                         f"{weight.shape[1]}")
    for name, t in (("x", x), ("weight", weight), *vectors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in vectors:
        if tuple(t.shape) != (weight.shape[0],):
            raise ValueError(f"{name} must be [{weight.shape[0]}], got "
                             f"{list(t.shape)}")
    pad_y, pad_x = _pair(padding)
    ho, wo = x.shape[2] + 2 * pad_y - 2, x.shape[3] + 2 * pad_x - 2
    if x.shape[0] == 0 or ho <= 0 or wo <= 0:
        raise ValueError(f"no output for x {list(x.shape)} at padding "
                         f"{padding}")
    return ho, wo


# per (device, stream): the kernel's tile counters, zero between launches
# (each launch leaves them so); grown when a launch has more tiles
_counters = {}


def _tile_counters(device, stream, tiles):
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < tiles:
        buf = _counters[(device, stream)] = torch.zeros(
            max(tiles, 4096), dtype=torch.int32, device=device)
    return buf


def conv3x3_bn_relu(x, weight, mean, var, bn_weight, bn_bias, eps: float,
                    stride=1, padding=1):
    """x [N, C_in, H, W] float32 in any layout (read through its strides);
    weight [C_out, C_in, 3, 3] and the BN's running mean and variance,
    weight and bias [C_out] float32 (read on the device at each launch, so
    a captured graph reads their current values) -> a new NCHW [N, C_out,
    Ho, Wo] tensor. ``stride`` must be 1 (an int or a pair)."""
    vectors = (("mean", mean), ("var", var), ("bn_weight", bn_weight),
               ("bn_bias", bn_bias))
    ho, wo = _check(x, weight, vectors, stride, padding)
    if x.device.type == "cpu":
        return conv3x3_bn_relu_plain(x, weight, mean, var, bn_weight,
                                     bn_bias, eps, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    weight = weight.contiguous()
    if weight.data_ptr() % 16:
        weight = weight.clone()  # its rows arrive as 16-byte words
    vecs = [t.contiguous() for _, t in vectors]
    n, c_in, h, w = x.shape
    c_out = weight.shape[0]
    y = torch.empty((n, c_out, ho, wo), dtype=torch.float32, device=x.device)
    args = _Args(x.data_ptr(), *x.stride(), weight.data_ptr(),
                 *(t.data_ptr() for t in vecs), y.data_ptr(), None, None, n,
                 c_in, h, w, c_out, ho, wo, _pair(padding)[0], 0, 0, eps)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = (ctypes.c_longlong * 3)()
    with torch.cuda.device(x.device):
        err = _fn()(ctypes.byref(args), stream, plan)
        if err == 0:
            # the shared tiles' partial sums, and the tiles' counters
            ws = torch.empty(plan[1], dtype=torch.float32, device=x.device)
            args.ws = ws.data_ptr()
            args.counters = _tile_counters(x.device, stream,
                                           plan[2]).data_ptr()
            err = _fn()(ctypes.byref(args), stream, None)
    if err != 0:
        raise RuntimeError(f"conv3x3_bn_relu kernel launch failed: CUDA "
                           f"error {err}")
    tracing.count("conv3x3_bn_relu.launches")
    return y


tracing.count("conv3x3_bn_relu.launches", 0)
