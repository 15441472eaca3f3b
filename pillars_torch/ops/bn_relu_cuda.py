"""Wrapper of the eval BatchNorm + ReLU kernel (``csrc/bn_relu.cu``).

``relu(batch_norm(x))`` with the running statistics, over float32 [N, C, H,
W], in one read and one write of ``x``: NCHW-contiguous and channels-last
tensors each have a kernel, another layout is made contiguous first. It has no TPU counterpart: the JAX package
leaves BN + ReLU to XLA, which fuses them. A CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain twin :func:`bn_relu_plain`.
The counter ``bn_relu.launches`` (utils/tracing.py) counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from pillars_torch.ops import _build
from pillars_torch.utils import tracing


# after the six pointers (x, mean, var, weight, bias, y)
_ARGS = {"bn_relu_nchw": [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_void_p],
         "bn_relu_nhwc": [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p]}


@functools.cache
def _fn(name: str = "bn_relu_nchw"):
    fn = getattr(_build.load("bn_relu"), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + _ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def bn_relu_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  weight: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """The two library ops the kernel replaces: eval ``batch_norm`` over
    dim 1, then ``relu``."""
    return torch.relu(F.batch_norm(x, mean, var, weight, bias, False, 0.0,
                                   eps))


def bn_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """x [N, C, H, W] float32; mean, var, weight, bias [C] float32 (read on
    the device at each launch, so a captured graph reads their current
    values) -> a new [N, C, H, W] tensor in ``x``'s layout (NCHW for a
    layout that is neither NCHW nor channels-last)."""
    if x.device.type == "cpu":
        return bn_relu_plain(x, mean, var, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    n, c, h, w = x.shape
    for name, t in (("mean", mean), ("var", var), ("weight", weight),
                    ("bias", bias)):
        if t.shape != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        entry, shape = "bn_relu_nhwc", (x.numel(), c)
    else:
        x = x.contiguous()  # a copy only for a layout that is neither
        entry, shape = "bn_relu_nchw", (n * c, c, h * w)
    y = torch.empty_like(x)  # x's strides
    if x.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fn(entry)(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                        weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                        *shape, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"bn_relu kernel launch failed: CUDA error {err}")
    tracing.count("bn_relu.launches")
    return y


tracing.count("bn_relu.launches", 0)
