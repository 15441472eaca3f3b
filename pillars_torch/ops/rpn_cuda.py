"""Wrapper of the fused RPN block kernel (``csrc/rpn_sep_block.cu``).

The port of pillars_tpu/ops/rpn_pallas.py::fused_sep_block. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain twin
:func:`pillars_torch.ops.rpn_blocks.fused_sep_block_plain`.
``fused_sep_block.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from pillars_torch.ops import _build
from pillars_torch.ops.rpn_blocks import FoldedLayer, fused_sep_block_plain


def _fn():
    fn = _build.load("rpn_sep_block").rpn_sep_block
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_layers(layers: Sequence[FoldedLayer], num_layers: int, cin: int,
                  device: torch.device) -> int:
    """Validates the folded layers against the input; returns C_out."""
    if len(layers) != num_layers + 1:
        raise ValueError(f"{len(layers)} layers for num_layers={num_layers}")
    cout = layers[0].wp.shape[1]
    for i, layer in enumerate(layers):
        ci = cin if i == 0 else cout
        shapes = (tuple(layer.wd.shape), tuple(layer.wp.shape),
                  tuple(layer.bias.shape))
        if shapes != ((3, 3, ci), (ci, cout), (cout,)):
            raise ValueError(f"layer {i}: shapes {shapes}, expected wd "
                             f"(3, 3, {ci}), wp ({ci}, {cout}), bias ({cout},)")
        for t in layer:
            if t.dtype != torch.float32:
                raise TypeError(f"layer {i}: weights must be float32, got "
                                f"{t.dtype}")
            if t.device != device:
                raise ValueError(f"layer {i}: weights on {t.device}, input "
                                 f"on {device}")
    return cout


def fused_sep_block(x: torch.Tensor, layers: Sequence[FoldedLayer],
                    num_layers: int, stride: int) -> torch.Tensor:
    """x [B, H, W, C_in] f32 NHWC + 1 + ``num_layers`` folded layers ->
    [B, H/stride, W/stride, C_out]."""
    if x.device.type == "cpu":
        return fused_sep_block_plain(x, layers, num_layers, stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    b, h, w, cin = x.shape
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{w}")
    cout = _check_layers(layers, num_layers, cin, x.device)
    if cin % 4 or cout % 4:
        raise ValueError(f"channels must be multiples of 4, got {cin}->{cout}")
    out = torch.empty((b, h // stride, w // stride, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty_like(out)
    packed = torch.cat([t.reshape(-1) for layer in layers for t in layer])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    packed.data_ptr(), b, h, w, cin, cout, num_layers,
                    stride, stream)
    if err != 0:
        raise RuntimeError(f"rpn_sep_block kernel launch failed: CUDA error "
                           f"{err}")
    fused_sep_block.launches += 1
    return out


fused_sep_block.launches = 0
