"""Wrapper of the CUDA NMS keep-mask kernel (``csrc/nms_keep_mask.cu``).

The port of pillars_tpu/ops/nms_pallas.py::nms_keep_mask_pallas. A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain twin
:func:`pillars_torch.ops.nms.keep_mask_plain`. The counter
``nms_keep_mask.launches`` (utils/tracing.py) counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pillars_torch.ops import _build
from pillars_torch.ops.nms import keep_mask_plain
from pillars_torch.utils import tracing

MAX_K = 1024  # the sweep keeps a row's 32 words in one warp's lanes


@functools.cache
def _fn():
    fn = _build.load("nms_keep_mask").nms_keep_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_floor() -> None:
    """Launches an empty kernel of one block of the keep-mask kernel's size
    on the current stream: timed beside the kernel, it is what a launch
    costs on this card before any work."""
    fn = _build.load("nms_keep_mask").nms_launch_floor
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def nms_keep_mask(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """[B, K, 4] f32 score-sorted standup boxes + [B, K] bool/uint8 validity
    -> [B, K] bool keep mask."""
    if boxes_sorted.device.type == "cpu":
        return keep_mask_plain(boxes_sorted, valid_sorted, iou_threshold)
    if boxes_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_sorted.device}")
    if boxes_sorted.dim() != 3 or boxes_sorted.shape[2] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes_sorted.shape)}")
    b, k, _ = boxes_sorted.shape
    if valid_sorted.shape != (b, k):
        raise ValueError(f"valid must be [{b}, {k}], got {tuple(valid_sorted.shape)}")
    if boxes_sorted.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes_sorted.dtype}")
    if valid_sorted.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid_sorted.dtype}")
    if valid_sorted.device != boxes_sorted.device:
        raise ValueError("boxes and valid must be on the same device")
    if not (boxes_sorted.is_contiguous() and valid_sorted.is_contiguous()):
        raise ValueError("boxes and valid must be contiguous")
    if not 0 < k <= MAX_K:
        raise ValueError(f"K must be in 1..{MAX_K}, got {k}")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes_sorted.device)
    if b == 0:
        return keep
    valid_u8 = valid_sorted.view(torch.uint8)
    stream = torch.cuda.current_stream(boxes_sorted.device).cuda_stream
    with torch.cuda.device(boxes_sorted.device):
        err = _fn()(boxes_sorted.data_ptr(), valid_u8.data_ptr(),
                    keep.data_ptr(), b, k, float(iou_threshold), stream)
    if err != 0:
        raise RuntimeError(f"nms_keep_mask kernel launch failed: CUDA error {err}")
    tracing.count("nms_keep_mask.launches")
    return keep


tracing.count("nms_keep_mask.launches", 0)
