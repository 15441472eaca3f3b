"""Wrappers of the fused RPN block kernel (``csrc/rpn_sep_block.cu``).

The port of pillars_tpu/ops/rpn_pallas.py::fused_sep_block. The kernel runs
a chain of blocks in one launch: :func:`fused_sep_chain` gives it packed
blocks (the RPN's three), :func:`fused_sep_block` one block as folded
layers. A float32 input runs the float32 kernel; a bfloat16 input the
bfloat16 one (bfloat16 in and out, float32 inside each block, the Pallas
kernel under ``runtime.compute_dtype=bfloat16``); any other dtype raises. A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin :func:`pillars_torch.ops.rpn_blocks.fused_sep_block_plain`.
The counter ``fused_sep_block.launches`` (utils/tracing.py) counts kernel
launches of either wrapper and either dtype, ``fused_sep_block.launches_bf16``
those of the bfloat16 kernel among them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from pillars_torch.ops import _build
from pillars_torch.ops.rpn_blocks import (FoldedLayer, PackedBlock,
                                          fused_sep_block_plain, pack_block)
from pillars_torch.utils import tracing

MAX_BLOCKS = 4  # blocks per launch (kMaxBlocks in the source)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _fn(defines: Tuple[str, ...] = (), bf16: bool = False):
    lib = _build.load("rpn_sep_block", defines)
    fn = lib.rpn_sep_chain_bf16 if bf16 else lib.rpn_sep_chain
    int_p, ptr_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        int_p, int_p, int_p, ptr_p, ptr_p] + [ctypes.c_void_p] * (
            3 if bf16 else 2)  # the scratch buffers and the stream
    fn.restype = ctypes.c_int
    return fn


def _check_block(block: PackedBlock, h: int, w: int, cin: int,
                 device: torch.device) -> None:
    """Validates one packed block against its input [.., h, w, cin]."""
    if block.stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"stride 2 needs even H and W, got {h}x{w}")
    if block.cin != cin:
        raise ValueError(f"block takes {block.cin} channels, input has {cin}")
    if cin % 4 or block.cout % 4:
        raise ValueError(f"channels must be multiples of 4, got {cin}->"
                         f"{block.cout}")
    p = block.packed
    if p.device != device:
        raise ValueError(f"weights on {p.device}, input on {device}")
    if p.dtype != torch.float32 or not p.is_contiguous() or p.data_ptr() % 16:
        raise ValueError("packed weights must be a contiguous, 16-byte "
                         "aligned float32 tensor")


def _launch(x: torch.Tensor, blocks: Sequence[PackedBlock],
            couts: Sequence[int],
            defines: Tuple[str, ...]) -> List[torch.Tensor]:
    """One kernel launch for up to MAX_BLOCKS validated blocks."""
    b, h, w, cin = x.shape
    bf16 = x.dtype == torch.bfloat16
    outs = []
    for block, cout in zip(blocks, couts):
        h, w = h // block.stride, w // block.stride
        outs.append(torch.empty((b, h, w, cout), dtype=x.dtype,
                                device=x.device))
    # the layers inside a block keep float32 activations: one scratch
    # buffer beside a float32 output, two beside a bfloat16 one
    size = max(o.numel() for o in outs)
    scratch = torch.empty((2 if bf16 else 1) * size, dtype=torch.float32,
                          device=x.device)
    scratch_ptrs = ([scratch.data_ptr(), scratch[size:].data_ptr()] if bf16
                    else [scratch.data_ptr()])
    n = len(blocks)
    ints = lambda vals: (ctypes.c_int * n)(*vals)  # noqa: E731
    ptrs = lambda ts: (ctypes.c_void_p * n)(  # noqa: E731
        *(t.data_ptr() for t in ts))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _fn(defines, bf16)(
            x.data_ptr(), *x.shape, n, ints(couts),
            ints([blk.num_layers for blk in blocks]),
            ints([blk.stride for blk in blocks]), ptrs(outs),
            ptrs([blk.packed for blk in blocks]), *scratch_ptrs, stream)
    if err != 0:
        raise RuntimeError(f"rpn_sep_block kernel launch failed: CUDA error "
                           f"{err} (1 also when a tile's buffers exceed the "
                           f"SM's shared memory: fewer channels fit)")
    tracing.count("fused_sep_block.launches")
    if bf16:
        tracing.count("fused_sep_block.launches_bf16")
    return outs


def fused_sep_chain(x: torch.Tensor, blocks: Sequence[PackedBlock],
                    defines: Tuple[str, ...] = ()) -> List[torch.Tensor]:
    """x [B, H, W, C_in] NHWC, float32 or bfloat16, through ``blocks`` one
    after the other -> every block's output [B, H_i, W_i, C_i] in x's dtype,
    in one launch per MAX_BLOCKS blocks. ``defines`` builds and launches the
    kernel with these ``-D`` flags (its instrumentation, see
    utils/kernel_phases.py)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        outs = []
        for blk in blocks:
            x = fused_sep_block_plain(x, blk.layers, blk.num_layers,
                                      blk.stride)
            outs.append(x)
        return outs
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous (NHWC) and 16-byte aligned")
    _, h, w, cin = x.shape
    for blk in blocks:
        _check_block(blk, h, w, cin, x.device)
        h, w, cin = h // blk.stride, w // blk.stride, blk.cout
    couts = [blk.cout for blk in blocks]
    if x.numel() == 0:
        outs = []
        for blk, cout in zip(blocks, couts):
            x = x.new_empty((x.shape[0], x.shape[1] // blk.stride,
                             x.shape[2] // blk.stride, cout))
            outs.append(x)
        return outs
    outs = []
    for i in range(0, len(blocks), MAX_BLOCKS):
        outs += _launch(x, blocks[i:i + MAX_BLOCKS], couts[i:i + MAX_BLOCKS],
                        tuple(defines))
        x = outs[-1]
    return outs


def fused_sep_block(x: torch.Tensor, layers: Sequence[FoldedLayer],
                    num_layers: int, stride: int) -> torch.Tensor:
    """x [B, H, W, C_in] NHWC (float32 or bfloat16) + 1 + ``num_layers``
    folded layers -> [B, H/stride, W/stride, C_out] in x's dtype."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return fused_sep_block_plain(x, layers, num_layers, stride)
    return fused_sep_chain(x, [pack_block(layers, num_layers, stride)])[0]


tracing.count("fused_sep_block.launches", 0)
tracing.count("fused_sep_block.launches_bf16", 0)
