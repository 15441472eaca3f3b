"""The RPN's separable-conv downsample blocks fused for inference
(pillars_tpu/ops/rpn_pallas.py).

Each block is 1 + ``num_layers`` separable layers; each layer is a SAME 3x3
depthwise conv (stride 2: only the even centres), a 1x1 pointwise product
with the eval-mode BatchNorm folded into its weights and bias, and ReLU.
Activations are NHWC, as in the JAX package.

:func:`fused_sep_block_plain` is the plain PyTorch twin of the CUDA kernel
``csrc/rpn_sep_block.cu`` (wrapper :func:`pillars_torch.ops.rpn_cuda.
fused_sep_block`); :func:`fused_rpn_blocks` folds the port's ``state_dict``
per call and runs the three blocks through the wrapper, which launches the
kernel for a CUDA tensor and takes the twin for a CPU one.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import torch


class FoldedLayer(NamedTuple):
    """One separable layer with BN folded into the pointwise stage."""

    wd: torch.Tensor    # [3, 3, C_in] depthwise
    wp: torch.Tensor    # [C_in, C_out] pointwise (BN scale folded)
    bias: torch.Tensor  # [C_out] (BN shift folded)


def fold_block_params(state: Dict[str, torch.Tensor], block: str,
                      num_layers: int, eps: float) -> List[FoldedLayer]:
    """The 1 + ``num_layers`` layers of ``block`` (a state_dict prefix such
    as ``"rpn.block1"``) with BN folded in the JAX package's order:
    g = scale * rsqrt(var + eps), wp * g, bias - mean * g."""
    layers = []
    for i in range(num_layers + 1):
        conv, bn = f"{block}.conv{i}", f"{block}.bn{i}"
        wd = state[f"{conv}.depthwise.weight"][:, 0].permute(1, 2, 0)
        wp = state[f"{conv}.pointwise.weight"][:, :, 0, 0].t()
        g = state[f"{bn}.weight"] * torch.rsqrt(
            state[f"{bn}.running_var"] + eps)
        layers.append(FoldedLayer(
            wd.float().contiguous(), (wp * g[None, :]).float().contiguous(),
            (state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * g).float()))
    return layers


def _depthwise3x3(x: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 depthwise as 9 shifted multiply-adds in (dy, dx) order.
    x [B, H, W, C], wd [3, 3, C]."""
    h, w = x.shape[1:3]
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + padded[:, dy:dy + h, dx:dx + w, :] * wd[dy, dx]
    return acc


def fused_sep_block_plain(x: torch.Tensor, layers: Sequence[FoldedLayer],
                          num_layers: int, stride: int) -> torch.Tensor:
    """One fused block, plain PyTorch. x [B, H, W, C_in] -> [B, H/s, W/s,
    C_out]; at stride 2 the depthwise output keeps its even positions."""
    if len(layers) != num_layers + 1:
        raise ValueError(f"{len(layers)} layers for num_layers={num_layers}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    y = x
    for i, layer in enumerate(layers):
        z = _depthwise3x3(y, layer.wd)
        if i == 0 and stride == 2:
            z = z[:, ::2, ::2]
        y = torch.relu(torch.matmul(z, layer.wp) + layer.bias)
    return y


def fused_rpn_blocks(canvas: torch.Tensor, state: Dict[str, torch.Tensor],
                     rpn_cfg) -> List[torch.Tensor]:
    """The three fused blocks over a [B, H, W, C] canvas -> the per-block
    outputs [b1, b2, b3] (inputs to the deconv branches), NHWC."""
    from pillars_torch.ops.rpn_cuda import fused_sep_block

    outs = []
    # the kernel takes contiguous NHWC; a scattered canvas of B > 1 is a
    # slice of a padded buffer
    x = canvas.contiguous()
    for i in range(3):
        n = rpn_cfg.layer_nums[i]
        layers = fold_block_params(state, f"rpn.block{i + 1}", n,
                                   rpn_cfg.bn_eps)
        x = fused_sep_block(x, layers, n, rpn_cfg.layer_strides[i])
        outs.append(x)
    return outs
