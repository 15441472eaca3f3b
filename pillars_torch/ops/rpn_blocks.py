"""The RPN's separable-conv downsample blocks fused for inference
(pillars_tpu/ops/rpn_pallas.py).

Each block is 1 + ``num_layers`` separable layers; each layer is a SAME 3x3
depthwise conv (stride 2: only the even centres), a 1x1 pointwise product
with the eval-mode BatchNorm folded into its weights and bias, and ReLU.
Activations are NHWC, as in the JAX package. A block reads float32 or
bfloat16 and writes its input's dtype; inside, every layer computes in
float32 from float32 folded weights, so a bfloat16 block rounds once, at
its output (the Pallas kernel under ``runtime.compute_dtype=bfloat16``).

:func:`fused_sep_block_plain` is the plain PyTorch twin of the CUDA kernel
``csrc/rpn_sep_block.cu`` (wrappers :func:`pillars_torch.ops.rpn_cuda.
fused_sep_block` and ``fused_sep_chain``); :func:`fused_rpn_blocks` folds
and packs the three blocks of the port's ``state_dict`` (per call, or once
per state through a :class:`FoldedBlocksCache`) and runs them through the
chain wrapper, which launches the kernel once for a CUDA tensor and takes
the twin for a CPU one.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


class FoldedLayer(NamedTuple):
    """One separable layer with BN folded into the pointwise stage."""

    wd: torch.Tensor    # [3, 3, C_in] depthwise
    wp: torch.Tensor    # [C_in, C_out] pointwise (BN scale folded)
    bias: torch.Tensor  # [C_out] (BN shift folded)


class PackedBlock(NamedTuple):
    """One block ready for the kernel, as :func:`pack_block` makes it: its
    folded layers, checked once, and the same numbers as one flat tensor."""

    layers: Tuple[FoldedLayer, ...]
    packed: torch.Tensor  # per layer wd, wp, bias, flattened, in order
    num_layers: int
    stride: int
    cin: int
    cout: int


def pack_block(layers: Sequence[FoldedLayer], num_layers: int,
               stride: int) -> PackedBlock:
    """``layers`` checked against each other (1 + ``num_layers`` float32
    layers on one device, wd [3, 3, C], wp [C, C_out], bias [C_out], C =
    C_out after the first) with their flat copy, the kernel's weight
    argument."""
    if len(layers) != num_layers + 1:
        raise ValueError(f"{len(layers)} layers for num_layers={num_layers}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    cin, cout = layers[0].wp.shape
    device = layers[0].wp.device
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
                raise ValueError(f"layer {i}: weights on {t.device} and "
                                 f"{device}")
    return PackedBlock(tuple(layers), torch.cat(
        [t.reshape(-1) for layer in layers for t in layer]), num_layers,
        stride, cin, cout)


def _layer_keys(block: str, i: int) -> Tuple[str, ...]:
    """The state_dict entries that layer ``i`` of ``block`` is folded from."""
    conv, bn = f"{block}.conv{i}", f"{block}.bn{i}"
    return (f"{conv}.depthwise.weight", f"{conv}.pointwise.weight",
            f"{bn}.weight", f"{bn}.bias", f"{bn}.running_mean",
            f"{bn}.running_var")


def fold_block_params(state: Dict[str, torch.Tensor], block: str,
                      num_layers: int, eps: float) -> List[FoldedLayer]:
    """The 1 + ``num_layers`` layers of ``block`` (a state_dict prefix such
    as ``"rpn.block1"``) with BN folded in the JAX package's order:
    g = scale * rsqrt(var + eps), wp * g, bias - mean * g."""
    layers = []
    for i in range(num_layers + 1):
        dw, pw, scale, shift, mean, var = (
            state[key] for key in _layer_keys(block, i))
        wd = dw[:, 0].permute(1, 2, 0)
        wp = pw[:, :, 0, 0].t()
        g = scale * torch.rsqrt(var + eps)
        layers.append(FoldedLayer(
            wd.float().contiguous(), (wp * g[None, :]).float().contiguous(),
            (shift - mean * g).float()))
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
    C_out] in x's dtype, computed in float32; at stride 2 the depthwise
    output keeps its even positions."""
    if len(layers) != num_layers + 1:
        raise ValueError(f"{len(layers)} layers for num_layers={num_layers}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    y = x.float()
    for i, layer in enumerate(layers):
        z = _depthwise3x3(y, layer.wd)
        if i == 0 and stride == 2:
            z = z[:, ::2, ::2]
        y = torch.relu(torch.matmul(z, layer.wp) + layer.bias)
    return y.to(x.dtype)


def fold_rpn_blocks(state: Dict[str, torch.Tensor],
                    rpn_cfg) -> List[PackedBlock]:
    """The RPN's three blocks folded and packed from ``state``."""
    return [pack_block(fold_block_params(state, f"rpn.block{i + 1}", n,
                                         rpn_cfg.bn_eps), n,
                       rpn_cfg.layer_strides[i])
            for i, n in enumerate(rpn_cfg.layer_nums[:3])]


class FoldedBlocksCache:
    """The folded, packed blocks of the last ``state`` seen, kept while that
    state is unchanged: the same tensor objects at the same versions (an
    in-place write bumps a tensor's version) under the same config values.
    Inference tensors carry no version; a state that holds one is folded on
    every call. ``folds`` counts the folds."""

    def __init__(self):
        self.folds = 0
        self._key = None
        self._tensors: Tuple[torch.Tensor, ...] = ()
        self._blocks: Optional[List[PackedBlock]] = None

    def blocks(self, state: Dict[str, torch.Tensor],
               rpn_cfg) -> List[PackedBlock]:
        nums = tuple(rpn_cfg.layer_nums[:3])
        tensors = tuple(state[key] for b, n in enumerate(nums)
                        for i in range(n + 1)
                        for key in _layer_keys(f"rpn.block{b + 1}", i))
        versioned = not any(t.is_inference() for t in tensors)
        key = (nums, tuple(rpn_cfg.layer_strides[:3]), rpn_cfg.bn_eps,
               tuple(t._version for t in tensors)) if versioned else None
        if (key is None or key != self._key
                or len(tensors) != len(self._tensors)
                or any(a is not b for a, b in zip(tensors, self._tensors))):
            self._blocks = fold_rpn_blocks(state, rpn_cfg)
            self._key, self._tensors = key, tensors
            self.folds += 1
        return self._blocks


def fused_rpn_blocks(canvas: torch.Tensor, state: Dict[str, torch.Tensor],
                     rpn_cfg, cache: Optional[FoldedBlocksCache] = None
                     ) -> List[torch.Tensor]:
    """The three fused blocks over a [B, H, W, C] canvas -> the per-block
    outputs [b1, b2, b3] (inputs to the deconv branches), NHWC. The blocks
    are folded from ``state`` on every call, or through ``cache`` (a
    :class:`FoldedBlocksCache`, or any object with its ``blocks`` method:
    the static state of the captured graphs, pillars_torch/cuda_graph.py)."""
    from pillars_torch.ops.rpn_cuda import fused_sep_chain

    blocks = (fold_rpn_blocks(state, rpn_cfg) if cache is None
              else cache.blocks(state, rpn_cfg))
    # the kernel takes contiguous NHWC; a scattered canvas of B > 1 is a
    # slice of a padded buffer
    return fused_sep_chain(canvas.contiguous(), blocks)
