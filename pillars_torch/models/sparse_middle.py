"""SECOND sparse voxel middle extractor (pillars_tpu/models/sparse_middle.py;
second.pytorch's SpMiddle topology at reduced depth).

Per stage: submanifold 3x3x3 convs over the active voxel set (one rulebook
serves every submanifold layer of the stage, since they keep the set), then
a strided sparse conv to the next stage's set; the surviving z-layers fold
into channels to form the BEV canvas the RPN reads. The rulebooks of the
whole batch are built at once (ops/sparse_conv.py takes a batch axis); the
batch then folds into the row axis, so one gather and one matmul per layer
serve the batch, and BN statistics span every active voxel in it.
``dtype`` (``runtime.compute_dtype``): each layer's gather and matmul take
its input and taps in it, and its BN rounds to it (models/layers.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from pillars_torch.config import ModelConfig
from pillars_torch.models.layers import promote
from pillars_torch.models.pfn import _PointwiseMaskedBN
from pillars_torch.ops import sparse_conv as sp


def stage_plan(mcfg: ModelConfig):
    """(num_filters, strides, kernels) of the middle's stages."""
    m = mcfg.middle
    n = len(m.num_filters)
    strides = m.downsample_strides or tuple((2, 1, 1) for _ in range(n))
    kernels = m.downsample_kernels or tuple((3, 3, 3) for _ in range(n))
    assert len(strides) == n and len(kernels) == n, (
        "downsample_strides/kernels must have one entry per stage")
    return m.num_filters, strides, kernels


def output_dims(mcfg: ModelConfig):
    """(nz, ny, nx) of the last stage's grid."""
    gx, gy, gz = mcfg.voxel.grid_size
    dims = (int(gz), int(gy), int(gx))
    _, strides, kernels = stage_plan(mcfg)
    for stride, kernel in zip(strides, kernels):
        dims = tuple(sp.conv_out_dim(n, k, s, (k - 1) // 2)
                     for n, k, s in zip(dims, kernel, stride))
    return dims


class _SparseConvLayer(nn.Module):
    """One sparse conv (submanifold or strided, as the rulebook passed in
    says) + masked BN + ReLU over batch-folded rows. ``weight`` is the flax
    layout [K, Cin, Cout]."""

    def __init__(self, taps: int, in_ch: int, features: int, eps: float,
                 momentum: float, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(taps, in_ch, features))
        self.bn = _PointwiseMaskedBN(features, eps, momentum, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, nbr_global, valid):
        """x [R, Cin] folded rows, nbr_global [Ro, K] global rows (sentinel
        R), valid [Ro] -> [Ro, Cout]; padding rows exactly zero, so they
        stay inert for the next gathers and the canvas scatter."""
        x, w = promote(self.dtype, x, self.weight)
        y = sp.gather_conv(x, nbr_global, w)
        count = valid.sum() if self.training else None
        y, _ = self.bn(y, valid, count)
        return torch.where(valid[:, None], torch.relu(y), torch.zeros_like(y))


class SparseMiddleExtractor(nn.Module):
    """cfg.middle: ``num_filters`` per stage, ``subm_per_stage`` submanifold
    convs per stage (one more in the first), then a strided conv with
    ``downsample_strides[i]`` / ``downsample_kernels[i]`` to the next
    stage's width. Layers are named as the JAX package's: ``subm{i}_{j}``,
    ``down{i}``."""

    def __init__(self, mcfg: ModelConfig, in_ch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mcfg = mcfg
        m, rcfg = mcfg.middle, mcfg.rpn
        filters, _, kernels = stage_plan(mcfg)
        cin = in_ch
        for i, f in enumerate(filters):
            for j in range(m.subm_per_stage + (1 if i == 0 else 0)):
                self.add_module(f"subm{i}_{j}", _SparseConvLayer(
                    27, cin, f, rcfg.bn_eps, rcfg.bn_momentum, dtype))
                cin = f
            out_f = filters[min(i + 1, len(filters) - 1)]
            self.add_module(f"down{i}", _SparseConvLayer(
                math.prod(kernels[i]), cin, out_f,
                rcfg.bn_eps, rcfg.bn_momentum, dtype))
            cin = out_f

    def rulebooks(self, coords, mask):
        """The active sets and rulebooks of every stage, per sample:
        [(keys [B, V], valid, subm nbr [B, V, 27], out_keys [B, Vo],
        out_valid, down nbr [B, Vo, K])], then (keys, valid, dims) of the
        last set."""
        m = self.mcfg.middle
        gx, gy, gz = self.mcfg.voxel.grid_size
        dims = (int(gz), int(gy), int(gx))
        max_active = m.max_active or mask.shape[1]
        _, strides, kernels = stage_plan(self.mcfg)
        n_cells = dims[0] * dims[1] * dims[2]
        keys = (coords[..., 0].long() * dims[1] + coords[..., 1]) * dims[2] \
            + coords[..., 2]
        keys = torch.where(mask, keys, torch.full_like(keys, n_cells))
        valid = mask
        stages = []
        for stride, kernel in zip(strides, kernels):
            subm = sp.neighbor_indices(keys, valid, dims, (3, 3, 3))
            pad = tuple((k - 1) // 2 for k in kernel)
            okeys, ovalid, odims = sp.downsample_active_set(
                keys, valid, dims, kernel, stride, pad, max_active)
            down = sp.strided_rulebook(keys, valid, okeys, ovalid, dims,
                                       odims, kernel, stride, pad)
            stages.append((keys, valid, subm, okeys, ovalid, down))
            keys, valid, dims = okeys, ovalid, odims
        return stages, (keys, valid, dims)

    def forward(self, features, coords, mask):
        """features [B, V, C], coords [B, V, 3] (z, y, x) in ascending key
        order with the real voxels first (the voxelizer layout), mask
        [B, V] -> BEV canvas [B, ny', nx', nz'*C'] (channel z*C' + c)."""
        b = features.shape[0]
        stages, (keys, valid, dims) = self.rulebooks(coords, mask)
        x = features.reshape(-1, features.shape[-1])
        rows = torch.arange(b, device=features.device)[:, None, None]

        def fold(nbr, cap):
            """per-sample [B, Vo, K] (sentinel cap) -> global [B*Vo, K]
            (sentinel B*cap)."""
            g = torch.where(nbr == cap, torch.full_like(nbr, b * cap),
                            nbr + rows * cap)
            return g.reshape(-1, g.shape[-1])

        for i, (skeys, svalid, subm, _, ovalid, down) in enumerate(stages):
            cap = skeys.shape[1]
            nbr = fold(subm, cap)
            vflat = svalid.reshape(-1)
            n_subm = self.mcfg.middle.subm_per_stage + (1 if i == 0 else 0)
            for j in range(n_subm):
                x = getattr(self, f"subm{i}_{j}")(x, nbr, vflat)
            x = getattr(self, f"down{i}")(x, fold(down, cap),
                                          ovalid.reshape(-1))

        # scatter the last active set straight into the z-folded layout:
        # voxel (z, y, x) of sample s is row ((s*ny + y)*nx + x)*nz + z of
        # a [B*ny*nx*nz, C] canvas, so reshaping to [B, ny, nx, nz*C] puts
        # its channels at z*C + c. Keys are unique, so each row takes one
        # value (the add is exact); padding rows go to a spare row that is
        # dropped
        onz, ony, onx = dims
        c_out = x.shape[-1]
        z = torch.div(keys, ony * onx, rounding_mode="floor")
        yx = keys - z * (ony * onx)
        sample = torch.arange(b, device=keys.device)[:, None]
        row = (sample * (ony * onx) + yx) * onz + z
        row = torch.where(valid, row, torch.full_like(row, b * ony * onx * onz))
        canvas = x.new_zeros((b * ony * onx * onz + 1, c_out)).index_add(
            0, row.reshape(-1), x)
        return canvas[:-1].reshape(b, ony, onx, onz * c_out)
