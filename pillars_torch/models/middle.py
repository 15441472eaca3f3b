"""SECOND's dense voxel middle extractor (pillars_tpu/models/middle.py):
the voxel features scattered into a dense [nz, ny, nx, C] grid, 3x3x3
conv3d stages with z-stride 2, each followed by BN and ReLU, then the
surviving z-layers folded into channels for the RPN. Sized for d435i-scale
grids (80 x 64 x 16 at voxel_z 0.375); models/sparse_middle.py serves the
grids a dense activation cannot hold.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pillars_torch.config import ModelConfig
from pillars_torch.models.layers import BatchNorm, Conv3d

STRIDE = (2, 1, 1)


def scatter_to_grid3d(features: torch.Tensor, coords: torch.Tensor,
                      pillar_mask: torch.Tensor, nz: int, ny: int,
                      nx: int) -> torch.Tensor:
    """[B, V, C] voxel features + [B, V, 3] (z, y, x) -> [B, nz, ny, nx, C]
    dense. Features ADD where two rows share a cell, as the JAX package's
    scatter does; padding rows go to a spare row that is dropped."""
    b, _, c = features.shape
    n_cells = nz * ny * nx
    flat = (coords[..., 0].long() * ny + coords[..., 1]) * nx + coords[..., 2]
    flat = flat + torch.arange(b, device=flat.device)[:, None] * n_cells
    flat = torch.where(pillar_mask, flat, torch.full_like(flat, b * n_cells))
    feats = torch.where(pillar_mask[..., None], features,
                        torch.zeros_like(features))
    grid = features.new_zeros((b * n_cells + 1, c)).index_add(
        0, flat.reshape(-1), feats.reshape(-1, c))
    return grid[:-1].reshape(b, nz, ny, nx, c)


def same_pads(sizes: Sequence[int], kernel: int, strides: Sequence[int]):
    """flax ``padding="SAME"``: per dim (before, after), the extra one
    after. At stride 2 on an even size that is (0, 1), not nn.Conv3d's
    symmetric 1."""
    pads = []
    for n, s in zip(sizes, strides):
        total = max((-(-n // s) - 1) * s + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def output_depth(mcfg: ModelConfig) -> int:
    """The z-layers left after the stages (SAME: ceil(nz / 2) each)."""
    nz = int(mcfg.voxel.grid_size[2])
    for _ in mcfg.middle.num_filters:
        nz = -(-nz // STRIDE[0])
    return nz


class MiddleExtractor3D(nn.Module):
    """Dense 3D conv stack over the voxel grid; folds z into channels.
    Layers ``conv3d_{i}`` (no bias) and ``bn{i}``, as the JAX package
    names them; convs and BNs in ``dtype`` (models/layers.py)."""

    def __init__(self, mcfg: ModelConfig, in_ch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        rcfg = mcfg.rpn
        self.n = len(mcfg.middle.num_filters)
        cin = in_ch
        for i, f in enumerate(mcfg.middle.num_filters):
            self.add_module(f"conv3d_{i}", Conv3d(cin, f, 3, stride=STRIDE,
                                                  dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(f, rcfg.bn_eps,
                                                rcfg.bn_momentum, dtype=dtype))
            cin = f

    def forward(self, grid):
        """grid [B, nz, ny, nx, C] -> BEV canvas [B, ny, nx, nz'*C']
        (channel z*C' + c)."""
        x = grid.permute(0, 4, 1, 2, 3)
        for i in range(self.n):
            (z0, z1), (y0, y1), (x0, x1) = same_pads(x.shape[2:], 3, STRIDE)
            x = F.pad(x, (x0, x1, y0, y1, z0, z1))
            x = getattr(self, f"conv3d_{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        b, c, nz, ny, nx = x.shape
        return x.permute(0, 3, 4, 2, 1).reshape(b, ny, nx, nz * c)
