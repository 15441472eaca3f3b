"""PillarFeatureNet over point-major layouts and the dense [P, N, D] layout
(pillars_tpu/models/pfn.py: DenseCellPFN, PointwisePFN, _PointwiseMaskedBN
and PillarFeatureNet; reference model/pointpillars.py:65-225).

Per point: 8 features (xyz, offset to the pillar's point mean, offset to the
pillar centre), Linear 8->128 without bias, BatchNorm, ReLU. Per pillar: one
scatter-max. Pillars with fewer than N points also take the max with
relu(bn(0)), the processed zero row of the reference's padded layout; empty
pillars are zero. Every module names its parameters ``dense`` and ``bn``, so
they load the same checkpoint (``PillarFeatureNet``'s only while
``pfn.with_distance`` is off: the flag widens its input by the point's
norm, and only this PFN reads it, as in the JAX package). Every PFN trains
with the batch statistics of the reference's dense layout, taken in float32.

``dtype`` (``runtime.compute_dtype``): the Linear computes in it, the BN
computes in float32 and rounds to it, and the scatter-max, its -inf fill,
relu(bn(0)) and the count channel are in it (models/layers.py); the pillar
features come out in it.

In eval, in float32, on CUDA tensors whose result needs no gradient (the
rule of models/layers.py::takes_kernel), ``PointwisePFN`` and
``DenseCellPFN`` are one kernel from the points to the pillar rows
(ops/pfn_cuda.py ``pfn_max``, csrc/pfn_max.cu); otherwise they compute what
its plain twin computes, in library ops that they share with it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pillars_torch.config import ModelConfig
from pillars_torch.models.layers import (BatchNorm, Linear, MaskedBatchNorm,
                                         at_least_f32, takes_kernel)
from pillars_torch.ops.pfn_cuda import (max_over_cells, max_over_pillars,
                                        pfn_max, pillar_centres,
                                        point_features)


class _PointwiseMaskedBN(BatchNorm):
    """BatchNorm over point-major activations [M, F] with the statistics of
    the reference's dense [P, N, F] layout. Returns (bn(x), bn(0)).

    Train mode: sums in float32 (at least) over kept points only (the dense
    layout's zero rows add nothing to them), divided by ``count`` = real
    pillars x N, the dense layout's row count; biased variance E[x^2] -
    E[x]^2 clipped at 0; the gradient flows through both. bn(x) is computed
    in float32 and returned in ``dtype`` (None: ``x``'s), bn(0) in
    float32."""

    def __init__(self, features: int, eps: float, momentum: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(features, eps, momentum, count_batches=False,
                         dtype=dtype)

    def forward(self, x, kept, count):
        if self.training:
            xf = at_least_f32(x)
            k = kept[:, None].to(xf.dtype)
            # under a group the row counts of every rank's pillars add up
            mean, var = self._moments(
                (xf * k).sum(dim=0), (xf * xf * k).sum(dim=0), count)
            self._record(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        y = (x - mean) * inv * self.weight + self.bias
        zero_vec = (0.0 - mean) * inv * self.weight + self.bias
        return y.to(self.compute_dtype or x.dtype), zero_vec


def _encode(pfn, points, mean, cx, cy, kept, count=None):
    """Per point: the 8 features (xyz, offset to the pillar's point mean
    ``mean`` [M, 3], offset to the pillar centre ``cx``/``cy``), zero where
    not ``kept``, through Linear + BN + ReLU -> (x [M, F], relu(bn(0)) [F]),
    both in the PFN's dtype. ``count``: the dense layout's row count, for
    train-mode statistics."""
    feats = point_features(points, mean, cx, cy)
    feats = torch.where(kept[:, None], feats, torch.zeros_like(feats))
    x, zero_vec = pfn.bn(pfn.dense(feats), kept, count)
    return torch.relu(x), torch.relu(zero_vec).to(x.dtype)


def _eval_params(pfn):
    """The Linear weight and the eval BN's vectors and eps, as
    ``pfn_max`` takes them."""
    bn = pfn.bn
    return (pfn.dense.weight, bn.running_mean, bn.running_var, bn.weight,
            bn.bias, bn.eps)


class PointwisePFN(nn.Module):
    """PFN over the point-major pillar layout (ops/voxelize.py
    VoxelizedPoints, batch folded into the point and pillar axes).

    Returns pillar features [P, F]; rows of padding pillars are zero."""

    def __init__(self, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        pcfg = cfg.pfn
        # like the JAX package's, this PFN reads no ``with_distance``
        self.dense = Linear(cfg.num_point_features + 5, pcfg.num_filters,
                            dtype=dtype)
        self.bn = _PointwiseMaskedBN(pcfg.num_filters, pcfg.bn_eps,
                                     pcfg.bn_momentum, dtype=dtype)

    def forward(self, points, point_pillar, point_kept, point_mean,
                point_zyx, num_points, pillar_mask):
        """points [M, D] (cell-sorted), point_pillar [M] (ids into the P
        rows, at most P), point_kept [M], point_mean [M, >=3], point_zyx
        [M, 3], num_points / pillar_mask [P]."""
        vcfg = self.cfg.voxel
        if takes_kernel(self.bn, points, point_mean, *self.parameters()):
            return pfn_max(points, point_mean, point_zyx, point_pillar,
                           point_kept, *_eval_params(self), vcfg,
                           num_points.shape[0], num_points=num_points,
                           pillar_mask=pillar_mask)
        cx, cy = pillar_centres(point_zyx, points.dtype, vcfg)
        # train-mode BN: real pillars x N rows of the dense layout
        count = (pillar_mask.sum() * vcfg.max_points_per_voxel
                 if self.training else None)
        x, zero_contrib = _encode(self, points, point_mean[:, :3], cx, cy,
                                  point_kept, count)
        return max_over_pillars(x, zero_contrib, point_pillar, point_kept,
                                num_points, pillar_mask,
                                vcfg.max_points_per_voxel)


class DenseCellPFN(nn.Module):
    """PFN over the dense CELL grid (ops/voxelize.py CellVoxelized layout).

    Returns (cell_feats [BC, F], num_points [BC] int32) with BC = batch *
    n_cells; rows of empty cells are zero."""

    def __init__(self, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        pcfg = cfg.pfn
        # like the JAX package's, this PFN reads no ``with_distance``
        self.dense = Linear(cfg.num_point_features + 5, pcfg.num_filters,
                            dtype=dtype)
        self.bn = _PointwiseMaskedBN(pcfg.num_filters, pcfg.bn_eps,
                                     pcfg.bn_momentum, dtype=dtype)

    def forward(self, points, cell_local, cell_global, kept, count, mean,
                n_cells_total: int, num_pillars=None):
        """points [M, D] (cell-sorted, batch-folded), cell_local [M] (id in
        the per-sample grid; sentinel n_cells when invalid), cell_global [M]
        (batch-offset), kept [M], count [M], mean [M, 3]; ``num_pillars``
        [] (occupied cells across the fold) sets the train-mode BN's row
        count ``num_pillars * N``, the dense layout's."""
        if self.training and num_pillars is None:
            raise ValueError("a train-mode DenseCellPFN needs num_pillars")
        vcfg = self.cfg.voxel
        if takes_kernel(self.bn, points, mean, *self.parameters()):
            return pfn_max(points, mean, cell_local, cell_global, kept,
                           *_eval_params(self), vcfg, n_cells_total,
                           count=count)
        # pillar-centre offsets straight from the cell id
        cx, cy = pillar_centres(cell_local, points.dtype, vcfg)
        rows = (num_pillars * vcfg.max_points_per_voxel if self.training
                else None)
        x, zero_contrib = _encode(self, points, mean, cx, cy, kept, rows)
        return max_over_cells(x, zero_contrib, cell_local, cell_global, kept,
                              count, n_cells_total, vcfg)


class PillarFeatureNet(nn.Module):
    """PFN over the dense layout (ops/voxelize.py VoxelizedSample, batch
    folded into the pillar axis): voxels [P, N, D] -> [P, F], the max over
    the N slots taken after Linear + BN + ReLU, so the processed zero rows
    of padded slots take part, as in the reference; rows of padding pillars
    are zero."""

    def __init__(self, cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        pcfg = cfg.pfn
        in_features = cfg.num_point_features + 5 + int(pcfg.with_distance)
        self.dense = Linear(in_features, pcfg.num_filters, dtype=dtype)
        self.bn = MaskedBatchNorm(pcfg.num_filters, pcfg.bn_eps,
                                  pcfg.bn_momentum, dtype=dtype)

    def forward(self, voxels, num_points, coords, pillar_mask):
        """voxels [P, N, D], num_points [P], coords [P, 3] (z, y, x),
        pillar_mask [P]."""
        vcfg = self.cfg.voxel
        vx, vy = vcfg.voxel_size[:2]
        pcr = vcfg.point_cloud_range
        n_slots = voxels.shape[1]
        npts = torch.clamp(num_points, min=1).to(voxels.dtype)[:, None, None]
        # offset to the pillar's point mean (padded slots are zero)
        f_cluster = voxels[..., :3] - voxels[..., :3].sum(
            dim=1, keepdim=True) / npts
        cx = coords[:, 2].to(voxels.dtype) * vx + (vx / 2 + pcr[0])
        cy = coords[:, 1].to(voxels.dtype) * vy + (vy / 2 + pcr[1])
        feats = [voxels, f_cluster, (voxels[..., 0] - cx[:, None])[..., None],
                 (voxels[..., 1] - cy[:, None])[..., None]]
        if self.cfg.pfn.with_distance:
            feats.append(torch.linalg.vector_norm(voxels[..., :3], dim=-1,
                                                  keepdim=True))
        feats = torch.cat(feats, dim=-1)
        slot = torch.arange(n_slots, device=voxels.device)
        point_mask = (slot[None, :] < num_points[:, None]).to(feats.dtype)
        feats = feats * point_mask[..., None]
        x = torch.relu(self.bn(self.dense(feats), pillar_mask[:, None]))
        out = x.amax(dim=1)
        return torch.where(pillar_mask[:, None], out, torch.zeros_like(out))
