"""Dense-cell voxelization (pillars_tpu/ops/voxelize.py::voxelize_cells).

The pillar index space is the cell grid itself, usable whenever the grid has
no more cells than ``max_voxels`` (the d435i config: 80*64*2 = 10240 cells
< 12000), so the reference's pillar compaction is the identity. Points are
stably sorted by cell; each cell keeps its first ``max_points_per_voxel``
points in input order (reference load_data.py:593-692).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pillars_torch.config import VoxelConfig


class CellVoxelized(NamedTuple):
    """Dense-cell voxelization of a BATCH; every array is per POINT.

    points:  [B, MAXPTS, D] cell-id-sorted points (stable within a cell)
    cell:    [B, MAXPTS] int32 sorted per-sample cell id; sentinel n_cells
             for out-of-range/padding points
    kept:    [B, MAXPTS] bool (in range and rank < max_points_per_voxel)
    count:   [B, MAXPTS] int32 kept points in this point's cell (capped at
             N); 0 for invalid points
    mean:    [B, MAXPTS, 3] xyz mean over the cell's KEPT points (defined on
             valid points only)
    num_pillars: [] int32 occupied cells across the batch
    """

    points: torch.Tensor
    cell: torch.Tensor
    kept: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    num_pillars: torch.Tensor


def voxelize_cells(points: torch.Tensor, num_valid: torch.Tensor, *,
                   voxel_size, point_cloud_range, grid_size,
                   max_points_per_voxel: int) -> CellVoxelized:
    """points [B, MAXPTS, D], num_valid [B] -> :class:`CellVoxelized`.

    The sort key ``cell * MAXPTS + index`` is unique, so the sort order is
    unambiguous. Segment starts come from a running max, segment ends from a
    reverse running min; the per-cell mean is one segment sum (index_add_
    over the segment id) for any batch size."""
    b, maxpts, dim = points.shape
    dev = points.device
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=dev)
    pcr = torch.as_tensor(point_cloud_range, dtype=points.dtype, device=dev)
    nx, ny, nz = (int(g) for g in grid_size)
    n_cells = nx * ny * nz
    N = int(max_points_per_voxel)

    idx = torch.arange(maxpts, dtype=torch.int64, device=dev)[None]  # [1, M]
    in_count = idx < num_valid.to(dev)[:, None]
    c = torch.floor((points[..., :3] - pcr[:3]) / vs).to(torch.int32)
    gs = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = in_count & ((c >= 0) & (c < gs)).all(dim=-1)
    cell = (c[..., 2] * ny + c[..., 1]) * nx + c[..., 0]
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))

    key = cell.to(torch.int64) * maxpts + idx
    key_s, perm = torch.sort(key, dim=1, stable=True)
    points_s = torch.gather(points, 1, perm[..., None].expand(-1, -1, dim))
    cell_s = key_s // maxpts
    valid_s = cell_s < n_cells

    prev = torch.cat([torch.full((b, 1), -1, dtype=cell_s.dtype, device=dev),
                      cell_s[:, :-1]], dim=1)
    is_start = cell_s != prev
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=1).values
    rank = idx - seg_start
    kept = valid_s & (rank < N)

    # segment end (= next segment's start) via a reverse running min over
    # next-start candidates; the sentinel segment sits at the tail
    full_m = torch.full((b, 1), maxpts, dtype=torch.int64, device=dev)
    nxt_candidate = torch.cat(
        [torch.where(is_start[:, 1:], idx[:, 1:],
                     full_m.expand(-1, maxpts - 1)), full_m], dim=1)
    seg_end = torch.cummin(nxt_candidate.flip(1), dim=1).values.flip(1)
    seg_len = seg_end - seg_start
    count = torch.where(valid_s, torch.clamp_max(seg_len, N),
                        torch.zeros_like(seg_len)).to(torch.int32)

    # per-cell xyz mean over kept points: one sum per segment, gathered back
    seg_id = (torch.cumsum(is_start.to(torch.int64), dim=1) - 1
              + torch.arange(b, device=dev)[:, None] * maxpts).reshape(-1)
    vals = torch.where(kept[..., None], points_s[..., :3],
                       torch.zeros_like(points_s[..., :3])).reshape(-1, 3)
    sums = torch.zeros((b * maxpts, 3), dtype=points.dtype, device=dev)
    sums.index_add_(0, seg_id, vals)
    denom = torch.clamp_min(count, 1).to(points.dtype)[..., None]
    mean = sums[seg_id].reshape(b, maxpts, 3) / denom

    num_pillars = (is_start & valid_s).sum().to(torch.int32)
    return CellVoxelized(points_s, cell_s.to(torch.int32), kept, count, mean,
                         num_pillars)


def make_cell_voxelizer(cfg: VoxelConfig):
    """Bound dense-cell voxelizer. Only valid when the grid fits inside
    max_voxels (no pillar capping possible)."""
    nx, ny, nz = cfg.grid_size
    if nx * ny * nz > cfg.max_voxels:
        raise ValueError(
            f"dense-cell voxelizer needs n_cells <= max_voxels "
            f"({nx * ny * nz} > {cfg.max_voxels})")
    return functools.partial(
        voxelize_cells,
        voxel_size=np.asarray(cfg.voxel_size, np.float32),
        point_cloud_range=np.asarray(cfg.point_cloud_range, np.float32),
        grid_size=cfg.grid_size,
        max_points_per_voxel=cfg.max_points_per_voxel,
    )
