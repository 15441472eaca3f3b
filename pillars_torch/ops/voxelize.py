"""Voxelization (pillars_tpu/ops/voxelize.py): the dense-cell layout
(``voxelize_cells``) and the point-major pillar layout (``voxelize_points``).

Dense cell: the pillar index space is the cell grid itself, usable whenever
the grid has no more cells than ``max_voxels`` (the d435i config: 80*64*2 =
10240 cells < 12000), so the reference's pillar compaction is the identity.
Point-major: pillars are numbered in ascending cell order, and per-pillar
tables ([P] counts, coords, means) are scattered from the sorted points.

Both stably sort points by cell; each cell keeps its first
``max_points_per_voxel`` points in input order (reference
load_data.py:593-692).
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


class VoxelizedPoints(NamedTuple):
    """Point-major voxelization of a BATCH (every array has a leading B).

    points:       [B, MAXPTS, D] cell-sorted points (padding at the tail)
    point_pillar: [B, MAXPTS] int32 pillar id per point, non-decreasing;
                  the sentinel segment (invalid points) carries the count of
                  real pillars with ``point_kept`` false
    point_kept:   [B, MAXPTS] bool (in range, rank < max_points_per_voxel)
    point_mean:   [B, MAXPTS, D] per-feature mean over the point's pillar's
                  kept points
    point_zyx:    [B, MAXPTS, 3] int32 grid cell (z, y, x) of each point
    num_points:   [B, P] int32 kept points per pillar
    coords:       [B, P, 3] int32 (z, y, x); zeros for padding pillars
    pillar_mask:  [B, P] bool
    voxel_mean:   [B, P, D] per-pillar feature means; zeros on padding
    """

    points: torch.Tensor
    point_pillar: torch.Tensor
    point_kept: torch.Tensor
    point_mean: torch.Tensor
    point_zyx: torch.Tensor
    num_points: torch.Tensor
    coords: torch.Tensor
    pillar_mask: torch.Tensor
    voxel_mean: torch.Tensor


def voxelize_points(points: torch.Tensor, num_valid: torch.Tensor, *,
                    voxel_size, point_cloud_range, grid_size,
                    max_points_per_voxel: int,
                    max_voxels: int) -> VoxelizedPoints:
    """points [B, MAXPTS, D], num_valid [B] -> :class:`VoxelizedPoints`,
    each sample as pillars_tpu's ``voxelize_points`` gives it.

    Only the regime n_cells <= max_voxels is ported (no pillar can be
    dropped); larger grids, whose arrival-order pillar cap needs the
    reference's point-stream cutoff, raise ``NotImplementedError``.

    Per-pillar means sum each point relative to its cell centre (the same
    for every point of a pillar) and add the centre back, as the JAX
    package does, so the rounding stays at the scale of a cell."""
    b, maxpts, dim = points.shape
    dev = points.device
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=dev)
    pcr = torch.as_tensor(point_cloud_range, dtype=points.dtype, device=dev)
    nx, ny, nz = (int(g) for g in grid_size)
    n_cells = nx * ny * nz
    P = int(max_voxels)
    N = int(max_points_per_voxel)
    if n_cells > P:
        raise NotImplementedError(
            f"voxelize_points with more cells than max_voxels ({n_cells} > "
            f"{P}): the arrival-order pillar cap is not ported yet")

    idx = torch.arange(maxpts, dtype=torch.int64, device=dev)[None]  # [1, M]
    in_count = idx < num_valid.to(dev)[:, None]
    c = torch.floor((points[..., :3] - pcr[:3]) / vs).to(torch.int32)
    gs = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    valid = in_count & ((c >= 0) & (c < gs)).all(dim=-1)
    cell = (c[..., 2] * ny + c[..., 1]) * nx + c[..., 0]
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))

    # unique key: the sort keeps input order within a cell
    key_s, perm = torch.sort(cell.to(torch.int64) * maxpts + idx, dim=1)
    points_s = torch.gather(points, 1, perm[..., None].expand(-1, -1, dim))
    cell_s = key_s // maxpts
    valid_s = cell_s < n_cells

    prev = torch.cat([torch.full((b, 1), -1, dtype=cell_s.dtype, device=dev),
                      cell_s[:, :-1]], dim=1)
    is_start = cell_s != prev
    pillar_id = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=1).values
    keep = valid_s & (idx - seg_start < N) & (pillar_id < P)
    point_pillar = torch.clamp_max(pillar_id, P)

    z = torch.div(cell_s, ny * nx, rounding_mode="floor")
    rem = cell_s - z * (ny * nx)
    y = torch.div(rem, nx, rounding_mode="floor")
    x = rem - y * nx
    zyx = torch.stack([z, y, x], dim=-1).to(torch.int32)

    # per-pillar sums of kept points relative to the cell centre, plus a
    # kept-count column; one sum per segment (the sentinel segment of
    # invalid points is a segment of its own), gathered back per point
    cell_center = (torch.stack([x, y, z], dim=-1).to(points.dtype) + 0.5
                   ) * vs[:3] + pcr[:3]
    centered = torch.cat([points_s[..., :3] - cell_center, points_s[..., 3:],
                          torch.ones_like(points_s[..., :1])], dim=-1)
    vals = torch.where(keep[..., None], centered, torch.zeros_like(centered))
    seg = (pillar_id + torch.arange(b, device=dev)[:, None] * maxpts
           ).reshape(-1)
    sums = torch.zeros((b * maxpts, dim + 1), dtype=points.dtype, device=dev)
    sums.index_add_(0, seg, vals.reshape(-1, dim + 1))
    total = sums[seg].reshape(b, maxpts, dim + 1)
    denom = torch.clamp_min(total[..., dim:], 1.0)
    point_mean = total[..., :dim] / denom
    point_mean = torch.cat([point_mean[..., :3] + cell_center,
                            point_mean[..., 3:]], dim=-1)

    # the scatter tail: per-pillar tables, one spare column taking the
    # clamped id P (dropped, as the JAX package's mode="drop" drops it)
    pp = point_pillar

    def per_pillar(width, dtype, values, reduce):
        out = torch.zeros((b, P + 1, width), dtype=dtype, device=dev)
        out.scatter_reduce_(1, pp[..., None].expand(-1, -1, width), values,
                            reduce)
        return out[:, :P]

    head = is_start & valid_s
    num_points = per_pillar(1, torch.int32, keep[..., None].to(torch.int32),
                            "sum")[..., 0]
    coords = per_pillar(3, torch.int32, torch.where(
        valid_s[..., None], zyx, torch.zeros_like(zyx)), "amax")
    voxel_mean = per_pillar(dim, points.dtype, torch.where(
        head[..., None], point_mean, torch.zeros_like(point_mean)), "sum")
    return VoxelizedPoints(points_s, pp.to(torch.int32), keep, point_mean, zyx,
                           num_points, coords, num_points > 0, voxel_mean)


def make_point_voxelizer(cfg: VoxelConfig):
    """Bound point-major voxelizer, ``fn(points [B, M, D], num_valid [B])``.
    Raises ``NotImplementedError`` for a grid of more than max_voxels
    cells."""
    nx, ny, nz = cfg.grid_size
    if nx * ny * nz > cfg.max_voxels:
        raise NotImplementedError(
            f"the point-major voxelizer is ported for n_cells <= max_voxels "
            f"only ({nx * ny * nz} > {cfg.max_voxels})")
    return functools.partial(
        voxelize_points,
        voxel_size=np.asarray(cfg.voxel_size, np.float32),
        point_cloud_range=np.asarray(cfg.point_cloud_range, np.float32),
        grid_size=cfg.grid_size,
        max_points_per_voxel=cfg.max_points_per_voxel,
        max_voxels=cfg.max_voxels,
    )


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
