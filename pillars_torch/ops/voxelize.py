"""Voxelization (pillars_tpu/ops/voxelize.py): the dense-cell layout
(``voxelize_cells``), the point-major pillar layout (``voxelize_points``)
and the dense [P, N, D] layout (``voxelize``), plus ``voxelize_np``, the
NumPy loop of the reference's kernel that the tests hold them against.

Dense cell: the pillar index space is the cell grid itself, usable whenever
the grid has no more cells than ``max_voxels`` (the d435i config: 80*64*2 =
10240 cells < 12000), so the reference's pillar compaction is the identity.
Point-major: pillars are numbered in ascending cell order, and per-pillar
tables ([P] counts, coords, means) are scattered from the sorted points. A
grid with more cells than ``max_voxels`` keeps the first ``max_voxels``
pillars in ARRIVAL order and drops every point from the overflow on.

Both stably sort points by cell; each cell keeps its first
``max_points_per_voxel`` points in input order (reference
load_data.py:593-692).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pillars_torch import device_constant
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
    over the segment id) for any batch size, in fixed point relative to the
    cell centre as :func:`voxelize_points` takes it, so that a cloud gives
    the same bits in every run on the card."""
    b, maxpts, dim = points.shape
    dev = points.device
    vs = device_constant(voxel_size, points.dtype, dev)
    pcr = device_constant(point_cloud_range, points.dtype, dev)
    nx, ny, nz = (int(g) for g in grid_size)
    n_cells = nx * ny * nz
    N = int(max_points_per_voxel)

    idx = torch.arange(maxpts, dtype=torch.int64, device=dev)[None]  # [1, M]
    in_count = idx < num_valid.to(dev)[:, None]
    c = torch.floor((points[..., :3] - pcr[:3]) / vs).to(torch.int32)
    gs = device_constant([nx, ny, nz], torch.int32, dev)
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

    # per-cell xyz mean over kept points: one sum per segment of the points
    # relative to their cell centre, in the fixed point of voxelize_points
    # (the same bits whatever order the card's atomics land in), gathered
    # back and recentred
    seg_id = (torch.cumsum(is_start.to(torch.int64), dim=1) - 1
              + torch.arange(b, device=dev)[:, None] * maxpts).reshape(-1)
    z = torch.div(cell_s, ny * nx, rounding_mode="floor")
    rem = cell_s - z * (ny * nx)
    y = torch.div(rem, nx, rounding_mode="floor")
    cell_center = (torch.stack([rem - y * nx, y, z], dim=-1).to(points.dtype)
                   + 0.5) * vs[:3] + pcr[:3]
    centered = points_s[..., :3] - cell_center
    vals = torch.where(kept[..., None], centered, torch.zeros_like(centered))
    denom = torch.clamp_min(count, 1).to(points.dtype)[..., None]
    total = _segment_sums(vals.reshape(-1, 3), seg_id, N).reshape(
        b, maxpts, 3)
    mean = total / denom + cell_center

    num_pillars = (is_start & valid_s).sum().to(torch.int32)
    return CellVoxelized(points_s, cell_s.to(torch.int32), kept, count, mean,
                         num_pillars)


class _Sorted(NamedTuple):
    """The points of a batch sorted by cell and cut into pillars: what the
    point-major and the dense layouts share (every array [B, MAXPTS, ...])."""

    idx: torch.Tensor        # [1, MAXPTS] sorted position
    order: torch.Tensor      # input position of each sorted point
    points: torch.Tensor     # [B, MAXPTS, D] sorted points
    cell: torch.Tensor       # sorted cell id; sentinel n_cells when invalid
    zyx: torch.Tensor        # [B, MAXPTS, 3] cell (z, y, x), int64
    valid: torch.Tensor      # in range and inside num_valid
    is_start: torch.Tensor   # first point of its cell's segment
    seg_id: torch.Tensor     # segment number (the sentinel one included)
    rank: torch.Tensor       # position inside the segment
    seg_keep: torch.Tensor   # the segment's pillar survives the cap
    pillar_id: torch.Tensor  # pillar number, in cell order, clamped to P
    keep: torch.Tensor       # the point enters its pillar


def _sort_into_pillars(points, num_valid, voxel_size, point_cloud_range,
                       grid_size, max_points_per_voxel: int,
                       max_voxels: int) -> _Sorted:
    """Cell ids, one stable sort by cell (the key ``cell * MAXPTS + index``
    is unique and int64 for every grid size), segments, and on a grid with
    more cells than ``max_voxels`` the reference's pillar cap.

    The reference breaks out of its point loop when a point would open
    pillar P+1 (load_data.py:630-637): the first P pillars in arrival order
    survive, and every point at or after the overflow position is dropped,
    also points of pillars that survive. Two order statistics of the
    segment heads' input positions give that: ``thr``, the P-th smallest (a
    pillar survives iff its head is at or before it), and ``cutoff``, the
    (P+1)-th (the overflow point). The surviving pillars are renumbered in
    cell order, so the ids stay non-decreasing over the sorted points."""
    b, maxpts, dim = points.shape
    dev = points.device
    vs = device_constant(voxel_size, points.dtype, dev)
    pcr = device_constant(point_cloud_range, points.dtype, dev)
    nx, ny, nz = (int(g) for g in grid_size)
    n_cells = nx * ny * nz
    P = int(max_voxels)

    idx = torch.arange(maxpts, dtype=torch.int64, device=dev)[None]  # [1, M]
    in_count = idx < num_valid.to(dev)[:, None]
    c = torch.floor((points[..., :3] - pcr[:3]) / vs).to(torch.int32)
    gs = device_constant([nx, ny, nz], torch.int32, dev)
    valid = in_count & ((c >= 0) & (c < gs)).all(dim=-1)
    cell = (c[..., 2] * ny + c[..., 1]) * nx + c[..., 0]
    cell = torch.where(valid, cell, torch.full_like(cell, n_cells))

    # the sorted permutation is each point's input position
    key_s, order = torch.sort(cell.to(torch.int64) * maxpts + idx, dim=1)
    points_s = torch.gather(points, 1, order[..., None].expand(-1, -1, dim))
    cell_s = key_s // maxpts
    valid_s = cell_s < n_cells

    prev = torch.cat([torch.full((b, 1), -1, dtype=cell_s.dtype, device=dev),
                      cell_s[:, :-1]], dim=1)
    is_start = cell_s != prev
    seg_id = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=1).values
    if n_cells > P:
        first_pos = torch.gather(order, 1, seg_start)  # the head's position
        heads_sorted = torch.sort(torch.where(
            is_start & valid_s, first_pos, torch.full_like(first_pos, maxpts)),
            dim=1).values
        # with fewer than P occupied cells both read the filler maxpts
        full = torch.full((b, 1), maxpts, dtype=torch.int64, device=dev)
        thr = heads_sorted[:, P - 1:P] if P <= maxpts else full
        cutoff = heads_sorted[:, P:P + 1] if P < maxpts else full
        survives = first_pos <= thr
        seg_keep = survives & (order < cutoff)
        pillar_id = torch.clamp(
            torch.cumsum((is_start & survives).to(torch.int64), dim=1) - 1,
            0, P)
    else:
        seg_keep = torch.ones_like(valid_s)
        pillar_id = seg_id
    rank = idx - seg_start
    keep = (valid_s & (rank < int(max_points_per_voxel)) & seg_keep
            & (pillar_id < P))

    z = torch.div(cell_s, ny * nx, rounding_mode="floor")
    rem = cell_s - z * (ny * nx)
    y = torch.div(rem, nx, rounding_mode="floor")
    zyx = torch.stack([z, y, rem - y * nx], dim=-1)
    return _Sorted(idx, order, points_s, cell_s, zyx, valid_s, is_start,
                   seg_id, rank, seg_keep, pillar_id, keep)


class VoxelizedSample(NamedTuple):
    """Dense-layout voxelization of a BATCH (every array has a leading B).

    voxels:      [B, P, N, D] points gathered per pillar (zero padded)
    num_points:  [B, P] int32, points per pillar (capped at N)
    coords:      [B, P, 3] int32 (z, y, x); zeros for padding pillars
    pillar_mask: [B, P] bool
    """

    voxels: torch.Tensor
    num_points: torch.Tensor
    coords: torch.Tensor
    pillar_mask: torch.Tensor


def voxelize(points: torch.Tensor, num_valid: torch.Tensor, *,
             voxel_size, point_cloud_range, grid_size,
             max_points_per_voxel: int, max_voxels: int) -> VoxelizedSample:
    """points [B, MAXPTS, D], num_valid [B] -> :class:`VoxelizedSample`,
    each sample as pillars_tpu's ``voxelize`` gives it: pillars in ascending
    cell order, each keeping its first N points in input order at slots
    0..N-1; on a grid with more cells than ``max_voxels`` the pillar cap and
    the overflow cutoff of :func:`voxelize_points`."""
    b, _, dim = points.shape
    dev = points.device
    P = int(max_voxels)
    N = int(max_points_per_voxel)
    srt = _sort_into_pillars(points, num_valid, voxel_size, point_cloud_range,
                             grid_size, N, P)
    keep, pillar_id = srt.keep, srt.pillar_id

    # one spare pillar row and one spare slot take every dropped point
    sample = torch.arange(b, device=dev)[:, None]
    pid = torch.where(keep, pillar_id, torch.full_like(pillar_id, P))
    slot = torch.where(keep, srt.rank, torch.full_like(srt.rank, N))
    voxels = points.new_zeros((b, P + 1, N + 1, dim))
    voxels[sample, pid, slot] = srt.points
    num_points = torch.zeros((b, P + 1), dtype=torch.int32, device=dev)
    num_points.scatter_add_(1, pid, keep.to(torch.int32))

    head = srt.is_start & srt.valid & srt.seg_keep & (pillar_id < P)
    coords = torch.zeros((b, P + 1, 3), dtype=torch.int32, device=dev)
    coords[sample, torch.where(head, pillar_id, torch.full_like(
        pillar_id, P))] = srt.zyx.to(torch.int32)
    num_points = num_points[:, :P]
    return VoxelizedSample(voxels[:, :P, :N], num_points, coords[:, :P],
                           num_points > 0)


# the finest fixed-point unit of the per-pillar sums: 2^-40
_FIXED_BITS = 40


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

    A grid with more cells than ``max_voxels`` can fill more pillars than
    fit: the reference's pillar cap (:func:`_sort_into_pillars`).

    The sort key is int64, so one sort serves every grid size (the JAX
    package needs a second int32 key from 2^31 on). The per-pillar tables
    come from the scatter tail in both regimes: it is the JAX package's
    second tail, whose outputs equal its compaction sort's, and one
    ``scatter_reduce_`` per table is cheaper here than another sort.

    Per-pillar means sum each point relative to its cell centre (the same
    for every point of a pillar) and add the centre back, as the JAX
    package does, so the rounding stays at the scale of a cell. The sums
    are taken in fixed point (:func:`_segment_sums`): the same cloud gives
    the same bits in every run and at every padded width, values of any
    finite size give the JAX package's means, and a NaN or infinite value
    makes its pillar's mean NaN or infinite, as the JAX package's float
    sums do."""
    b, maxpts, dim = points.shape
    dev = points.device
    vs = device_constant(voxel_size, points.dtype, dev)
    pcr = device_constant(point_cloud_range, points.dtype, dev)
    P = int(max_voxels)
    N = int(max_points_per_voxel)
    srt = _sort_into_pillars(points, num_valid, voxel_size, point_cloud_range,
                             grid_size, N, P)
    points_s, keep, seg_id = srt.points, srt.keep, srt.seg_id
    point_pillar = torch.clamp_max(srt.pillar_id, P)
    z, y, x = srt.zyx.unbind(-1)
    zyx = srt.zyx.to(torch.int32)

    # per-segment sums of kept points relative to the cell centre, plus a
    # kept-count column (the mean's denominator leaves out capped and
    # cut-off points); one sum per segment (the sentinel segment of invalid
    # points and every dropped pillar is a segment of its own), gathered
    # back per point
    cell_center = (torch.stack([x, y, z], dim=-1).to(points.dtype) + 0.5
                   ) * vs[:3] + pcr[:3]
    centered = torch.cat([points_s[..., :3] - cell_center, points_s[..., 3:],
                          torch.ones_like(points_s[..., :1])], dim=-1)
    vals = torch.where(keep[..., None], centered, torch.zeros_like(centered))
    seg = (seg_id + torch.arange(b, device=dev)[:, None] * maxpts
           ).reshape(-1)
    total = _segment_sums(vals.reshape(-1, dim + 1), seg, N).reshape(
        b, maxpts, dim + 1)
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

    live = srt.valid & srt.seg_keep
    head = srt.is_start & live
    num_points = per_pillar(1, torch.int32, keep[..., None].to(torch.int32),
                            "sum")[..., 0]
    # points of a dropped pillar carry the id of the pillar before it and
    # must not reach its coords
    coords = per_pillar(3, torch.int32, torch.where(
        live[..., None], zyx, torch.zeros_like(zyx)), "amax")
    voxel_mean = per_pillar(dim, points.dtype, torch.where(
        head[..., None], point_mean, torch.zeros_like(point_mean)), "sum")
    return VoxelizedPoints(points_s, pp.to(torch.int32), keep, point_mean, zyx,
                           num_points, coords, num_points > 0, voxel_mean)


def _segment_sums(vals: torch.Tensor, seg: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """``vals`` [R, C] (f32) summed per segment ``seg`` [R] (each segment
    holds at most ``n`` nonzero rows) and gathered back per row: [R, C].

    Each column sums in fixed point, as int64 multiples of 2^-k: integer
    addition does not depend on the order in which the card's atomics land,
    so a cloud gives the same bits in every run and at every padded width.
    k is chosen per column on the device from the batch's largest finite
    |value| m: the largest k <= 40 with m * n * 2^k < 2^63, so no sum can
    wrap (k is 40, the scale of every earlier release, while m * n < 2^23).
    Scaling by a power of two is exact in f32, and the conversion truncates
    what lies below one unit the same way for a value wherever it stands.
    A non-finite value enters a float sum of the non-finite values alone,
    whose NaN or infinity then stands for its segment's sum, as a float sum
    of all the values would give it."""
    finite = torch.isfinite(vals)
    clean = torch.where(finite, vals, 0.0)
    m = clean.abs().amax(dim=0).double() * n  # exact: 24 + 63 bits
    k = torch.clamp_max(63 - torch.frexp(m).exponent, _FIXED_BITS)
    scale = _pow2(k)
    sums = torch.zeros(vals.shape, dtype=torch.int64, device=vals.device)
    sums.index_add_(0, seg, (clean * scale).to(torch.int64))
    special = torch.zeros_like(vals)
    special.index_add_(0, seg, torch.where(finite, 0.0, vals))
    # + 0.0 leaves a finite total's bits (never -0.0) as they are
    return sums[seg].to(vals.dtype) * torch.reciprocal(scale) + special[seg]


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k in f32 for int32 ``k`` in [-126, 127], built from its exponent
    bits (exact, and the same on every device)."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def make_point_voxelizer(cfg: VoxelConfig):
    """Bound point-major voxelizer, ``fn(points [B, M, D], num_valid [B])``
    (:func:`voxelize_points`)."""
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


def make_voxelizer(cfg: VoxelConfig):
    """Bound dense-layout voxelizer, ``fn(points [B, M, D], num_valid [B])``
    -> :class:`VoxelizedSample`."""
    return functools.partial(
        voxelize,
        voxel_size=np.asarray(cfg.voxel_size, np.float32),
        point_cloud_range=np.asarray(cfg.point_cloud_range, np.float32),
        grid_size=cfg.grid_size,
        max_points_per_voxel=cfg.max_points_per_voxel,
        max_voxels=cfg.max_voxels,
    )


def voxelize_np(points: np.ndarray, voxel_size, point_cloud_range,
                max_points_per_voxel: int, max_voxels: int):
    """One cloud [M, D] through the reference's sequential kernel
    (load_data.py:593-692, reverse_index=True), pillars in ARRIVAL order:
    (voxels [V, N, D], coords [V, 3] (z, y, x), num_points [V]). A copy of
    pillars_tpu's NumPy twin, the parity oracle of the tests."""
    vs = np.asarray(voxel_size, dtype=points.dtype)
    pcr = np.asarray(point_cloud_range, dtype=points.dtype)
    grid = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int32)
    nx, ny, nz = int(grid[0]), int(grid[1]), int(grid[2])
    coor_to_voxelidx = -np.ones((nz, ny, nx), dtype=np.int32)
    voxels = np.zeros((max_voxels, max_points_per_voxel, points.shape[-1]),
                      dtype=points.dtype)
    coors = np.zeros((max_voxels, 3), dtype=np.int32)
    num_points = np.zeros((max_voxels,), dtype=np.int32)
    voxel_num = 0
    for i in range(points.shape[0]):
        coor = np.zeros(3, dtype=np.int32)
        failed = False
        for j in range(3):
            cj = int(np.floor((points[i, j] - pcr[j]) / vs[j]))
            if cj < 0 or cj >= grid[j]:
                failed = True
                break
            coor[2 - j] = cj
        if failed:
            continue
        voxelidx = coor_to_voxelidx[coor[0], coor[1], coor[2]]
        if voxelidx == -1:
            voxelidx = voxel_num
            if voxel_num >= max_voxels:
                break
            voxel_num += 1
            coor_to_voxelidx[coor[0], coor[1], coor[2]] = voxelidx
            coors[voxelidx] = coor
        num = num_points[voxelidx]
        if num < max_points_per_voxel:
            voxels[voxelidx, num] = points[i]
            num_points[voxelidx] += 1
    return voxels[:voxel_num], coors[:voxel_num], num_points[:voxel_num]
