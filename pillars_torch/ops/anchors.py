"""Static anchor tables (NumPy) and the summed-area-table anchors mask
(torch). A copy of pillars_tpu/ops/anchors.py's table builders, and a torch
port of its ``anchors_mask_from_dense`` and of the coords-based
``anchors_mask`` / ``anchors_mask_batched`` of the point-major path.

The tables depend only on the config, so they are built once at set-up. The
mask prunes anchors over empty BEV regions: two cumulative sums (the SAT),
then four lookups per anchor at precomputed integer corners.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pillars_torch.config import ModelConfig
from pillars_torch.geometry import np_boxes as nb


class StructuredSAT(NamedTuple):
    """Separable SAT corners: the x-corner of anchor type t at feature-map
    location (i, j) depends only on (j, t) and the y-corner only on (i, t),
    so the per-anchor lookups become a row-take and a column-take per type."""

    x0: np.ndarray  # [nx_f, T] int32, clipped (same values as sat_corners)
    y0: np.ndarray  # [ny_f, T]
    x1: np.ndarray  # [nx_f, T]
    y1: np.ndarray  # [ny_f, T]


class AnchorSet(NamedTuple):
    """Static per-config anchor data (host NumPy)."""

    anchors: np.ndarray            # [A, 7] (x, y, z, w, l, h, r)
    matched_thresholds: np.ndarray  # [A]
    unmatched_thresholds: np.ndarray  # [A]
    sat_corners: np.ndarray        # [A, 4] int32 (x0, y0, x1, y1) clipped
    standup_bv: np.ndarray         # [A, 4] nearest-axis-aligned BEV boxes
    sat_structured: Optional[StructuredSAT] = None


def create_anchors_3d_stride(feature_size, sizes, strides, offsets, rotations,
                             dtype=np.float32) -> np.ndarray:
    """Dense stride-based anchors, [*feature_size, num_size, num_rot, 7],
    ordered y-major over the feature map, then x, size, rotation
    (reference load_data.py:1598-1638)."""
    strides = list(strides)
    offsets = list(offsets)
    x_stride, y_stride, z_stride = strides
    x_offset, y_offset, z_offset = offsets
    z_centers = np.arange(feature_size[0], dtype=dtype) * z_stride + z_offset
    y_centers = np.arange(feature_size[1], dtype=dtype) * y_stride + y_offset
    x_centers = np.arange(feature_size[2], dtype=dtype) * x_stride + x_offset
    sizes = np.reshape(np.array(sizes, dtype=dtype), [-1, 3])
    rotations = np.array(rotations, dtype=dtype)
    rets = list(np.meshgrid(x_centers, y_centers, z_centers, rotations,
                            indexing="ij"))
    tile_shape = [1] * 5
    tile_shape[-2] = int(sizes.shape[0])
    for i in range(len(rets)):
        rets[i] = np.tile(rets[i][..., np.newaxis, :], tile_shape)
        rets[i] = rets[i][..., np.newaxis]
    sizes = np.reshape(sizes, [1, 1, 1, -1, 1, 3])
    tile_size_shape = list(rets[0].shape)
    tile_size_shape[3] = 1
    sizes = np.tile(sizes, tile_size_shape)
    rets.insert(3, sizes)
    ret = np.concatenate(rets, axis=-1)
    return np.transpose(ret, [2, 1, 0, 3, 4, 5])


def build_anchors(cfg: ModelConfig) -> AnchorSet:
    """All static anchor data for a model config (reference
    load_data.py:1641-1685 and the static halves of :3040-3072). Several
    generators interleave per location, matching the head-channel reshape."""
    feature_map_size = list(cfg.feature_map_size)  # [1, ny, nx]
    anchors_list, match_list, unmatch_list = [], [], []
    for g in cfg.target.generators:
        a = create_anchors_3d_stride(
            feature_map_size, g.sizes, g.strides, g.offsets, g.rotations)
        a = a.reshape([*a.shape[:3], -1, 7])  # [ny, nx, 1?, per_loc, 7]
        anchors_list.append(a)
        n = int(np.prod(a.shape[:-1]))
        match_list.append(np.full([n], g.matched_threshold, np.float32))
        unmatch_list.append(np.full([n], g.unmatched_threshold, np.float32))
    anchors = np.concatenate(anchors_list, axis=-2)
    anchors = anchors.reshape([-1, 7]).astype(np.float32)
    num = anchors.shape[0]
    if len(anchors_list) == 1:
        matched = match_list[0]
        unmatched = unmatch_list[0]
    else:
        # re-interleave thresholds to match the per-location anchor order
        per_loc = [a.shape[-2] for a in anchors_list]
        n_loc = num // sum(per_loc)
        matched = np.concatenate(
            [m.reshape(n_loc, p) for m, p in zip(match_list, per_loc)],
            axis=1).reshape(-1).astype(np.float32)
        unmatched = np.concatenate(
            [m.reshape(n_loc, p) for m, p in zip(unmatch_list, per_loc)],
            axis=1).reshape(-1).astype(np.float32)

    standup_bv = nb.rbbox2d_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])

    # integer SAT lookup corners: floor((bv - offset)/stride), clipped
    voxel_size = np.asarray(cfg.voxel.voxel_size, np.float32)
    pcr = np.asarray(cfg.voxel.point_cloud_range, np.float32)
    grid = np.asarray(cfg.voxel.grid_size, np.int64)
    coor = np.zeros((num, 4), dtype=np.int32)
    coor[:, 0] = np.floor((standup_bv[:, 0] - pcr[0]) / voxel_size[0])
    coor[:, 1] = np.floor((standup_bv[:, 1] - pcr[1]) / voxel_size[1])
    coor[:, 2] = np.floor((standup_bv[:, 2] - pcr[0]) / voxel_size[0])
    coor[:, 3] = np.floor((standup_bv[:, 3] - pcr[1]) / voxel_size[1])
    coor[:, 0] = np.clip(coor[:, 0], 0, None)
    coor[:, 1] = np.clip(coor[:, 1], 0, None)
    coor[:, 2] = np.clip(coor[:, 2], None, grid[0] - 1)
    coor[:, 3] = np.clip(coor[:, 3], None, grid[1] - 1)

    # the separable structure holds for every stride-based generator; it is
    # verified against the generic corners, so a generator that breaks it
    # takes the gather form
    structured = None
    ny_f, nx_f = int(feature_map_size[1]), int(feature_map_size[2])
    if num % (ny_f * nx_f) == 0:
        T = num // (ny_f * nx_f)
        cc = coor.reshape(ny_f, nx_f, T, 4)
        x_ok = (np.array_equal(cc[..., 0], np.broadcast_to(cc[:1, :, :, 0], cc.shape[:3]))
                and np.array_equal(cc[..., 2], np.broadcast_to(cc[:1, :, :, 2], cc.shape[:3])))
        y_ok = (np.array_equal(cc[..., 1], np.broadcast_to(cc[:, :1, :, 1], cc.shape[:3]))
                and np.array_equal(cc[..., 3], np.broadcast_to(cc[:, :1, :, 3], cc.shape[:3])))
        if x_ok and y_ok:
            structured = StructuredSAT(
                x0=cc[0, :, :, 0].astype(np.int32),
                y0=cc[:, 0, :, 1].astype(np.int32),
                x1=cc[0, :, :, 2].astype(np.int32),
                y1=cc[:, 0, :, 3].astype(np.int32))
    return AnchorSet(anchors, matched, unmatched, coor, standup_bv,
                     structured)


def clamp_sat_tables(anchor_set: AnchorSet, ny: int, nx: int, device):
    """(corners [A, 4], StructuredSAT or None) as long tensors on ``device``,
    clamped to a [ny, nx] SAT as a JAX gather clamps them. The corners are
    in voxel-grid units, which exceed the feature map where a middle
    extractor strides y/x (SECOND's sparse middle); clamping once here
    keeps the clamps out of every call."""
    def table(a, n):
        return torch.as_tensor(np.clip(a, 0, n - 1), dtype=torch.long,
                               device=device)

    c = anchor_set.sat_corners
    corners = torch.stack([table(c[:, i], ny if i % 2 else nx)
                           for i in range(4)], -1)
    s = anchor_set.sat_structured
    structured = None if s is None else StructuredSAT(
        table(s.x0, nx), table(s.y0, ny), table(s.x1, nx), table(s.y1, ny))
    return corners, structured


def anchors_mask_from_dense(dense: torch.Tensor, sat_corners,
                            area_threshold: float,
                            structured: Optional[StructuredSAT] = None
                            ) -> torch.Tensor:
    """[B, ny, nx] per-location pillar count -> [B, A] bool anchor mask.

    The corner tables may be NumPy (clamped to the SAT here, as a JAX
    gather clamps) or long tensors on ``dense``'s device, clamped already
    (:func:`clamp_sat_tables`; the detector uploads them once). With ``structured`` the four lookups
    per anchor are row/column takes of the SAT per anchor type; otherwise
    four gathers at ``sat_corners`` ([A, 4] (x0, y0, x1, y1))."""
    sat = torch.cumsum(torch.cumsum(dense, dim=1), dim=2)
    b, ny, nx = dense.shape
    dev = dense.device

    def as_idx(a, n):
        """NumPy tables, clamped here; index tensors already on the device
        must be clamped already (:func:`clamp_sat_tables`)."""
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.clip(a, 0, n - 1), dtype=torch.long,
                               device=dev)

    if structured is not None:
        s = structured
        T = s.x0.shape[1]

        def lut(yv, xv):  # [ny_f] rows, [nx_f] cols -> [B, ny_f, nx_f]
            return sat[:, as_idx(yv, ny)][:, :, as_idx(xv, nx)]

        areas = []
        for t in range(T):
            ID = lut(s.y1[:, t], s.x1[:, t])
            IA = lut(s.y0[:, t], s.x0[:, t])
            IB = lut(s.y1[:, t], s.x0[:, t])
            IC = lut(s.y0[:, t], s.x1[:, t])
            areas.append(ID - IB - IC + IA)
        area = torch.stack(areas, dim=-1)  # [B, ny_f, nx_f, T] = anchor order
        return (area > area_threshold).reshape(b, -1)

    x0, y0, x1, y1 = (as_idx(sat_corners[:, i], ny if i % 2 else nx)
                      for i in range(4))
    ID = sat[:, y1, x1]
    IA = sat[:, y0, x0]
    IB = sat[:, y1, x0]
    IC = sat[:, y0, x1]
    area = ID - IB - IC + IA
    return area > area_threshold


def anchors_mask_batched(coords: torch.Tensor, pillar_mask: torch.Tensor,
                         sat_corners, ny: int, nx: int, area_threshold: float,
                         structured: Optional[StructuredSAT] = None,
                         coord_stride: int = 1) -> torch.Tensor:
    """[B, P, 3] (z, y, x) pillar coords + [B, P] mask -> [B, A] bool anchor
    mask (reference load_data.py:3050-3072): the per-(y, x) pillar count,
    summed over z-layers, through :func:`anchors_mask_from_dense`.
    ``coord_stride`` downscales voxel-grid coords onto the anchor feature
    map where the two differ."""
    b = coords.shape[0]
    y = torch.div(coords[..., 1], coord_stride, rounding_mode="floor").long()
    x = torch.div(coords[..., 2], coord_stride, rounding_mode="floor").long()
    flat = torch.where(pillar_mask, y * nx + x, torch.full_like(y, ny * nx))
    dense = torch.zeros((b, ny * nx + 1), dtype=torch.float32,
                        device=coords.device)
    dense.scatter_add_(1, flat, pillar_mask.to(torch.float32))
    return anchors_mask_from_dense(dense[:, :ny * nx].reshape(b, ny, nx),
                                   sat_corners, area_threshold, structured)


def anchors_mask(coords: torch.Tensor, pillar_mask: torch.Tensor, sat_corners,
                 ny: int, nx: int, area_threshold: float,
                 structured: Optional[StructuredSAT] = None,
                 coord_stride: int = 1) -> torch.Tensor:
    """[P, 3] pillar coords + [P] mask -> [A] bool anchor mask."""
    return anchors_mask_batched(coords[None], pillar_mask[None], sat_corners,
                                ny, nx, area_threshold, structured,
                                coord_stride)[0]
