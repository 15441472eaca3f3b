"""Box geometry in torch for the postprocess (pillars_tpu/geometry/boxes.py).

Same formulas and corner order as the JAX package. Everything stays in f32;
the small matrix products are written out elementwise or run with TF32 off
(the JAX package uses Precision.HIGHEST here), so the card computes them in
full f32.

Box convention (lidar): [x, y, z, w, l, h, r] with z at the box BOTTOM and r
a clockwise-positive yaw around +z.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pillars_torch import device_constant

# unit-square corner layout, clockwise from the minimum point (the
# reference's corners_nd reordering [0, 1, 3, 2])
_CORNERS_NORM_2D = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0))
_CORNERS_NORM_3D = ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 1.0),
                    (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (1.0, 0.0, 1.0),
                    (1.0, 1.0, 1.0), (1.0, 1.0, 0.0))


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angles into [-offset*period, (1-offset)*period).

    Float32 angles wrap as XLA compiles the JAX package's formula on the
    CPU: the division by the constant period becomes a product with its
    float32 reciprocal, and ``val * inv + offset`` and ``val - n * period``
    each one fused multiply-add. Float64 holds both exactly before the one
    rounding to float32, so the wrap falls where the jitted JAX package's
    does, also at the odd multiples of half the period, and the wrapped
    angle has its bits."""
    if val.dtype == torch.float64:
        return val - torch.floor(val / period + offset) * period
    p32 = float(np.float32(period))
    inv = float(np.float32(1) / np.float32(period))
    v = val.double()
    n = torch.floor((v * inv + offset).to(val.dtype))
    return (v - n.double() * p32).to(val.dtype)


def corners_nd(dims: torch.Tensor, origin=0.5) -> torch.Tensor:
    """[N, ndim] dims -> [N, 2**ndim, ndim] corners relative to the center."""
    ndim = dims.shape[-1]
    norm = device_constant(
        _CORNERS_NORM_2D if ndim == 2 else _CORNERS_NORM_3D, dims.dtype,
        dims.device)
    norm = norm - device_constant(origin, dims.dtype, dims.device)
    return dims[..., None, :] * norm[None]


def rotation_2d(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate [N, P, 2] point sets clockwise-positive by [N] angles:
    out[a, i, k] = sum_j points[a, i, j] * rot[a, j, k] with rows
    (cos, -sin) and (sin, cos)."""
    s = torch.sin(angles)[:, None]
    c = torch.cos(angles)[:, None]
    px, py = points[..., 0], points[..., 1]
    return torch.stack([px * c + py * s, px * -s + py * c], dim=-1)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """[N,2] centers + [N,2] dims (+[N] yaw) -> [N,4,2] BEV corners."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers[..., None, :]


def corner_to_standup(boxes_corner: torch.Tensor) -> torch.Tensor:
    """[N, K, ndim] corners -> [N, 2*ndim] (mins..., maxs...)."""
    return torch.cat([boxes_corner.amin(dim=-2), boxes_corner.amax(dim=-2)],
                     dim=-1)


def center_to_minmax_2d(centers, dims):
    """Axis-aligned [xmin, ymin, xmax, ymax] from center/dims."""
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def rbbox2d_to_near_bbox(rbboxes: torch.Tensor) -> torch.Tensor:
    """Rotated [N,5] (x, y, w, l, r) -> nearest axis-aligned [N,4] standup
    box: w and l swap where |r| (wrapped into [-pi/2, pi/2)) > pi/4."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = torch.abs(limit_period(rots, 0.5, math.pi))
    cond = (rots_0_pi_div_2 > math.pi / 4)[..., None]
    # (x, y, l, w) by slices: a list index is a tensor made on the host
    swapped = torch.cat([rbboxes[..., 0:2], rbboxes[..., 3:4],
                         rbboxes[..., 2:3]], dim=-1)
    bboxes_center = torch.where(cond, swapped, rbboxes[..., :4])
    return center_to_minmax_2d(bboxes_center[..., :2], bboxes_center[..., 2:4])


def iou_matrix(boxes: torch.Tensor, query_boxes: torch.Tensor,
               eps: float = 0.0) -> torch.Tensor:
    """Pairwise axis-aligned IoU of [N,4] x [K,4] minmax boxes -> [N,K], in
    the JAX package's operation order (ties between overlaps must repeat)."""
    n_area = (boxes[:, 2] - boxes[:, 0] + eps) * (boxes[:, 3] - boxes[:, 1]
                                                  + eps)
    k_area = (query_boxes[:, 2] - query_boxes[:, 0] + eps) * (
        query_boxes[:, 3] - query_boxes[:, 1] + eps)
    iw = (torch.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - torch.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps)
    ih = (torch.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - torch.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps)
    iw = torch.clamp(iw, min=0.0)
    ih = torch.clamp(ih, min=0.0)
    inter = iw * ih
    union = n_area[:, None] + k_area[None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def second_box_encode(boxes: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """SECOND residual encoding of [..., 7] boxes against [..., 7] anchors
    (z at the box bottom); the inverse of :func:`second_box_decode`."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = boxes.split(1, dim=-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    return torch.cat([(xg - xa) / diagonal, (yg - ya) / diagonal,
                      (zg - za) / ha, torch.log(wg / wa), torch.log(lg / la),
                      torch.log(hg / ha), rg - ra], dim=-1)


def add_sin_difference(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """sin(a - b) angle-difference trick of the localization loss: the last
    field becomes sin(a)cos(b) in ``boxes1`` and cos(a)sin(b) in
    ``boxes2``."""
    rad_pred = torch.sin(boxes1[..., -1:]) * torch.cos(boxes2[..., -1:])
    rad_tg = torch.cos(boxes1[..., -1:]) * torch.sin(boxes2[..., -1:])
    return (torch.cat([boxes1[..., :-1], rad_pred], dim=-1),
            torch.cat([boxes2[..., :-1], rad_tg], dim=-1))


def second_box_decode(box_encodings: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """SECOND residual decode of [..., 7] encodings against [..., 7] anchors
    (z at the box bottom)."""
    xa, ya, za, wa, la, ha, ra = anchors.split(1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = box_encodings.split(1, dim=-1)
    za = za + ha / 2
    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    lg = torch.exp(lt) * la
    wg = torch.exp(wt) * wa
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)


def lidar_to_camera(points, r_rect, velo2cam):
    """[..., N, 3] lidar points -> camera, with [..., 4, 4] matrices."""
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    pts = torch.cat([points, ones], dim=-1)
    cam = pts @ (r_rect @ velo2cam).transpose(-1, -2)
    return cam[..., :3]


def box_lidar_to_camera(boxes, r_rect, velo2cam):
    """[..., N, 7] lidar (x,y,z,w,l,h,r) -> camera (x,y,z,l,h,w,r)."""
    xyz = lidar_to_camera(boxes[..., :3], r_rect, velo2cam)
    w, l, h = boxes[..., 3:4], boxes[..., 4:5], boxes[..., 5:6]
    r = boxes[..., 6:7]
    return torch.cat([xyz, l, h, w, r], dim=-1)
