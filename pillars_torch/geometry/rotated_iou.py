"""Exact rotated-rectangle IoU via convex polygon clipping.

Re-implements the algorithm of the reference numba-CUDA kernel
(reference second/core/non_max_suppression/nms_gpu.py:180-415:
rbbox_to_corners -> quadrilateral_intersection -> vertex sort -> shoelace)
as a fully vectorized, branchless computation on the host (NumPy): the copy
of the NumPy half of pillars_tpu/geometry/rotated_iou.py that the evaluator
needs. The array namespace stays a parameter, as there.

Box format here matches the reference kernel: [cx, cy, x_d, y_d, angle],
with the reference's CLOCKWISE corner rotation (nms_gpu.py:371-394).

criterion: -1 -> IoU, 0 -> inter/area1, 1 -> inter/area2, 2 -> raw
intersection area (used by d3_box_overlap, reference eval.py:159-163).
"""

from __future__ import annotations

import numpy as np

_MAX_CANDIDATES = 24  # 8 contained corners + 16 edge intersections


def _rbbox_to_corners(xp, rbbox):
    """[..., 5] -> [..., 4, 2] clockwise corners (reference nms_gpu.py:371-394)."""
    angle = rbbox[..., 4]
    a_cos = xp.cos(angle)
    a_sin = xp.sin(angle)
    cx = rbbox[..., 0]
    cy = rbbox[..., 1]
    x_d = rbbox[..., 2]
    y_d = rbbox[..., 3]
    # corner template: (-x/2,-y/2), (-x/2,y/2), (x/2,y/2), (x/2,-y/2)
    sx = xp.stack([-x_d, -x_d, x_d, x_d], axis=-1) * 0.5
    sy = xp.stack([-y_d, y_d, y_d, -y_d], axis=-1) * 0.5
    px = a_cos[..., None] * sx + a_sin[..., None] * sy + cx[..., None]
    py = -a_sin[..., None] * sx + a_cos[..., None] * sy + cy[..., None]
    return xp.stack([px, py], axis=-1)


def _point_in_quad(xp, pts, corners):
    """pts [..., P, 2] inside quad corners [..., 4, 2] (inclusive boundaries).

    Projection test onto the AB / AD edges (reference nms_gpu.py:327-343)."""
    a = corners[..., 0, :]
    ab = corners[..., 1, :] - a
    ad = corners[..., 3, :] - a
    ap = pts - a[..., None, :]
    abab = xp.sum(ab * ab, axis=-1)[..., None]
    abap = xp.sum(ab[..., None, :] * ap, axis=-1)
    adad = xp.sum(ad * ad, axis=-1)[..., None]
    adap = xp.sum(ad[..., None, :] * ap, axis=-1)
    return (abab >= abap) & (abap >= 0) & (adad >= adap) & (adap >= 0)


def _edge_intersections(xp, c1, c2):
    """All 16 edge-pair intersection points of two quads.

    c1, c2: [..., 4, 2]. Returns pts [..., 16, 2], valid [..., 16].
    Strict orientation predicate, like reference nms_gpu.py:239-282."""
    a = c1                                   # [..., 4, 2]
    b = xp.roll(c1, -1, axis=-2)
    c = c2
    d = xp.roll(c2, -1, axis=-2)
    # broadcast edge i of quad1 against edge j of quad2
    A = a[..., :, None, :]
    B = b[..., :, None, :]
    C = c[..., None, :, :]
    D = d[..., None, :, :]

    def cross2(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    acd = cross2(D - A, C - A) > 0
    bcd = cross2(D - B, C - B) > 0
    abc = cross2(C - A, B - A) > 0
    abd = cross2(D - A, B - A) > 0
    valid = (acd != bcd) & (abc != abd)

    BA = B - A
    DC = D - C
    ABBA = A[..., 0] * B[..., 1] - B[..., 0] * A[..., 1]
    CDDC = C[..., 0] * D[..., 1] - D[..., 0] * C[..., 1]
    DH = BA[..., 1] * DC[..., 0] - BA[..., 0] * DC[..., 1]
    safe_dh = xp.where(xp.abs(DH) < 1e-12, 1.0, DH)
    ix = (ABBA * DC[..., 0] - BA[..., 0] * CDDC) / safe_dh
    iy = (ABBA * DC[..., 1] - BA[..., 1] * CDDC) / safe_dh
    pts = xp.stack([ix, iy], axis=-1)
    shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(shape), valid.reshape(shape[:-1])


def _intersection_area(xp, corners1, corners2):
    """Intersection area of two convex quads, batched over leading dims.

    Candidate vertices -> angular sort around their centroid -> shoelace
    (reference nms_gpu.py:186-236, 345-369)."""
    in2 = _point_in_quad(xp, corners1, corners2)  # corners1 inside quad2
    in1 = _point_in_quad(xp, corners2, corners1)
    epts, evalid = _edge_intersections(xp, corners1, corners2)

    pts = xp.concatenate([corners1, corners2, epts], axis=-2)   # [..., 24, 2]
    valid = xp.concatenate([in2, in1, evalid], axis=-1)          # [..., 24]

    count = xp.sum(valid, axis=-1)[..., None]                    # [..., 1]
    validf = valid.astype(pts.dtype)
    centroid = xp.sum(pts * validf[..., None], axis=-2) / xp.maximum(
        count.astype(pts.dtype), 1.0)
    rel = pts - centroid[..., None, :]
    ang = xp.arctan2(rel[..., 1], rel[..., 0])
    big = xp.asarray(1e9, dtype=ang.dtype)
    key = xp.where(valid, ang, big)
    order = xp.argsort(key, axis=-1)
    sorted_pts = xp.take_along_axis(pts, order[..., None], axis=-2)
    sorted_valid = xp.take_along_axis(valid, order, axis=-1)
    # invalid (tail) vertices collapse onto the first vertex -> zero area
    first = sorted_pts[..., 0:1, :]
    poly = xp.where(sorted_valid[..., None], sorted_pts, first)
    nxt = xp.roll(poly, -1, axis=-2)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    return xp.abs(xp.sum(cross, axis=-1)) * 0.5


def _rotated_overlap(xp, rbboxes1, rbboxes2, criterion=-1):
    """Pairwise rotated overlap [N, 5] x [K, 5] -> [N, K]."""
    c1 = _rbbox_to_corners(xp, rbboxes1)[:, None]   # [N, 1, 4, 2]
    c2 = _rbbox_to_corners(xp, rbboxes2)[None, :]   # [1, K, 4, 2]
    n, k = rbboxes1.shape[0], rbboxes2.shape[0]
    c1 = xp.broadcast_to(c1, (n, k, 4, 2))
    c2 = xp.broadcast_to(c2, (n, k, 4, 2))
    inter = _intersection_area(xp, c1, c2)
    area1 = (rbboxes1[:, 2] * rbboxes1[:, 3])[:, None]
    area2 = (rbboxes2[:, 2] * rbboxes2[:, 3])[None, :]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1 + xp.zeros_like(inter)
    elif criterion == 1:
        denom = area2 + xp.zeros_like(inter)
    else:
        return inter
    return inter / xp.where(xp.abs(denom) < 1e-12, 1.0, denom)


def rotated_iou_np(rbboxes1: np.ndarray, rbboxes2: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    """Host (NumPy) pairwise rotated overlap — eval-harness twin of the
    reference ``rotate_iou_gpu_eval`` (nms_gpu.py:618-653)."""
    if rbboxes1.shape[0] == 0 or rbboxes2.shape[0] == 0:
        return np.zeros((rbboxes1.shape[0], rbboxes2.shape[0]), dtype=np.float32)
    return np.asarray(
        _rotated_overlap(np, rbboxes1.astype(np.float64),
                         rbboxes2.astype(np.float64), criterion),
        dtype=np.float32)
