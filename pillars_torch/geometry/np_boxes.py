"""Vectorized NumPy geometry twins for the host data pipeline and tests.

These mirror :mod:`pillars_torch.geometry.boxes` (same math, same conventions)
but run on the host where the irregular augmentation pipeline lives. The
reference implemented these as numba JIT loops (load_data.py:808-1341,
second/core/geometry.py); here they are vectorized NumPy — no numba needed.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# angles / corners
# ---------------------------------------------------------------------------

def limit_period(val, offset=0.5, period=np.pi):
    """reference load_data.py:805-806."""
    return val - np.floor(val / period + offset) * period


def corners_nd(dims: np.ndarray, origin=0.5) -> np.ndarray:
    """reference load_data.py:1563-1597."""
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2**ndim), [2] * ndim), axis=1).astype(dims.dtype)
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape([-1, 1, ndim]) * corners_norm.reshape([1, 2**ndim, ndim])


def rotation_2d(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Clockwise-positive 2D rotation. reference load_data.py:1547-1561."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rot_mat_T = np.stack([[rot_cos, -rot_sin], [rot_sin, rot_cos]])
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray, axis=2) -> np.ndarray:
    """reference load_data.py:1227-1246."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    if axis == 1:
        rot_mat_T = np.stack([[rot_cos, zeros, -rot_sin], [zeros, ones, zeros],
                              [rot_sin, zeros, rot_cos]])
    elif axis in (2, -1):
        rot_mat_T = np.stack([[rot_cos, -rot_sin, zeros],
                              [rot_sin, rot_cos, zeros], [zeros, zeros, ones]])
    elif axis == 0:
        rot_mat_T = np.stack([[zeros, rot_cos, -rot_sin],
                              [zeros, rot_sin, rot_cos], [ones, zeros, zeros]])
    else:
        raise ValueError("axis should be in range")
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_points_single_angle(points: np.ndarray, angle: float, axis=2) -> np.ndarray:
    """Rotate [N,3] points by a single angle. reference load_data.py:775-793."""
    rot_sin = np.sin(angle)
    rot_cos = np.cos(angle)
    if axis == 1:
        rot_mat_T = np.array(
            [[rot_cos, 0, -rot_sin], [0, 1, 0], [rot_sin, 0, rot_cos]],
            dtype=points.dtype)
    elif axis in (2, -1):
        rot_mat_T = np.array(
            [[rot_cos, -rot_sin, 0], [rot_sin, rot_cos, 0], [0, 0, 1]],
            dtype=points.dtype)
    elif axis == 0:
        rot_mat_T = np.array(
            [[1, 0, 0], [0, rot_cos, -rot_sin], [0, rot_sin, rot_cos]],
            dtype=points.dtype)
    else:
        raise ValueError("axis should be in range")
    return points @ rot_mat_T


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """reference load_data.py:1525-1545."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape([-1, 1, 2])


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.0), axis=2):
    """reference load_data.py:1200-1225."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape([-1, 1, 3])


def corner_to_standup(boxes_corner: np.ndarray) -> np.ndarray:
    """reference load_data.py:1331-1341."""
    return np.concatenate(
        [boxes_corner.min(axis=-2), boxes_corner.max(axis=-2)], axis=-1)


def center_to_minmax_2d(centers, dims):
    """reference load_data.py:549-556."""
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def minmax_to_corner_2d(minmax_box):
    """reference load_data.py:860-864."""
    ndim = minmax_box.shape[-1] // 2
    center = minmax_box[..., :ndim]
    dims = minmax_box[..., ndim:] - center
    return center_to_corner_box2d(center, dims, origin=0.0)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """reference load_data.py:533-548."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(bboxes_center[:, :2], bboxes_center[:, 2:])


# ---------------------------------------------------------------------------
# point-in-box tests (vectorized)
# ---------------------------------------------------------------------------

def corner_to_surfaces_3d(corners: np.ndarray) -> np.ndarray:
    """[N,8,3] corners -> [N,6,4,3] surfaces, normals pointing inward.

    Vectorized equivalent of reference load_data.py:1117-1134."""
    idx = np.array(
        [0, 1, 2, 3, 7, 6, 5, 4, 0, 3, 7, 4, 1, 5, 6, 2, 0, 4, 5, 1, 3, 2, 6, 7]
    ).reshape(6, 4)
    return corners[:, idx.reshape(-1), :].reshape(-1, 6, 4, 3)


def surface_equ_3d(polygon_surfaces: np.ndarray):
    """Plane equations (normal, -d) per surface. reference load_data.py:1056-1066."""
    surface_vec = polygon_surfaces[:, :, :2, :] - polygon_surfaces[:, :, 1:3, :]
    normal_vec = np.cross(surface_vec[:, :, 0, :], surface_vec[:, :, 1, :])
    d = np.einsum("aij, aij->ai", normal_vec, polygon_surfaces[:, :, 0, :])
    return normal_vec, -d


def points_in_convex_polygon_3d(points: np.ndarray,
                                polygon_surfaces: np.ndarray) -> np.ndarray:
    """[Npts,3] x [Npoly,6,4,3] -> [Npts,Npoly] bool membership.

    Vectorized equivalent of reference load_data.py:1068-1104
    (points_in_convex_polygon_3d_jit). A point is inside iff the signed
    distance to every surface plane is negative.

    Perf: a per-polygon AABB prefilter cuts the exact plane test from all
    Npts rows to the few that can possibly be inside (a convex polytope is
    contained in its vertex AABB, so the filter is a strict superset of
    the inside set and changes no answers). The exact test runs as one
    BLAS matmul over the surviving rows instead of np.einsum over all of
    them — together ~20x at full-LiDAR scene scale (53k points, ~25
    boxes), which is what keeps the host augmentation pipeline ahead of
    the TPU train step (it was the measured wall at ~1 s/sample)."""
    pts = points[:, :3]
    n_pts, n_poly = pts.shape[0], polygon_surfaces.shape[0]
    out = np.zeros((n_pts, n_poly), dtype=bool)
    if n_pts == 0 or n_poly == 0:
        return out
    verts = polygon_surfaces.reshape(n_poly, -1, 3)
    lo, hi = verts.min(axis=1), verts.max(axis=1)
    cand = np.ones((n_pts, n_poly), dtype=bool)
    for a in range(3):
        cand &= pts[:, a:a + 1] >= lo[None, :, a]
        cand &= pts[:, a:a + 1] <= hi[None, :, a]
    rows = np.flatnonzero(cand.any(axis=1))
    if rows.size == 0:
        return out
    normal_vec, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    # sign[i, j, k] = points[i] . normal[j, k] + d[j, k]
    sign = (pts[rows] @ normal_vec.reshape(-1, 3).T).reshape(
        rows.size, n_poly, 6) + d[None]
    out[rows] = np.all(sign < 0, axis=-1)
    return out


def points_in_convex_polygon_2d(points: np.ndarray, polygon: np.ndarray,
                                clockwise: bool = True) -> np.ndarray:
    """[Npts,2] x [Npoly,K,2] -> [Npts,Npoly] bool.

    Vectorized equivalent of reference load_data.py:808-842."""
    num_pts_polygon = polygon.shape[1]
    order = [num_pts_polygon - 1] + list(range(num_pts_polygon - 1))
    if clockwise:
        vec1 = polygon - polygon[:, order, :]
    else:
        vec1 = polygon[:, order, :] - polygon
    # cross[i, j, k] = vec1[j,k,1]*(polygon[j,k,0]-points[i,0])
    #                - vec1[j,k,0]*(polygon[j,k,1]-points[i,1])
    cross = (vec1[None, :, :, 1] * (polygon[None, :, :, 0] - points[:, None, None, 0])
             - vec1[None, :, :, 0] * (polygon[None, :, :, 1] - points[:, None, None, 1]))
    return np.all(cross < 0, axis=-1)


def points_in_rbbox(points: np.ndarray, rbbox: np.ndarray) -> np.ndarray:
    """[Npts,>=3] x [N,7] lidar boxes -> [Npts,N] bool.

    reference load_data.py:109-123 (points_in_rbbox); lidar origin
    (0.5, 0.5, 0), rotation about z."""
    corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, 6], origin=(0.5, 0.5, 0.0), axis=2)
    surfaces = corner_to_surfaces_3d(corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)


# ---------------------------------------------------------------------------
# rotated-rectangle collision test (vectorized)
# ---------------------------------------------------------------------------

def _segments_intersect(a, b, c, d):
    """Batched proper-intersection test of segments (a,b) x (c,d).

    a,b: [..., 2]; returns bool[...]. Same predicate as the reference's
    acd/bcd/abc/abd orientation test (load_data.py:1259-1282)."""
    def orient_gt(p, q, r):
        return ((r[..., 1] - p[..., 1]) * (q[..., 0] - p[..., 0])
                > (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

    acd = orient_gt(a, c, d)
    bcd = orient_gt(b, c, d)
    abc = orient_gt(a, b, c)
    abd = orient_gt(a, b, d)
    return (acd != bcd) & (abc != abd)


def _contains_all(outer_corners, inner_points, clockwise=True):
    """For clockwise rects: [N,4,2] x [K,4,2] -> [N,K] "outer fully contains
    EVERY inner point". Mirrors the containment branch of
    reference load_data.py:1283-1320."""
    # reference: vec = corner_k - corner_{k+1}, negated when clockwise
    # (load_data.py:1286-1292) -> corner_{k+1} - corner_k for clockwise rects.
    nxt = np.roll(outer_corners, -1, axis=1)
    vec = nxt - outer_corners if clockwise else outer_corners - nxt
    # cross[n, k, K, l] for outer n edge k against inner point (K, l)
    dx = outer_corners[:, None, :, None, 0] - inner_points[None, :, None, :, 0]
    dy = outer_corners[:, None, :, None, 1] - inner_points[None, :, None, :, 1]
    cross = vec[:, None, :, None, 1] * dx - vec[:, None, :, None, 0] * dy
    inside_pt = np.all(cross < 0, axis=2)  # [N, K, L] all outer edges
    return np.all(inside_pt, axis=-1)      # [N, K] all inner points


def _contains_pair(outer: np.ndarray, inner: np.ndarray,
                   clockwise: bool = True) -> np.ndarray:
    """Paired form of _contains_all: [M,4,2] x [M,4,2] -> [M] "outer[m]
    fully contains every corner of inner[m]"."""
    nxt = np.roll(outer, -1, axis=1)
    vec = nxt - outer if clockwise else outer - nxt
    dx = outer[:, :, None, 0] - inner[:, None, :, 0]  # [M, 4 edges, 4 pts]
    dy = outer[:, :, None, 1] - inner[:, None, :, 1]
    cross = vec[:, :, None, 1] * dx - vec[:, :, None, 0] * dy
    return np.all(cross < 0, axis=(1, 2))


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """Pairwise rotated-rect collision, [N,4,2] x [K,4,2] -> [N,K] bool.

    Vectorized equivalent of reference load_data.py:1247-1327: standup-box
    prefilter, 4x4 edge intersection, then full-containment check both
    ways. Like the reference's per-pair `if overlap:` skip, the exact
    segment/containment tests run only on the pairs that pass the standup
    prefilter (gathered, not broadcast) — in the per-object-noise loop a
    trial box overlaps almost nothing, so this is the difference between
    O(N*K) and O(overlapping pairs) exact tests."""
    N, K = boxes.shape[0], qboxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), dtype=bool)
    boxes_standup = corner_to_standup(boxes)
    qboxes_standup = corner_to_standup(qboxes)
    iw = (np.minimum(boxes_standup[:, None, 2], qboxes_standup[None, :, 2])
          - np.maximum(boxes_standup[:, None, 0], qboxes_standup[None, :, 0]))
    ih = (np.minimum(boxes_standup[:, None, 3], qboxes_standup[None, :, 3])
          - np.maximum(boxes_standup[:, None, 1], qboxes_standup[None, :, 1]))
    overlap = (iw > 0) & (ih > 0)
    pi, pj = np.nonzero(overlap)
    if pi.size == 0:
        return overlap
    bm, qm = boxes[pi], qboxes[pj]  # [M,4,2] paired

    # edges: [M, 4, 2(endpoint), 2(xy)]
    lines_a = np.stack([bm, np.roll(bm, -1, axis=1)], axis=2)
    lines_b = np.stack([qm, np.roll(qm, -1, axis=1)], axis=2)
    a = lines_a[:, :, None, 0]  # [M,4,1,2]
    b = lines_a[:, :, None, 1]
    c = lines_b[:, None, :, 0]  # [M,1,4,2]
    d = lines_b[:, None, :, 1]
    seg = np.any(_segments_intersect(a, b, c, d), axis=(1, 2))  # [M]

    contains = _contains_pair(bm, qm) | _contains_pair(qm, bm)
    out = np.zeros((N, K), dtype=bool)
    out[pi, pj] = seg | contains
    return out


# ---------------------------------------------------------------------------
# axis-aligned IoU
# ---------------------------------------------------------------------------

def iou_matrix(boxes: np.ndarray, query_boxes: np.ndarray, eps=0.0) -> np.ndarray:
    """Vectorized reference load_data.py:206-235 (iou_jit)."""
    n_area = (boxes[:, 2] - boxes[:, 0] + eps) * (boxes[:, 3] - boxes[:, 1] + eps)
    k_area = (query_boxes[:, 2] - query_boxes[:, 0] + eps) * (
        query_boxes[:, 3] - query_boxes[:, 1] + eps)
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]) + eps)
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]) + eps)
    iw = np.maximum(iw, 0.0)
    ih = np.maximum(ih, 0.0)
    inter = iw * ih
    union = n_area[:, None] + k_area[None, :] - inter
    out = np.zeros_like(inter)
    pos = inter > 0
    out[pos] = inter[pos] / union[pos]
    return out


# ---------------------------------------------------------------------------
# coordinate frames
# ---------------------------------------------------------------------------

def _homogeneous(points):
    return np.concatenate(
        [points, np.ones(list(points.shape[:-1]) + [1], dtype=points.dtype)], axis=-1)


def lidar_to_camera(points, r_rect, velo2cam):
    """reference load_data.py:1510-1516."""
    return (_homogeneous(points) @ (r_rect @ velo2cam).T)[..., :3]


def camera_to_lidar(points, r_rect, velo2cam):
    """reference load_data.py:1489-1498."""
    return (_homogeneous(points) @ np.linalg.inv((r_rect @ velo2cam).T))[..., :3]


def box_lidar_to_camera(boxes, r_rect, velo2cam):
    """reference load_data.py:1518-1523."""
    xyz = lidar_to_camera(boxes[:, :3], r_rect, velo2cam)
    w, l, h = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    return np.concatenate([xyz, l, h, w, boxes[:, 6:7]], axis=1)


def box_camera_to_lidar(boxes, r_rect, velo2cam):
    """reference load_data.py:1501-1508."""
    xyz = camera_to_lidar(boxes[:, :3], r_rect, velo2cam)
    l, h, w = boxes[:, 3:4], boxes[:, 4:5], boxes[:, 5:6]
    return np.concatenate([xyz, w, l, h, boxes[:, 6:7]], axis=1)


def filter_gt_box_outside_range_by_center(gt_boxes, limit_range):
    """Keep boxes whose BEV center lies in the range polygon.

    reference load_data.py:95-107."""
    gt_box_centers = gt_boxes[:, :2]
    bounding_box = minmax_to_corner_2d(np.asarray(limit_range)[np.newaxis, ...])
    ret = points_in_convex_polygon_2d(gt_box_centers, bounding_box)
    return ret.reshape(-1)
