"""Host-side augmentation: per-object noise + global transforms.

reference load_data.py:794-1165 — kept on the host because the per-object
100-trial collision-rejection loop is inherently sequential and data
dependent; it overlaps with device compute via the prefetching pipeline.
The numba kernels become vectorized NumPy (trials vectorized per object).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pillars_torch.config import AugmentConfig
from pillars_torch.geometry import np_boxes as nb


def random_flip(gt_boxes, points, probability=0.5, rng=None):
    """Flip y (reference load_data.py:890-906)."""
    rng = rng or np.random
    enable = rng.choice([False, True], replace=False,
                        p=[1 - probability, probability])
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation, rng=None):
    """reference load_data.py:794-803."""
    rng = rng or np.random
    noise = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = nb.rotation_points_single_angle(points[:, :3], noise, axis=2)
    gt_boxes[:, :3] = nb.rotation_points_single_angle(gt_boxes[:, :3], noise, axis=2)
    gt_boxes[:, 6] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, min_scale=0.95, max_scale=1.05, rng=None):
    """reference load_data.py:883-888 (global_scaling_v2)."""
    rng = rng or np.random
    s = rng.uniform(min_scale, max_scale)
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_std, rng=None):
    """reference load_data.py:865-881. Quirk preserved: the z noise uses
    noise_std[0], not noise_std[2] (load_data.py:875)."""
    rng = rng or np.random
    noise = np.array([
        rng.normal(0, noise_std[0], 1),
        rng.normal(0, noise_std[1], 1),
        rng.normal(0, noise_std[0], 1),
    ]).T
    points[:, :3] += noise
    gt_boxes[:, :3] += noise
    return gt_boxes, points


# ---------------------------------------------------------------------------
# per-object noise (reference noise_per_object_v3_, load_data.py:913-1007)
# ---------------------------------------------------------------------------

def _noise_per_box(boxes_bv, valid_mask, loc_noises, rot_noises):
    """For each valid box, pick the first of num_try (loc, rot) perturbations
    whose perturbed corners collide with no other box.

    Vectorized form of reference load_data.py:1136-1165 (noise_per_box): the
    trial dimension is vectorized; boxes stay sequential because accepted
    transforms update the collision geometry.
    Returns [N] selected trial index or -1."""
    num_boxes = boxes_bv.shape[0]
    num_tests = loc_noises.shape[1]
    box_corners = nb.center_to_corner_box2d(
        boxes_bv[:, :2], boxes_bv[:, 2:4], boxes_bv[:, 4])  # via box2d corners
    success = np.full((num_boxes,), -1, dtype=np.int64)
    for i in range(num_boxes):
        if not valid_mask[i]:
            continue
        # all trials at once: rotate corners around the box center, translate
        rel = box_corners[i] - boxes_bv[i, :2]               # [4, 2]
        cos = np.cos(rot_noises[i])
        sin = np.sin(rot_noises[i])
        # rot_mat_T = [[cos, -sin], [sin, cos]], applied as corners @ rot_mat_T
        # (reference _rotation_box2d_jit_, load_data.py:1168-1176)
        rot = np.stack([np.stack([cos, -sin], -1),
                        np.stack([sin, cos], -1)], -2)       # [T, 2, 2]
        trial_corners = rel[None] @ rot                      # [T, 4, 2]
        trial_corners += boxes_bv[i, :2] + loc_noises[i, :, :2][:, None, :]
        others = np.delete(box_corners, i, axis=0)
        if len(others) == 0:
            success[i] = 0
            box_corners[i] = trial_corners[0]
            continue
        coll = nb.box_collision_test(trial_corners, others)  # [T, N-1]
        ok = ~coll.any(axis=1)
        idx = np.argmax(ok)
        if ok[idx]:
            success[i] = idx
            box_corners[i] = trial_corners[idx]
    return success


def _select_transform(transform, indices):
    """reference load_data.py:1106-1112."""
    result = np.zeros((transform.shape[0],) + transform.shape[2:],
                      dtype=transform.dtype)
    sel = indices != -1
    result[sel] = transform[np.arange(len(indices))[sel], indices[sel]]
    return result


def _transform_points(points, centers, point_masks, loc_transform,
                      rot_transform, valid_mask):
    """Apply each box's accepted transform to its member points; each point
    follows its FIRST containing box (reference points_transform_,
    load_data.py:1017-1033)."""
    num_box = centers.shape[0]
    # first containing valid box per point, or -1
    masks = point_masks & valid_mask[None, :]
    has_box = masks.any(axis=1)
    first_box = np.argmax(masks, axis=1)
    for j in range(num_box):
        if not valid_mask[j]:
            continue
        sel = has_box & (first_box == j)
        if not sel.any():
            continue
        sin, cos = np.sin(rot_transform[j]), np.cos(rot_transform[j])
        rot_t = np.array([[cos, -sin, 0], [sin, cos, 0], [0, 0, 1]],
                         dtype=points.dtype)
        p = points[sel, :3] - centers[j, :3]
        points[sel, :3] = p @ rot_t + centers[j, :3] + loc_transform[j]
    return points


def noise_per_object(gt_boxes: np.ndarray, points: Optional[np.ndarray],
                     valid_mask: Optional[np.ndarray], cfg: AugmentConfig,
                     rng=None) -> None:
    """In-place per-object rotation/translation noise with collision
    rejection (reference noise_per_object_v3_, load_data.py:913-1007;
    group_ids/global-rot branches are dead in the reference config)."""
    rng = rng or np.random
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if valid_mask is None:
        valid_mask = np.ones((num_boxes,), dtype=bool)
    num_try = cfg.noise_num_try
    loc_noises = rng.normal(
        scale=np.asarray(cfg.gt_loc_noise_std), size=[num_boxes, num_try, 3])
    rot_noises = rng.uniform(
        cfg.gt_rotation_noise[0], cfg.gt_rotation_noise[1],
        size=[num_boxes, num_try])

    origin = (0.5, 0.5, 0.0)
    gt_box_corners = nb.center_to_corner_box3d(
        gt_boxes[:, :3], gt_boxes[:, 3:6], gt_boxes[:, 6],
        origin=origin, axis=2)
    selected = _noise_per_box(gt_boxes[:, [0, 1, 3, 4, 6]], valid_mask,
                              loc_noises, rot_noises)
    loc_transforms = _select_transform(loc_noises, selected)
    rot_transforms = _select_transform(rot_noises, selected)
    surfaces = nb.corner_to_surfaces_3d(gt_box_corners)
    if points is not None and len(points) > 0:
        point_masks = nb.points_in_convex_polygon_3d(points[:, :3], surfaces)
        _transform_points(points, gt_boxes[:, :3], point_masks,
                          loc_transforms, rot_transforms, valid_mask)
    # box3d_transform_ (reference load_data.py:1008-1014)
    gt_boxes[valid_mask, :3] += loc_transforms[valid_mask]
    gt_boxes[valid_mask, 6] += rot_transforms[valid_mask]
