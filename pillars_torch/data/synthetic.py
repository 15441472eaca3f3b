"""Synthetic d435i-like pedestrian dataset generator.

The real dataset (reference README.md:44-75, recorded with an Intel RealSense
d435i) is not shipped; this generates a structurally identical dataset on
disk — pickled float32 pointclouds, KITTI label/calib text files, info pkls
and a GT database — so every flow (train / eval / create-data / bench /
streaming replay) runs end to end and tests are hermetic.

Scenes: a ground plane + wall clutter + N pedestrians (ellipsoid point blobs
with legs/torso structure), annotated in CAMERA coordinates like the
reference capture tool does (realsense_make_dataset.py:622-801).
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Tuple

import numpy as np

from pillars_torch.data import kitti_infos as ki
from pillars_torch.geometry import np_boxes as nb

# d435i capture frame: identity rect, identity velo2cam is WRONG for KITTI
# but matches the reference custom dataset ("rect is just the unity matrix
# for d435i data", load_data.py:2466-2469) apart from axis naming: we use an
# axis-permuting velo2cam so camera(x right, y down, z fwd) <-> lidar
# (x fwd, y left, z up) conversions stay non-trivial, exercising the math.
VELO2CAM = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)
RECT = np.eye(4, dtype=np.float32)


def _pedestrian_points(rng, box, n=None):
    """Point blob shaped like a standing person inside a lidar box
    [x, y, z, w, l, h, r] (z = bottom).

    Generated in the box's LOCAL frame and rotated into the world by the
    label yaw ``r`` with the same clockwise-positive convention as box
    corners (np_boxes.rotation_2d; reference load_data.py:1547-1561), with
    a front/back asymmetry (forward = local +x: chest lean, backward leg
    bias, face cluster pulled to the front surface) so heading — INCLUDING
    its sign — is observable from geometry. Without the rotation the
    regression target for r is label noise, and without the 180-degree
    asymmetry the direction classifier (rot_gt>0 target, reference
    voxelnet.py:38-46) has nothing learnable.
    """
    x, y, z, w, l, h, r = box
    n = n or int(rng.randint(80, 400))
    t = rng.uniform(0, 1, n)
    torso = t > 0.45
    face = t > 0.82
    radius = np.where(torso, 0.5, 0.3)
    ang = rng.uniform(-np.pi, np.pi, n)
    rad = rng.uniform(0, 1, n) ** 0.5 * radius
    lx = np.cos(ang) * rad * w / 2 * 1.6
    ly = np.sin(ang) * rad * l / 2 * 1.6
    # chest lean forward / feet trail backward (breaks 180-deg symmetry)
    lx = lx + np.where(torso, 0.08, -0.06) * w
    # face/nose cluster: most head-height points sit on the front surface
    on_face = face & (rng.uniform(0, 1, n) < 0.7)
    lx = np.where(on_face, (0.36 + rng.uniform(0, 0.08, n)) * w, lx)
    ly = np.where(on_face, ly * 0.4, ly)
    # rotate local offsets into the world with the box-corner convention
    c, s = np.cos(r), np.sin(r)
    pts = np.zeros((n, 3), dtype=np.float32)
    pts[:, 0] = x + lx * c + ly * s
    pts[:, 1] = y - lx * s + ly * c
    pts[:, 2] = z + t * h
    pts[:, :2] += rng.normal(0, 0.02, (n, 2))
    return pts


def _scene_background(rng, n=15000):
    pts = np.zeros((n, 3), dtype=np.float32)
    n_floor = n // 2
    pts[:n_floor, 0] = rng.uniform(0.0, 6.4, n_floor)
    pts[:n_floor, 1] = rng.uniform(-2.56, 2.56, n_floor)
    pts[:n_floor, 2] = rng.normal(-1.45, 0.03, n_floor)
    n_wall = n - n_floor
    wall_x = rng.uniform(5.5, 6.4)
    pts[n_floor:, 0] = rng.normal(wall_x, 0.05, n_wall)
    pts[n_floor:, 1] = rng.uniform(-2.56, 2.56, n_wall)
    pts[n_floor:, 2] = rng.uniform(-1.45, 1.2, n_wall)
    return pts


def make_scene(rng, max_peds: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (points [N,3] lidar, gt_boxes_lidar [K,7])."""
    n_ped = rng.randint(1, max_peds + 1)
    boxes = []
    for _ in range(n_ped):
        for _try in range(20):
            box = np.array([
                rng.uniform(0.8, 5.8), rng.uniform(-2.2, 2.2), -1.45,
                rng.uniform(0.5, 0.7), rng.uniform(0.6, 1.0),
                rng.uniform(1.5, 1.9), rng.uniform(-np.pi, np.pi)],
                dtype=np.float32)
            if not boxes:
                break
            bv = np.array(boxes)[:, [0, 1]]
            if np.all(np.linalg.norm(bv - box[:2], axis=1) > 1.2):
                break
        boxes.append(box)
    gt = np.array(boxes, dtype=np.float32)
    pts = [_scene_background(rng)]
    for b in gt:
        pts.append(_pedestrian_points(rng, b))
    return np.concatenate(pts, axis=0).astype(np.float32), gt


def _write_kitti_label(path, gt_boxes_lidar, meta=None, names=None):
    """Write lidar boxes as KITTI-format camera-frame labels.

    ``meta``: optional list of per-object dicts with ``truncated`` /
    ``occluded`` / ``bbox`` (pixel [x1, y1, x2, y2]); defaults reproduce the
    easy-profile fixed values (everything easy-difficulty).
    ``names``: per-object class names (default: all Pedestrian)."""
    cam = nb.box_lidar_to_camera(gt_boxes_lidar, RECT, VELO2CAM)
    lines = []
    for i, b in enumerate(cam):
        x, y, z, l, h, w, ry = b
        # kitti file order: h w l, camera loc at box BOTTOM center (y down):
        # our lidar->camera conversion maps z-bottom to y via -z, so the
        # camera y already refers to the bottom in this synthetic frame.
        alpha = -np.arctan2(-b[0], b[2]) + ry
        m = meta[i] if meta else {}
        trunc = m.get("truncated", 0.0)
        occ = m.get("occluded", 0)
        bx = m.get("bbox", (300.0, 150.0, 400.0, 350.0))
        name = names[i] if names is not None else "Pedestrian"
        lines.append(
            f"{name} {trunc:.2f} {occ} {alpha:.2f} "
            f"{bx[0]:.2f} {bx[1]:.2f} {bx[2]:.2f} {bx[3]:.2f} "
            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
    pathlib.Path(path).write_text("\n".join(lines) + "\n" if lines else "")


# ---------------------------------------------------------------------------
# "hard" benchmark profile (round-2 AP anchor): distance-stratified point
# sparsity, front-surface-only returns, shadow occlusion from scene clutter,
# lateral truncation, pedestrian-like distractors, and a virtual pinhole
# bbox so the KITTI easy/moderate/hard gates (MIN_HEIGHT 40/25/25 px,
# MAX_OCCLUSION 0/1/2, MAX_TRUNCATION .15/.3/.5) actually stratify.
# A trained detector lands mid-curve here instead of saturating at AP=100
# like the easy profile.
# ---------------------------------------------------------------------------

_PINHOLE_F = 120.0  # px; 1.7m ped: 102px@2m, 40px@5.1m, 25px@8.2m


def _front_surface_cull(rng, pts, center_xy, keep_back=0.25):
    """Drop most points on the sensor-averted half of a blob (a depth
    camera sees surfaces, not volumes)."""
    ray = center_xy / max(np.linalg.norm(center_xy), 1e-6)
    depth = (pts[:, :2] - center_xy) @ ray
    back = depth > 0
    keep = ~back | (rng.uniform(0, 1, len(pts)) < keep_back)
    return pts[keep]


def _range_scaled_count(rng, dist, base_lo=150, base_hi=450, ref=1.5):
    n = int(rng.randint(base_lo, base_hi) * min(1.0, (ref / dist) ** 2))
    return max(n, 3)


def _cylinder_points(rng, x, y, z0, radius, height, n):
    ang = rng.uniform(-np.pi, np.pi, n)
    pts = np.zeros((n, 3), dtype=np.float32)
    pts[:, 0] = x + np.cos(ang) * radius
    pts[:, 1] = y + np.sin(ang) * radius
    pts[:, 2] = z0 + rng.uniform(0, 1, n) * height
    pts[:, :2] += rng.normal(0, 0.02, (n, 2))
    return pts


def _blob_points(rng, x, y, z0, w, l, h, n):
    pts = np.zeros((n, 3), dtype=np.float32)
    u = rng.normal(0, 0.35, (n, 3))
    pts[:, 0] = x + u[:, 0] * w
    pts[:, 1] = y + u[:, 1] * l
    pts[:, 2] = z0 + np.clip(0.5 + u[:, 2] * 0.4, 0, 1) * h
    return pts


def _shadow_mask(pts, occluders):
    """True for points NOT occluded: a point is shadowed when its BEV ray
    from the origin passes through an occluder disc closer than the point."""
    if not occluders:
        return np.ones(len(pts), dtype=bool)
    ang = np.arctan2(pts[:, 1], pts[:, 0])
    rng_pt = np.linalg.norm(pts[:, :2], axis=1)
    shadowed = np.zeros(len(pts), dtype=bool)
    for (cx, cy, rad) in occluders:
        d = np.hypot(cx, cy)
        if d < 1e-3:
            continue
        half = np.arcsin(min(rad / d, 1.0)) * 0.9
        ca = np.arctan2(cy, cx)
        da = np.abs(np.angle(np.exp(1j * (ang - ca))))
        shadowed |= (da < half) & (rng_pt > d + rad * 0.5)
    return ~shadowed


def make_scene_hard(rng, max_peds: int = 5):
    """Returns (points [N,3] lidar, gt_boxes_lidar [K,7], meta list).

    meta[i]: truncated / occluded / bbox for the KITTI label line."""
    n_ped = rng.randint(1, max_peds + 1)
    boxes = []
    for _ in range(n_ped):
        for _try in range(30):
            stratum = rng.randint(0, 3)
            dist = [rng.uniform(0.9, 2.5), rng.uniform(2.5, 4.5),
                    rng.uniform(4.5, 6.2)][stratum]
            ang = rng.uniform(-0.62, 0.62)  # keep x>0 cone
            x = dist * np.cos(ang)
            y = np.clip(dist * np.sin(ang) + rng.uniform(-0.8, 0.8),
                        -2.75, 2.75)
            box = np.array([
                x, y, -1.45,
                rng.uniform(0.5, 0.7), rng.uniform(0.6, 1.0),
                rng.uniform(1.5, 1.9), rng.uniform(-np.pi, np.pi)],
                dtype=np.float32)
            if not boxes or np.all(np.linalg.norm(
                    np.array(boxes)[:, :2] - box[:2], axis=1) > 1.0):
                break
        boxes.append(box)
    gt = np.array(boxes, dtype=np.float32)

    # clutter: poles / bushes / crates; some pedestrian-sized (distractors)
    occluders = []  # (x, y, bev_radius) for shadow casting
    clutter_pts = []
    for _ in range(rng.randint(2, 7)):
        kind = rng.randint(0, 3)
        d = rng.uniform(0.8, 5.8)
        a = rng.uniform(-0.62, 0.62)
        cx, cy = d * np.cos(a), np.clip(d * np.sin(a), -2.5, 2.5)
        if np.any(np.linalg.norm(gt[:, :2] - [cx, cy], axis=1) < 0.8):
            continue
        n = _range_scaled_count(rng, d, 80, 260)
        if kind == 0:    # pole
            rad = rng.uniform(0.05, 0.2)
            clutter_pts.append(_cylinder_points(
                rng, cx, cy, -1.45, rad, rng.uniform(1.0, 2.2), n))
            occluders.append((cx, cy, rad))
        elif kind == 1:  # bush / blob, sometimes pedestrian-sized
            w = rng.uniform(0.4, 1.0)
            h = rng.uniform(0.6, 1.8)
            clutter_pts.append(_blob_points(
                rng, cx, cy, -1.45, w, w * rng.uniform(0.8, 1.3), h, n))
            occluders.append((cx, cy, w * 0.6))
        else:            # crate / bin
            rad = rng.uniform(0.25, 0.5)
            clutter_pts.append(_cylinder_points(
                rng, cx, cy, -1.45, rad, rng.uniform(0.6, 1.2), n))
            occluders.append((cx, cy, rad))

    # deliberate occluder in front of one pedestrian (50% of scenes)
    if rng.uniform() < 0.5 and len(gt):
        tgt = gt[rng.randint(len(gt))]
        frac = rng.uniform(0.4, 0.8)
        cx, cy = tgt[0] * frac, tgt[1] * frac
        rad = rng.uniform(0.2, 0.45)
        d = np.hypot(cx, cy)
        if d > 0.7:
            clutter_pts.append(_cylinder_points(
                rng, cx, cy, -1.45, rad, rng.uniform(0.9, 1.6),
                _range_scaled_count(rng, d, 80, 260)))
            occluders.append((cx, cy, rad))

    pts_all = [_scene_background(rng)]
    if clutter_pts:
        pts_all.append(np.concatenate(clutter_pts, axis=0))

    meta = []
    for b in gt:
        dist = float(np.hypot(b[0], b[1]))
        n = _range_scaled_count(rng, dist)
        raw = _pedestrian_points(rng, b, n=n)
        raw[:, :2] += rng.normal(0, 0.005 * dist, (len(raw), 2))
        raw = _front_surface_cull(rng, raw, b[:2])
        vis = _shadow_mask(raw, occluders)
        # partial shadows: occluders leak a per-object random fraction, so
        # the occlusion label spans the full 0/1/2 range
        leak = rng.uniform(0.02, 0.5)
        kept = raw[vis | (rng.uniform(0, 1, len(raw)) < leak)]
        occ_frac = 1.0 - len(kept) / max(len(raw), 1)
        # lateral truncation: box volume outside the y range is never seen
        y_lo, y_hi = b[1] - b[4] / 2, b[1] + b[4] / 2
        seen = (min(y_hi, 2.56) - max(y_lo, -2.56)) / max(y_hi - y_lo, 1e-6)
        trunc = float(np.clip(1.0 - seen, 0.0, 1.0))
        kept = kept[np.abs(kept[:, 1]) < 2.56]
        pts_all.append(kept.astype(np.float32))
        occluded = 0 if occ_frac < 0.15 else (1 if occ_frac < 0.5 else 2)
        # virtual pinhole bbox: camera z == lidar x (VELO2CAM above)
        h_px = _PINHOLE_F * b[5] / max(b[0], 0.5)
        w_px = _PINHOLE_F * max(b[3], b[4]) / max(b[0], 0.5)
        cx_px = 620.0 + _PINHOLE_F * (-b[1]) / max(b[0], 0.5)
        cy_px = 187.0
        meta.append(dict(
            truncated=trunc, occluded=occluded,
            bbox=(cx_px - w_px / 2, cy_px - h_px / 2,
                  cx_px + w_px / 2, cy_px + h_px / 2)))

    pts = np.concatenate(pts_all, axis=0).astype(np.float32)
    # sensor dropout + ghost points
    keep = rng.uniform(0, 1, len(pts)) > 0.05
    pts = pts[keep]
    n_ghost = rng.randint(20, 120)
    ghosts = np.stack([
        rng.uniform(0.0, 6.4, n_ghost),
        rng.uniform(-2.56, 2.56, n_ghost),
        rng.uniform(-1.45, 1.4, n_ghost)], axis=1).astype(np.float32)
    return np.concatenate([pts, ghosts], axis=0), gt, meta


# ---------------------------------------------------------------------------
# "kitti3" profile: full-LiDAR-scale 3-class scenes (Car / Pedestrian /
# Cyclist) for configs/kitti_3class.yaml — 69 m x 79 m range, 1/r-thinned
# ground returns, box-shell cars, two-wheel + leaning-rider cyclists,
# yaw-aware pedestrians, distance-stratified difficulty via a KITTI-like
# pinhole (f=721) so the 40/25/25 px height gates actually stratify over
# the 69 m range. All objects are yaw-rotated with front/back asymmetry
# (cars: windshield slope; cyclists: rider lean) so heading sign is
# learnable (same rationale as _pedestrian_points).
# ---------------------------------------------------------------------------

_KITTI_F = 721.0   # px, the real KITTI P2 focal
_KITTI_CX = 609.0
_KITTI_CY = 172.0
_KITTI_IMG = (1242.0, 375.0)
_KITTI_GROUND = -1.7


def _rot_into_world(lx, ly, box):
    """Local (+x = forward) offsets -> world, box-corner yaw convention."""
    x, y = box[0], box[1]
    c, s = np.cos(box[6]), np.sin(box[6])
    return x + lx * c + ly * s, y - lx * s + ly * c


def _car_points(rng, box, n):
    """Box-shell car: roof + sides + a sloped windshield (front/back
    asymmetry). Surfaces, not volume — a LiDAR sees the skin."""
    x, y, z, w, l, h, r = box
    face = rng.randint(0, 4, n)  # 0 roof, 1 left, 2 right, 3 hood/shield
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    lx = np.where(face == 3, (0.25 + 0.25 * (v + 0.5)) * l, u * l)
    ly = np.where(face == 0, v * w,
                  np.where(face == 1, -w / 2, np.where(face == 2, w / 2,
                                                       v * w * 0.9)))
    lz = np.where(face == 0, h * 0.95,
                  np.where(face == 3, h * (0.9 - 0.5 * (v + 0.5)),
                           (v + 0.5) * h * 0.85))
    wx, wy = _rot_into_world(lx, ly, box)
    pts = np.stack([wx, wy, z + lz], axis=1).astype(np.float32)
    pts[:, :2] += rng.normal(0, 0.03, (n, 2))
    return pts


def _cyclist_points(rng, box, n):
    """Two wheels in the local x-z plane + a rider blob leaning forward."""
    x, y, z, w, l, h, r = box
    kind = rng.uniform(0, 1, n)
    wheel = kind < 0.4
    ang = rng.uniform(-np.pi, np.pi, n)
    wheel_cx = np.where(rng.uniform(0, 1, n) < 0.5, 0.3, -0.3) * l
    lx = np.where(wheel, wheel_cx + 0.3 * l * np.cos(ang), 0.0)
    lz = np.where(wheel, 0.3 * l * (1 + np.sin(ang)),
                  h * (0.45 + 0.5 * rng.uniform(0, 1, n)))
    # rider torso leans over the handlebars: forward offset grows with z
    lx = np.where(~wheel, 0.15 * l * (lz / max(h, 1e-3)), lx)
    ly = rng.normal(0, w * 0.18, n)
    wx, wy = _rot_into_world(lx, ly, box)
    pts = np.stack([wx, wy, z + np.clip(lz, 0, h)], axis=1)
    pts[:, :2] += rng.normal(0, 0.02, (n, 2))
    return pts.astype(np.float32)


def _kitti_background(rng, n=45000):
    """Ground plane with 1/r-thinned returns + far walls/buildings."""
    n_g = int(n * 0.8)
    # p(r) ~ 1/r: exponential of uniform over log-range
    r = 2.0 * (69.0 / 2.0) ** rng.uniform(0, 1, n_g)
    a = rng.uniform(-np.pi / 2, np.pi / 2, n_g)  # forward cone
    pts = np.zeros((n, 3), dtype=np.float32)
    pts[:n_g, 0] = r * np.cos(a)
    pts[:n_g, 1] = np.clip(r * np.sin(a), -39.5, 39.5)
    pts[:n_g, 2] = rng.normal(_KITTI_GROUND, 0.04, n_g)
    n_w = n - n_g
    side = rng.randint(0, 2, n_w) * 2 - 1
    pts[n_g:, 0] = rng.uniform(5.0, 69.0, n_w)
    pts[n_g:, 1] = side * rng.uniform(12.0, 39.5, n_w)
    pts[n_g:, 2] = rng.uniform(_KITTI_GROUND, 2.5, n_w)
    return pts


_KITTI_CLASSES = ("Car", "Pedestrian", "Cyclist")


def _kitti_box(rng, name, dist, ang):
    x = dist * np.cos(ang)
    y = np.clip(dist * np.sin(ang), -39.0, 39.0)
    if name == "Car":
        dims = (rng.uniform(1.55, 1.9), rng.uniform(3.6, 4.6),
                rng.uniform(1.4, 1.7))
    elif name == "Pedestrian":
        dims = (rng.uniform(0.5, 0.7), rng.uniform(0.6, 1.0),
                rng.uniform(1.5, 1.9))
    else:
        dims = (rng.uniform(0.5, 0.7), rng.uniform(1.6, 1.9),
                rng.uniform(1.6, 1.8))
    return np.array([x, y, _KITTI_GROUND, *dims,
                     rng.uniform(-np.pi, np.pi)], dtype=np.float32)


def make_scene_kitti(rng, max_cars: int = 10, max_peds: int = 5,
                     max_cyc: int = 3):
    """Returns (points [N,4] lidar incl. intensity, gt_boxes [K,7],
    names [K], meta list for the KITTI label line)."""
    objs = []  # (name, box)
    counts = {"Car": rng.randint(1, max_cars + 1),
              "Pedestrian": rng.randint(0, max_peds + 1),
              "Cyclist": rng.randint(0, max_cyc + 1)}
    for name, cnt in counts.items():
        for _ in range(cnt):
            for _try in range(30):
                dist = 3.0 + 63.0 * rng.uniform(0, 1) ** 1.4
                box = _kitti_box(rng, name,
                                 dist, rng.uniform(-0.7, 0.7))
                if not objs or np.all(np.linalg.norm(
                        np.array([b[:2] for _, b in objs]) - box[:2],
                        axis=1) > (4.0 if name == "Car" else 1.5)):
                    break
            objs.append((name, box))

    pts_all = [_kitti_background(rng)]
    names, gt, meta = [], [], []
    # disc radius from the WIDTH: a disc of the full car length over-shadows
    # (a rectangle seen end-on is narrow); width keeps the occlusion-label
    # histogram spread over 0/1/2 instead of saturating at 2
    occluders = [(b[0], b[1], b[3] * 0.5) for _, b in objs]
    for oi, (name, b) in enumerate(objs):
        dist = float(np.hypot(b[0], b[1]))
        area = 2 * (b[3] + b[4]) * b[5] + b[3] * b[4]
        n = max(int(900 * area / max(dist / 8.0, 1.0) ** 2), 4)
        n = min(n, 4000)
        if name == "Car":
            raw = _car_points(rng, b, n)
        elif name == "Pedestrian":
            raw = _pedestrian_points(rng, b, n=n)
        else:
            raw = _cyclist_points(rng, b, n)
        raw[:, :2] += rng.normal(0, 0.002 * dist, (len(raw), 2))
        raw = _front_surface_cull(rng, raw, b[:2], keep_back=0.15)
        # shadows from OTHER, nearer objects only
        occ = [o for j, o in enumerate(occluders)
               if j != oi and np.hypot(o[0], o[1]) < dist]
        vis = _shadow_mask(raw, occ)
        leak = rng.uniform(0.15, 0.6)
        kept = raw[vis | (rng.uniform(0, 1, len(raw)) < leak)]
        occ_frac = 1.0 - len(kept) / max(len(raw), 1)
        pts_all.append(kept)
        # KITTI-like pinhole bbox (camera z == lidar x): height gates
        # 40/25/25 px stratify at ~28 m / ~45 m for a 1.56 m car
        depth = max(b[0], 1.0)
        h_px = _KITTI_F * b[5] / depth
        w_px = _KITTI_F * max(b[3], b[4]) / depth
        cx_px = _KITTI_CX + _KITTI_F * (-b[1]) / depth
        cy_px = _KITTI_CY
        x1, y1 = cx_px - w_px / 2, cy_px - h_px / 2
        x2, y2 = cx_px + w_px / 2, cy_px + h_px / 2
        cx1, cy1 = max(x1, 0.0), max(y1, 0.0)
        cx2, cy2 = min(x2, _KITTI_IMG[0]), min(y2, _KITTI_IMG[1])
        full = max((x2 - x1) * (y2 - y1), 1e-6)
        clipped = max(cx2 - cx1, 0.0) * max(cy2 - cy1, 0.0)
        names.append(name)
        gt.append(b)
        meta.append(dict(
            truncated=float(np.clip(1.0 - clipped / full, 0.0, 1.0)),
            occluded=0 if occ_frac < 0.25 else (1 if occ_frac < 0.6 else 2),
            bbox=(cx1, cy1, max(cx2, cx1 + 1.0), max(cy2, cy1 + 1.0))))

    pts = np.concatenate(pts_all, axis=0).astype(np.float32)
    pts = pts[rng.uniform(0, 1, len(pts)) > 0.03]  # sensor dropout
    intensity = rng.uniform(0.0, 1.0, (len(pts), 1)).astype(np.float32)
    return (np.concatenate([pts, intensity], axis=1),
            np.array(gt, dtype=np.float32).reshape(-1, 7),
            np.array(names), meta)


def _write_calib(path):
    p = " ".join(["0"] * 12)
    pr = " ".join(str(v) for v in np.eye(3, 4).reshape(-1))
    r0 = " ".join(str(v) for v in np.eye(3).reshape(-1))
    v2c = " ".join(str(v) for v in VELO2CAM[:3].reshape(-1))
    imu = " ".join(["0"] * 12)
    pathlib.Path(path).write_text(
        f"P0: {pr}\nP1: {pr}\nP2: {pr}\nP3: {pr}\nR0_rect: {r0}\n"
        f"Tr_velo_to_cam: {v2c}\nTr_imu_to_velo: {imu}\n")


def generate_dataset(root: str, num_train: int = 32, num_test: int = 8,
                     seed: int = 0, max_peds: int = 3,
                     profile: str = "easy") -> str:
    """Create a full reference-format dataset under ``root``. Returns root.

    ``profile``: "easy" (dense, unoccluded — hermetic plumbing tests),
    "hard" (the round-2 AP benchmark: see make_scene_hard), or "kitti3"
    (full-LiDAR-scale 3-class scenes for configs/kitti_3class.yaml)."""
    rng = np.random.RandomState(seed)
    rootp = pathlib.Path(root)
    for sub, count, training in (("training", num_train, True),
                                 ("testing", num_test, False)):
        for d in ("velodyne", "label_2", "calib"):
            (rootp / sub / d).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            sid = "%06d" % i
            names = None
            if profile == "hard":
                points, gt, meta = make_scene_hard(
                    rng, max_peds if max_peds != 3 else 5)
            elif profile == "kitti3":
                points, gt, names, meta = make_scene_kitti(rng)
            else:
                points, gt = make_scene(rng, max_peds)
                meta = None
            # Emit points in randomized order, like a real sensor sweep's
            # azimuth interleave. The generators build scenes as
            # background-then-objects BLOCKS; stored that way, the
            # voxelizer's first-come-first-kept max_voxels cap (a
            # load-bearing reference quirk, load_data.py:631-640) exhausts
            # on background before reaching a single object point on
            # unshuffled eval reads — measured 0% of kitti3 GT reachable
            # at eval vs 98% on (shuffled) train batches with the same
            # checkpoint (scripts/diag_train_eval_gap.py, round 5).
            points = points[rng.permutation(len(points))]
            with open(rootp / sub / "velodyne" / f"{sid}.pkl", "wb") as f:
                pickle.dump(points, f, 2)
            _write_kitti_label(rootp / sub / "label_2" / f"{sid}.txt", gt,
                               meta, names)
            _write_calib(rootp / sub / "calib" / f"{sid}.txt")

    ki.create_info_file(root, list(range(num_train)), training=True,
                        filename="kitti_infos_train.pkl")
    # eval infos point at the testing split
    infos_val = ki.get_image_infos(root, list(range(num_test)), training=False)
    ki.calculate_num_points_in_gt(root, infos_val)
    with open(rootp / "kitti_infos_val.pkl", "wb") as f:
        pickle.dump(infos_val, f, 2)
    classes = (["Car", "Pedestrian", "Cyclist"] if profile == "kitti3"
               else ["Pedestrian"])
    ki.create_groundtruth_database(root, used_classes=classes)
    return root


def split_checksum(root: str, split: str = "testing") -> str:
    """sha256 over every file of one split of a generated dataset (relative
    path and bytes, in path order): two datasets with the same checksum hold
    the same clouds, labels and calibrations. Not in the JAX package; the
    port's accuracy check uses it to say which data an AP belongs to."""
    import hashlib

    h = hashlib.sha256()
    base = pathlib.Path(root) / split
    for path in sorted(p for p in base.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(base)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()
