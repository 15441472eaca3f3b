"""Seeded scene generators of the benchmark's traffic: a frozen copy of the
d435i "hard" profile (``make_scene_hard``) and the KITTI-scale 3-class
profile (``make_scene_kitti``) of ``pillars_torch/data/synthetic.py``.

A copy, so that a change to the program's generators cannot change what the
benchmark feeds it. NumPy only; every draw comes from the ``rng`` passed in.
Beyond the copy: ``make_scene_kitti``'s ``background`` (the program's
generator fixes it at 45000 points) and ``camera_frustum``, the crop to the
camera's view that KITTI's sweeps are served with; their defaults draw what
the program's generators draw.
"""

from __future__ import annotations

import numpy as np

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
                     max_cyc: int = 3, background: int = 45000):
    """Returns (points [N,4] lidar incl. intensity, gt_boxes [K,7],
    names [K], meta list for the KITTI label line). ``background``: the
    ground and wall points drawn before the objects' (the program's
    generator draws 45000)."""
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

    pts_all = [_kitti_background(rng, background)]
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


def camera_frustum(points: np.ndarray) -> np.ndarray:
    """The points that the kitti3 profile's camera sees: in front of it
    and projected inside its image by the profile's own pinhole (camera z
    is lidar x, as the labels' boxes take it). KITTI's sweeps are served
    cropped so (``pillars_torch/data/kitti_infos.py::remove_outside_points``
    with the real calibration)."""
    x = np.maximum(points[:, 0], 1e-6)
    u = _KITTI_CX + _KITTI_F * (-points[:, 1]) / x
    v = _KITTI_CY + _KITTI_F * (-points[:, 2]) / x
    keep = ((points[:, 0] > 0) & (u >= 0) & (u < _KITTI_IMG[0])
            & (v >= 0) & (v < _KITTI_IMG[1]))
    return points[keep]


CROPS = {"camera_frustum": camera_frustum}
