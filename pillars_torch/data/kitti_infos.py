"""Offline data prep: KITTI-format info files + ground-truth database.

Replaces the reference's create_data.py (553 LoC) + second/data/kitti_common.py
(748 LoC). Produces the same artifacts with the same keys so the rest of the
pipeline (and any existing dataset prepared with the reference) interoperates:

- ``kitti_infos_*.pkl``: list of per-frame dicts with keys 'image_idx',
  'velodyne_path', 'img_path', 'img_shape', 'calib/P0..P3', 'calib/R0_rect',
  'calib/Tr_velo_to_cam', 'calib/Tr_imu_to_velo', 'annos' (reference
  kitti_common.py:139-275).
- ``gt_database/<idx>_<class>_<i>.pkl`` + ``kitti_dbinfos_*.pkl``:
  per-object point crops centered at the box origin (reference
  create_data.py:365-551).

Pointclouds are pickled float32 [N, 3] arrays (custom_dataset=True path,
reference create_data.py:44-46).
"""

from __future__ import annotations

import pathlib
import pickle
from concurrent import futures
from typing import Dict, List, Optional, Sequence

import numpy as np

from pillars_torch.geometry import np_boxes as nb


def get_label_anno(label_path: str) -> Dict[str, np.ndarray]:
    """Parse one KITTI label file (reference kitti_common.py:632-675).

    KITTI file stores dims as (h, w, l); annos store camera (l, h, w)."""
    annotations = {}
    with open(label_path, "r") as f:
        lines = f.readlines()
    content = [line.strip().split(" ") for line in lines if line.strip()]
    num_objects = len([x[0] for x in content if x[0] != "DontCare"])
    annotations["name"] = np.array([x[0] for x in content])
    num_gt = len(annotations["name"])
    annotations["truncated"] = np.array([float(x[1]) for x in content])
    annotations["occluded"] = np.array([int(float(x[2])) for x in content])
    annotations["alpha"] = np.array([float(x[3]) for x in content])
    annotations["bbox"] = np.array(
        [[float(i) for i in x[4:8]] for x in content]).reshape(-1, 4)
    annotations["dimensions"] = np.array(
        [[float(i) for i in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations["location"] = np.array(
        [[float(i) for i in x[11:14]] for x in content]).reshape(-1, 3)
    annotations["rotation_y"] = np.array(
        [float(x[14]) for x in content]).reshape(-1)
    if len(content) != 0 and len(content[0]) == 16:
        annotations["score"] = np.array([float(x[15]) for x in content])
    else:
        annotations["score"] = np.zeros((annotations["bbox"].shape[0],))
    index = list(range(num_objects)) + [-1] * (num_gt - num_objects)
    annotations["index"] = np.array(index, dtype=np.int32)
    annotations["group_ids"] = np.arange(num_gt, dtype=np.int32)
    return annotations


def anno_to_rbboxes(anno: Dict[str, np.ndarray]) -> np.ndarray:
    """Camera-frame rbboxes [N, 7] from an anno dict."""
    loc = anno["location"]
    dims = anno["dimensions"]
    rots = anno["rotation_y"]
    return np.concatenate([loc, dims, rots[..., np.newaxis]], axis=1)


def add_difficulty_to_annos(info: Dict) -> None:
    """KITTI easy/moderate/hard difficulty (reference kitti_common.py:539-590)."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    annos = info["annos"]
    bbox = annos["bbox"]
    height = bbox[:, 3] - bbox[:, 1]
    occlusion = annos["occluded"]
    truncation = annos["truncated"]
    n = len(annos["dimensions"])
    masks = []
    for lvl in range(3):
        masks.append(~((occlusion > max_occlusion[lvl])
                       | (height <= min_height[lvl])
                       | (truncation > max_trunc[lvl])))
    easy, moderate, hard = masks
    is_easy = easy
    is_moderate = np.logical_xor(easy, moderate)
    is_hard = np.logical_xor(hard, moderate)
    diff = np.full(n, -1, np.int32)
    diff[is_hard] = 2
    diff[is_moderate] = 1
    diff[is_easy] = 0
    annos["difficulty"] = diff


def _parse_calib(calib_path: str, extend: bool = True) -> Dict[str, np.ndarray]:
    with open(calib_path, "r") as f:
        lines = f.readlines()

    def mat(line, n):
        return np.array([float(v) for v in line.split(" ")[1:1 + n]])

    def ext(m):
        return np.concatenate(
            [m, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0) if extend else m

    out = {}
    for i, name in enumerate(["P0", "P1", "P2", "P3"]):
        out[f"calib/{name}"] = ext(mat(lines[i], 12).reshape(3, 4))
    r0 = mat(lines[4], 9).reshape(3, 3)
    rect = np.zeros((4, 4), dtype=r0.dtype)
    rect[3, 3] = 1.0
    rect[:3, :3] = r0
    out["calib/R0_rect"] = rect if extend else r0
    out["calib/Tr_velo_to_cam"] = ext(mat(lines[5], 12).reshape(3, 4))
    out["calib/Tr_imu_to_velo"] = ext(mat(lines[6], 12).reshape(3, 4))
    return out


def _load_points(path: str) -> np.ndarray:
    """Pointcloud loader: .pkl (custom d435i datasets) or .bin (KITTI)."""
    if str(path).endswith(".bin"):
        return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
    with open(str(path)[: -3] + "pkl", "rb") as f:
        return pickle.load(f, encoding="latin1")


def get_image_infos(data_path: str, image_ids: Sequence[int],
                    training: bool = True, relative_path: bool = True,
                    num_workers: int = 8,
                    img_shape=(800, 1280)) -> List[Dict]:
    """Per-frame info dicts (reference get_kitti_image_info,
    kitti_common.py:139-275; with_imageshape=False custom path)."""
    root = pathlib.Path(data_path)
    sub = "training" if training else "testing"

    def map_func(idx):
        sid = "%06d" % idx
        info = {"image_idx": idx, "pointcloud_num_features": 3}
        vel = f"{sub}/velodyne/{sid}.pkl"
        img = f"{sub}/image_2/{sid}.png"
        info["velodyne_path"] = vel if relative_path else str(root / vel)
        info["img_path"] = img if relative_path else str(root / img)
        info["img_shape"] = np.array(img_shape, dtype=np.int32)
        label_path = root / sub / "label_2" / f"{sid}.txt"
        info.update(_parse_calib(str(root / sub / "calib" / f"{sid}.txt")))
        info["annos"] = get_label_anno(str(label_path))
        add_difficulty_to_annos(info)
        return info

    with futures.ThreadPoolExecutor(num_workers) as ex:
        return list(ex.map(map_func, image_ids))


def remove_outside_points(points: np.ndarray, rect: np.ndarray,
                          trv2c: np.ndarray, p2: np.ndarray,
                          image_shape) -> np.ndarray:
    """Drop points outside the camera frustum defined by the image bounds.

    reference second/core/box_np_ops.py remove_outside_points, used by
    create_data.py:60-62/:458-460 for real KITTI data (custom d435i datasets
    skip it). Projects lidar points into the image plane via P2 and keeps
    those landing inside [0, w) x [0, h) in front of the camera."""
    cam = nb.lidar_to_camera(points[:, :3], rect, trv2c)
    in_front = cam[:, 2] > 0
    hom = np.concatenate([cam, np.ones((len(cam), 1), cam.dtype)], axis=1)
    img = hom @ p2.T
    z = np.where(np.abs(img[:, 2]) < 1e-6, 1e-6, img[:, 2])
    u = img[:, 0] / z
    v = img[:, 1] / z
    h, w = int(image_shape[0]), int(image_shape[1])
    keep = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return points[keep]


def calculate_num_points_in_gt(data_path: str, infos: List[Dict],
                               relative_path: bool = True,
                               remove_outside: bool = False) -> None:
    """Annotate infos with per-object point counts (reference
    create_data.py:28-93)."""
    root = pathlib.Path(data_path)
    for info in infos:
        v_path = (root / info["velodyne_path"]) if relative_path else info["velodyne_path"]
        points = _load_points(str(v_path))
        if remove_outside:
            points = remove_outside_points(
                points, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"],
                info["calib/P2"], info["img_shape"])
        annos = info["annos"]
        num_obj = len([n for n in annos["name"] if n != "DontCare"])
        gt_cam = anno_to_rbboxes(annos)[:num_obj]
        gt_lidar = nb.box_camera_to_lidar(
            gt_cam, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"])
        if num_obj > 0 and len(points) > 0:
            indices = nb.points_in_rbbox(points[:, :3], gt_lidar)
            num_points_in_gt = indices.sum(0)
        else:
            num_points_in_gt = np.zeros((num_obj,), dtype=np.int64)
        num_ignored = len(annos["dimensions"]) - num_obj
        annos["num_points_in_gt"] = np.concatenate(
            [num_points_in_gt, -np.ones([num_ignored])]).astype(np.int32)


def create_info_file(data_path: str, image_ids: Sequence[int],
                     save_path: Optional[str] = None, training: bool = True,
                     filename: str = "kitti_infos_train.pkl") -> str:
    """reference create_data.py:153-233 (mode='train' path)."""
    infos = get_image_infos(data_path, image_ids, training=training)
    calculate_num_points_in_gt(data_path, infos)
    out = pathlib.Path(save_path or data_path) / filename
    with open(out, "wb") as f:
        pickle.dump(infos, f, 2)
    return str(out)


def create_groundtruth_database(data_path: str,
                                info_path: Optional[str] = None,
                                used_classes: Optional[Sequence[str]] = None,
                                database_name: str = "gt_database",
                                dbinfo_name: str = "kitti_dbinfos_train.pkl",
                                relative_path: bool = True) -> str:
    """Extract per-object centered point crops (reference
    create_data.py:365-551)."""
    root = pathlib.Path(data_path)
    info_path = info_path or str(root / "kitti_infos_train.pkl")
    db_path = root / database_name
    db_path.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    all_db_infos: Dict[str, list] = {}
    group_counter = 0
    for info in infos:
        v_path = (root / info["velodyne_path"]) if relative_path else info["velodyne_path"]
        points = _load_points(str(v_path))
        image_idx = info["image_idx"]
        rect = info["calib/R0_rect"]
        trv2c = info["calib/Tr_velo_to_cam"]
        annos = info["annos"]
        names = annos["name"]
        difficulty = annos["difficulty"]
        gt_idxes = annos["index"]
        num_obj = int(np.sum(annos["index"] >= 0))
        if num_obj == 0:
            continue
        rbbox_lidar = nb.box_camera_to_lidar(
            anno_to_rbboxes(annos)[:num_obj], rect, trv2c)
        group_ids = annos.get("group_ids",
                              np.arange(len(names), dtype=np.int64))
        point_indices = nb.points_in_rbbox(points[:, :3], rbbox_lidar)
        group_dict = {}
        for i in range(num_obj):
            if used_classes is not None and names[i] not in used_classes:
                continue
            filename = f"{image_idx}_{names[i]}_{gt_idxes[i]}.pkl"
            gt_points = points[point_indices[:, i]].copy()
            gt_points[:, :3] -= rbbox_lidar[i, :3]
            with open(db_path / filename, "wb") as f:
                pickle.dump(np.array(gt_points), f, 2)
            db_info = {
                "name": names[i],
                "path": str(pathlib.Path(database_name) / filename),
                "image_idx": image_idx,
                "gt_idx": int(gt_idxes[i]),
                "box3d_lidar": rbbox_lidar[i],
                "num_points_in_gt": gt_points.shape[0],
                "difficulty": int(difficulty[i]),
            }
            lg = group_ids[i]
            if lg not in group_dict:
                group_dict[lg] = group_counter
                group_counter += 1
            db_info["group_id"] = group_dict[lg]
            all_db_infos.setdefault(names[i], []).append(db_info)
    out = root / dbinfo_name
    with open(out, "wb") as f:
        pickle.dump(all_db_infos, f)
    return str(out)
