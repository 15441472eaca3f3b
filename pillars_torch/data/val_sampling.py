"""Create an augmented validation dataset ("sample_val_dataset_mode"); a
copy of pillars_tpu/data/val_sampling.py.

The reference builds its eval set by running the TRAINING augmentation
(GT-database sampling + noise) over the test split once, saving the
augmented clouds to testing/velodyne_sampled/ and writing an updated info
file kitti_infos_val_sampled.pkl whose annos reflect the augmented boxes
(reference load_data.py:2889-2957 + create_data.py mode='test_real').
This reproduces that flow.
"""

from __future__ import annotations

import copy
import pathlib
import pickle

import numpy as np

from pillars_torch.config import Config
from pillars_torch.data.pipeline import PedestrianDataset
from pillars_torch.data.sampler import DataBaseSampler
from pillars_torch.geometry import np_boxes as nb


def create_sampled_val_dataset(cfg: Config, val_info_path: str,
                               out_info_name: str = "kitti_infos_val_sampled.pkl",
                               out_dir_name: str = "velodyne_sampled",
                               seed: int = 0) -> str:
    """Augment every frame of the val split once; save clouds + infos."""
    root = pathlib.Path(cfg.train_input.dataset_root)
    rng = np.random.RandomState(seed)
    sampler = None
    if cfg.train_input.sampler.info_path:
        sampler = DataBaseSampler(cfg.train_input.sampler.info_path,
                                  cfg.train_input.sampler, rng=rng)

    # a dataset over the val infos but with the TRAINING reader config
    reader = cfg.train_input
    with open(val_info_path, "rb") as f:
        val_infos = pickle.load(f)

    ds = PedestrianDataset(cfg, reader, training=True, sampler=sampler,
                           rng=rng)
    ds.infos = val_infos

    out_dir = root / "testing" / out_dir_name
    out_dir.mkdir(parents=True, exist_ok=True)
    new_infos = []
    for i, info in enumerate(val_infos):
        info = copy.deepcopy(info)
        points = ds._load_points(info).copy()
        rect = info["calib/R0_rect"].astype(np.float32)
        trv2c = info["calib/Tr_velo_to_cam"].astype(np.float32)
        annos = info["annos"]
        keep = np.array([n in ds.desired for n in annos["name"]], dtype=bool)
        gt_cam = np.concatenate(
            [annos["location"][keep], annos["dimensions"][keep],
             annos["rotation_y"][keep][..., None]], axis=1).astype(np.float32)
        gt_boxes = nb.box_camera_to_lidar(gt_cam, rect, trv2c)
        gt_names = annos["name"][keep]

        gt_boxes, gt_names, points = ds._augment(gt_boxes, gt_names, points)

        sid = "%06d" % int(info["image_idx"])
        with open(out_dir / f"{sid}.pkl", "wb") as f:
            pickle.dump(np.asarray(points, dtype=np.float32), f, 2)
        info["velodyne_path"] = f"testing/{out_dir_name}/{sid}.pkl"

        # rebuild annos in camera coords from the augmented boxes
        # (reference load_data.py:2899-2956)
        gt_camera = nb.box_lidar_to_camera(gt_boxes, rect, trv2c)
        n = len(gt_boxes)
        if len(points):
            num_in = nb.points_in_rbbox(points[:, :3], gt_boxes).sum(0)
        else:
            num_in = np.zeros(n)
        info["annos"] = {
            "name": np.array(list(gt_names)),
            "truncated": np.zeros(n),
            "occluded": np.zeros(n, dtype=np.int64),
            "alpha": np.array([
                -np.arctan2(-b[1], b[0]) + c[6]
                for b, c in zip(gt_boxes, gt_camera)]),
            "bbox": np.tile([300.0, 150.0, 400.0, 350.0], (n, 1)),
            "dimensions": gt_camera[:, 3:6] if n else np.zeros((0, 3)),
            "location": gt_camera[:, :3] if n else np.zeros((0, 3)),
            "rotation_y": gt_camera[:, 6] if n else np.zeros((0,)),
            "difficulty": np.zeros(n, dtype=np.int32),
            "index": np.arange(n, dtype=np.int32),
            "group_ids": np.arange(n, dtype=np.int32),
            "num_points_in_gt": num_in.astype(np.int32),
            "score": np.zeros(n),
        }
        new_infos.append(info)

    out_path = root / out_info_name
    with open(out_path, "wb") as f:
        pickle.dump(new_infos, f, 2)
    return str(out_path)
