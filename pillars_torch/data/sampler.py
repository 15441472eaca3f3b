"""GT-database sampler: paste stored pedestrian point crops into scenes.

reference load_data.py:1344-1467 (BatchSampler + DataBaseSamplerV2) and
load_data.py:1690-1921 (sample_all).
"""

from __future__ import annotations

import math
import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from pillars_torch.config import SamplerConfig
from pillars_torch.geometry import np_boxes as nb


class BatchSampler:
    """Shuffled epoch-based sampling of db entries, plus the reference's
    distance-dependent x/y translation noise applied once at load
    (reference load_data.py:1344-1408)."""

    def __init__(self, sampled_list: List[Dict], name: str,
                 cfg: SamplerConfig, shuffle: bool = True,
                 rng: Optional[np.random.RandomState] = None):
        self._sampled_list = sampled_list
        self._rng = rng or np.random.RandomState()
        self._indices = np.arange(len(sampled_list))
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0
        self._example_num = len(sampled_list)
        self._name = name
        self._shuffle = shuffle
        self._cfg = cfg
        self.random_translate()

    def _sample(self, num: int) -> np.ndarray:
        if self._idx + num >= self._example_num:
            ret = self._indices[self._idx:].copy()
            self._reset()
        else:
            ret = self._indices[self._idx:self._idx + num]
            self._idx += num
        return ret

    def _reset(self):
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0

    def sample(self, num: int) -> List[Dict]:
        return [self._sampled_list[i] for i in self._sample(num)]

    def random_translate(self):
        """Scatter the cached sample positions: closer samples translated
        toward the camera, farther ones away (reference
        load_data.py:1391-1408)."""
        cfg = self._cfg
        for i, sample in enumerate(self._sampled_list):
            x_dist = sample["box3d_lidar"][0]
            noise_x = (cfg.noise_x_closer if x_dist < cfg.noise_x_point
                       else cfg.noise_x_farther)
            loc = np.zeros(len(sample["box3d_lidar"]))
            loc[0] = self._rng.uniform(noise_x[0], noise_x[1])
            loc[1] = self._rng.uniform(cfg.noise_y[0], cfg.noise_y[1])
            self._sampled_list[i]["box3d_lidar"] = sample["box3d_lidar"] + loc


class DataBaseSampler:
    """reference DataBaseSamplerV2 (load_data.py:1411-1467): load dbinfos,
    filter difficulties / min points, hold one BatchSampler per class."""

    def __init__(self, info_path: str, cfg: SamplerConfig,
                 rng: Optional[np.random.RandomState] = None):
        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        removed = set(cfg.removed_difficulties)
        db_infos = {
            k: [i for i in v if i["difficulty"] not in removed]
            for k, v in db_infos.items()
        }
        for name, min_num in dict(cfg.min_points_filter).items():
            if min_num > 0 and name in db_infos:
                db_infos[name] = [i for i in db_infos[name]
                                  if i["num_points_in_gt"] >= min_num]
        self.db_infos = db_infos
        self.cfg = cfg
        self._rng = rng or np.random.RandomState()
        self._sampler_dict = {
            k: BatchSampler(v, k, cfg, rng=self._rng)
            for k, v in db_infos.items()
        }

    # ------------------------------------------------------------------
    def sample_all(self, root_path: str, gt_boxes: np.ndarray,
                   gt_names: np.ndarray, points: np.ndarray,
                   sample_classes: Sequence[str],
                   sample_max_nums: Sequence[int],
                   num_point_features: int = 3) -> Optional[Dict]:
        """Draw samples, reject 2D collisions with gt + each other, then gate
        each on point-overlap with the scene
        (reference sample_all, load_data.py:1690-1921)."""
        cfg = self.cfg
        rng = self._rng
        sample_num_per_class = []
        for class_name, max_num in zip(sample_classes, sample_max_nums):
            n = int(max_num - np.sum([x == class_name for x in gt_names]))
            sample_num_per_class.append(n)

        sampled: List[Dict] = []
        sampled_gt_boxes = []
        avoid_coll_boxes = gt_boxes
        for class_name, num in zip(sample_classes, sample_num_per_class):
            if num <= 0 or class_name not in self._sampler_dict:
                continue
            cand = self._sampler_dict[class_name].sample(num)
            if not cand:
                continue
            num_gt = avoid_coll_boxes.shape[0]
            gt_bv = nb.center_to_corner_box2d(
                avoid_coll_boxes[:, 0:2], avoid_coll_boxes[:, 3:5],
                avoid_coll_boxes[:, 6])
            sp_boxes = np.stack([c["box3d_lidar"] for c in cand], axis=0)
            sp_bv = nb.center_to_corner_box2d(
                sp_boxes[:, 0:2], sp_boxes[:, 3:5], sp_boxes[:, 6])
            total_bv = np.concatenate([gt_bv, sp_bv], axis=0)
            coll_mat = nb.box_collision_test(total_bv, total_bv)
            diag = np.arange(total_bv.shape[0])
            coll_mat[diag, diag] = False
            valid_samples = []
            for i in range(num_gt, num_gt + len(cand)):
                if coll_mat[i].any():
                    coll_mat[i] = False
                    coll_mat[:, i] = False
                else:
                    valid_samples.append(cand[i - num_gt])
            sampled += valid_samples
            if valid_samples:
                boxes = np.stack([s["box3d_lidar"] for s in valid_samples],
                                 axis=0)
                sampled_gt_boxes.append(boxes)
                avoid_coll_boxes = np.concatenate(
                    [avoid_coll_boxes, boxes], axis=0)

        if not sampled:
            return None
        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)

        s_points_list = []
        kept: List[Dict] = []
        kept_boxes = []
        for i, info in enumerate(sampled):
            path = pathlib.Path(root_path) / info["path"]
            pkl_path = (str(path) if str(path).endswith(".pkl")
                        else str(path)[:-3] + "pkl")
            with open(pkl_path, "rb") as f:
                s_points = pickle.load(f, encoding="latin1")

            # point-overlap gate (reference load_data.py:1843-1852): the
            # sample must not sit on top of existing scene structure, and
            # must overlap at least min points (or be close with 1/8 prob)
            gt_coords = np.array(info["box3d_lidar"])[np.newaxis, :]
            if len(points) > 0:
                num_in = int(nb.points_in_rbbox(points, gt_coords).sum())
            else:
                num_in = 0
            dist = math.sqrt(info["box3d_lidar"][0] ** 2
                             + info["box3d_lidar"][1] ** 2)
            low_likelihood = bool(rng.randint(2) and rng.randint(2)
                                  and rng.randint(2))
            accept = (num_in < cfg.max_point_collision
                      and (num_in >= cfg.min_point_collision
                           or (dist < 2.5 and low_likelihood))
                      and len(s_points) > 0)
            if accept:
                s_points = s_points.copy()
                s_points[:, :3] += info["box3d_lidar"][:3]
                s_points_list.append(s_points)
                kept.append(info)
                kept_boxes.append(sampled_gt_boxes[i])

        if not kept:
            return None
        return {
            "gt_names": np.array([s["name"] for s in kept]),
            "difficulty": np.array([s["difficulty"] for s in kept]),
            "gt_boxes": np.array(kept_boxes),
            "points": np.concatenate(s_points_list, axis=0),
            "gt_masks": np.ones((len(kept),), dtype=bool),
        }
