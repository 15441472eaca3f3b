"""Host input pipeline: dataset -> augment -> padded dense batches -> device
prefetch.

Replaces the reference's dataLoader/tf.data generator (load_data.py:1944-3116)
with a plain-Python pipeline that ships PADDED STATIC-SHAPE batches; the
irregular work (augmentation) stays on the host, while voxelization, the
anchors mask and target assignment — host numpy in the reference — run inside
the jitted step (see train/loop.py).

Batch layout (see train/loop.py):
    points [B, MAXPTS, 3] f32, num_points [B] i32,
    gt_boxes [B, G, 7] f32 (padding rows dims=1), gt_classes [B, G] i32,
    gt_valid [B, G] bool, rect/trv2c/p2 [B, 4, 4] f32,
    image_idx [B] i32, image_shape [B, 2] i32
"""

from __future__ import annotations

import pickle
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from pillars_torch.config import Config, InputReaderConfig
from pillars_torch.data import augment as aug
from pillars_torch.data.sampler import DataBaseSampler
from pillars_torch.geometry import np_boxes as nb


class PedestrianDataset:
    """One sample = one pointcloud + annotations, reference-format infos.

    reference dataLoader.__getitem__ + prep_pointcloud
    (load_data.py:2404-3116), minus voxelization/anchors/targets (on device
    now)."""

    def __init__(self, cfg: Config, reader: InputReaderConfig, training: bool,
                 sampler: Optional[DataBaseSampler] = None,
                 rng: Optional[np.random.RandomState] = None,
                 debug_publisher=None):
        self.cfg = cfg
        self.reader = reader
        self.training = training
        self.sampler = sampler
        self.rng = rng or np.random.RandomState()
        # debug_save_points equivalent: publish every augmentation stage
        # (reference load_data.py:2659-2825); pass a viz Publisher
        self.debug_publisher = debug_publisher
        # no_annos_mode: evaluate a dataset that has no labels — infos come
        # from the dedicated no-annotation list and per-item annos are
        # replaced with an empty dummy (reference load_data.py:1983, :2411)
        info_path = reader.info_path
        if (not training and reader.no_annos_mode
                and reader.no_annos_info_path):
            info_path = reader.no_annos_info_path
        with open(info_path, "rb") as f:
            self.infos: List[Dict] = pickle.load(f)
        self.root = reader.dataset_root
        self.desired = list(reader.desired_objects)
        self.max_points = cfg.model.voxel.max_points
        self.max_gt = cfg.model.target.max_gt_boxes
        self.num_features = cfg.model.num_point_features
        self.pcr = np.asarray(cfg.model.voxel.point_cloud_range)

    def __len__(self):
        return len(self.infos)

    # ------------------------------------------------------------------
    def _load_points(self, info) -> np.ndarray:
        path = f"{self.root}/{info['velodyne_path']}"
        nf = self.num_features
        if path.endswith(".bin"):
            raw = np.fromfile(path, dtype=np.float32).reshape(
                -1, info.get("pointcloud_num_features", 4))
        else:
            with open(path[:-3] + "pkl", "rb") as f:
                raw = np.asarray(pickle.load(f, encoding="latin1"),
                                 dtype=np.float32)
        if raw.shape[1] < nf:  # pad missing features (e.g. no intensity)
            raw = np.concatenate(
                [raw, np.zeros((len(raw), nf - raw.shape[1]), np.float32)], 1)
        return raw[:, :nf]

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        points = self._load_points(info).copy()
        rect = info["calib/R0_rect"].astype(np.float32)
        trv2c = info["calib/Tr_velo_to_cam"].astype(np.float32)
        p2 = info["calib/P2"].astype(np.float32)
        annos = info.get("annos")
        if annos is None:  # no_annos_mode dummy (load_data.py:2411-2413)
            if self.training:
                raise KeyError(
                    f"info for frame {info.get('image_idx')} has no 'annos' "
                    "— training on an unlabeled info file would silently "
                    "fit background only; no_annos_mode is eval-only")
            gt_names = np.array([], dtype="<U16")
            gt_boxes = np.zeros((0, 7), np.float32)
        else:
            keep = np.array([n in self.desired for n in annos["name"]],
                            dtype=bool)
            loc = annos["location"][keep]
            dims = annos["dimensions"][keep]
            rots = annos["rotation_y"][keep]
            gt_names = annos["name"][keep]
            gt_boxes_cam = np.concatenate(
                [loc, dims, rots[..., np.newaxis]], axis=1).astype(np.float32)
            gt_boxes = nb.box_camera_to_lidar(gt_boxes_cam, rect, trv2c)

        if self.training:
            gt_boxes, gt_names, points = self._augment(gt_boxes, gt_names,
                                                       points)
        gt_classes = np.array(
            [self.desired.index(n) + 1 for n in gt_names], dtype=np.int32)

        return self._pack(points, gt_boxes, gt_classes, rect, trv2c, p2,
                          int(info["image_idx"]),
                          np.asarray(info.get("img_shape", (800, 1280)),
                                     dtype=np.int32))

    # ------------------------------------------------------------------
    def _debug_publish(self, stage, points, gt_boxes):
        if self.debug_publisher is None:
            return
        from pillars_torch.viz import BoxArray

        self.debug_publisher.publish_points(f"debug_{stage}_points", points)
        self.debug_publisher.publish_boxes(
            f"debug_{stage}_boxes", BoxArray.from_boxes7(gt_boxes))

    def _augment(self, gt_boxes, gt_names, points):
        """reference prep_pointcloud training branch (load_data.py:2620-2870)."""
        acfg = self.reader.augment
        scfg = self.reader.sampler
        rng = self.rng
        gt_boxes_mask = np.ones(len(gt_boxes), dtype=bool)
        self._debug_publish("input", points, gt_boxes)

        if acfg.enabled and self.sampler is not None:
            # the reference's `while` loop retries sampling until the scene
            # has >= 1 object (reference load_data.py:2706) and can spin
            # forever on a degenerate gt-database; we bound it at 20 tries
            # (each try is an independent random draw, so P(all-empty) is
            # astronomically small on any sane database). If all fail, a
            # zero-GT scene reaches the loss, which is well-defined here:
            # prepare_loss_weights clamps the positive normalizer at 1 and
            # the scene contributes background-classification signal only
            # (tested: tests/test_data.py::test_zero_gt_scene_loss_defined).
            for _ in range(20):
                sampled = self.sampler.sample_all(
                    self.root, gt_boxes, gt_names, points,
                    scfg.sample_classes, scfg.sample_max_nums)
                if sampled is not None:
                    points = np.concatenate([sampled["points"], points], axis=0)
                    gt_names = np.concatenate([gt_names, sampled["gt_names"]])
                    gt_boxes = np.concatenate([gt_boxes, sampled["gt_boxes"]])
                    gt_boxes_mask = np.concatenate(
                        [gt_boxes_mask, sampled["gt_masks"]])
                if len(gt_boxes) > 0:
                    break

        self._debug_publish("samples_added", points, gt_boxes)
        if acfg.enabled:
            aug.noise_per_object(gt_boxes, points, gt_boxes_mask, acfg, rng)
        gt_boxes = gt_boxes[gt_boxes_mask]
        gt_names = gt_names[gt_boxes_mask]
        self._debug_publish("object_noise", points, gt_boxes)

        if acfg.enabled:
            gt_boxes, points = aug.random_flip(
                gt_boxes, points, acfg.random_flip_probability, rng)
            gt_boxes, points = aug.global_rotation(
                gt_boxes, points, acfg.global_rotation_noise, rng)
            gt_boxes, points = aug.global_scaling(
                gt_boxes, points, *acfg.global_scaling_noise, rng=rng)
            gt_boxes, points = aug.global_translate(
                gt_boxes, points, acfg.global_loc_noise_std, rng)

        gt_boxes[:, 6] = nb.limit_period(gt_boxes[:, 6], offset=0.5,
                                         period=2 * np.pi)
        rng.shuffle(points)
        mask = nb.filter_gt_box_outside_range_by_center(
            gt_boxes, self.pcr[[0, 1, 3, 4]])
        self._debug_publish("global_transforms", points, gt_boxes[mask])
        return gt_boxes[mask], gt_names[mask], points

    # ------------------------------------------------------------------
    def _pack(self, points, gt_boxes, gt_classes, rect, trv2c, p2, image_idx,
              image_shape) -> Dict[str, np.ndarray]:
        n = min(len(points), self.max_points)
        pts = np.zeros((self.max_points, self.num_features), dtype=np.float32)
        pts[:n] = points[:n, :self.num_features]
        g = min(len(gt_boxes), self.max_gt)
        gtb = np.zeros((self.max_gt, 7), dtype=np.float32)
        gtb[:, 3:6] = 1.0  # benign pad dims (log-encode safe)
        gtb[:g] = gt_boxes[:g]
        gtc = np.zeros((self.max_gt,), dtype=np.int32)
        gtc[:g] = gt_classes[:g]
        gtv = np.zeros((self.max_gt,), dtype=bool)
        gtv[:g] = True
        return dict(points=pts, num_points=np.int32(n), gt_boxes=gtb,
                    gt_classes=gtc, gt_valid=gtv, rect=rect, trv2c=trv2c,
                    p2=p2, image_idx=np.int32(image_idx),
                    image_shape=image_shape)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class BatchIterator:
    """Epoch iterator with background workers + device prefetch.

    Replaces tf.data.from_generator + prefetch(AUTOTUNE)
    (reference load_data.py:2154-2398). With num_workers > 1, samples of a
    batch are built concurrently; the shared augmentation RandomState then
    interleaves across threads, so exact augmentation reproducibility needs
    num_workers=1 (batch CONTENTS and order stay deterministic either way)."""

    def __init__(self, dataset: PedestrianDataset, batch_size: int,
                 shuffle: bool, num_workers: int = 2, prefetch_depth: int = 2,
                 device_put_fn=None, drop_remainder: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.device_put_fn = device_put_fn
        self.drop_remainder = drop_remainder
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_remainder and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_remainder:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(
                            lambda i: self.dataset[int(i)], idxs))
                        batch = collate(samples)
                        if self.device_put_fn is not None:
                            batch = self.device_put_fn(batch)
                        q.put(batch)
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
