"""Offline evaluation: dataset -> inference on the device -> KITTI AP
(pillars_tpu/train/trainer.py::Evaluator; reference train.py:480-932,
evaluate). The ``Trainer`` of that module is not ported yet.
"""

from __future__ import annotations

import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pillars_torch.config import Config
from pillars_torch.data.pipeline import BatchIterator, PedestrianDataset
from pillars_torch.eval import kitti_ap
from pillars_torch.eval.predict_to_anno import (infos_to_gt_annos,
                                                predictions_to_annos)
from pillars_torch.eval.proxies import detection_quality_proxies
from pillars_torch.models.detector import HostFetch, PillarsDetector
from pillars_torch.utils.profiling import StageTimer

# what the inference function reads of a batch; the rest stays on the host
_DEVICE_KEYS = ("points", "num_points", "rect", "trv2c")


class Evaluator:
    """Batched offline eval: dataset -> device inference -> KITTI AP.

    reference evaluate() (train.py:480-932), minus ROS (see data/stream.py
    for the production path). The state passed to :meth:`run` is moved to
    the detector's device once per call (a no-op when it is there already).

    Not ported yet: the data-parallel mesh over several cards, and the BN
    statistics refresh before eval (``eval_input.bn_recal_batches`` > 0
    raises)."""

    def __init__(self, cfg: Config, detector: PillarsDetector,
                 measure_time: bool = False, buckets=None):
        if cfg.eval_input.bn_recal_batches:
            raise NotImplementedError(
                "eval_input.bn_recal_batches > 0: the BN statistics refresh "
                "needs train-mode BatchNorm, which is not ported yet")
        self.cfg = cfg
        self.detector = detector
        self.device = detector.device
        self.dataset = PedestrianDataset(cfg, cfg.eval_input, training=False)
        self.class_names = list(cfg.eval_input.desired_objects)
        self.measure_time = measure_time
        self.last_proxies: Dict[str, float] = {}
        # ms per cloud of each stage of the last measured run
        self.last_stage_ms: Dict[str, float] = {}
        # bucketed dispatch (pillars_torch/infer.py): batches are sliced on
        # the host to the smallest bucket holding their largest cloud
        # BEFORE they go to the device, then routed to that bucket's
        # detector by the (now exact) points.shape[1]
        self._bucketed = None
        if buckets is not None:
            from pillars_torch.infer import BucketedInference

            self._bucketed = BucketedInference(
                cfg, buckets, cfg.eval_input.anchor_area_threshold,
                device=self.device)
            self.infer = self._bucketed_infer
        else:
            self.infer = detector.make_inference_fn(
                cfg.eval_input.anchor_area_threshold)

    def _bucketed_infer(self, variables, points, num_points, rect, trv2c):
        # points was pre-sliced to an exact bucket width in _device_put
        return self._bucketed._fn(points.shape[1])(
            variables, points, num_points, rect, trv2c)

    def _device_put(self, batch):
        """Runs on the loader's thread: slice or pad the points to the
        batch's bucket, then start the copies of what inference reads. On
        the card they go through pinned memory and do not block."""
        if self._bucketed is not None:
            n = int(np.asarray(batch["num_points"]).max(initial=0))
            b = self._bucketed.select_bucket(n)
            pts = np.asarray(batch["points"])
            if pts.shape[1] > b:
                batch = dict(batch, points=pts[:, :b])
            elif pts.shape[1] < b:
                # a CLI bucket wider than the dataset's padded width: pad
                # UP so _bucketed_infer keys an exact (warmed) rung
                pad = np.zeros((pts.shape[0], b - pts.shape[1],
                                pts.shape[2]), pts.dtype)
                batch = dict(batch,
                             points=np.concatenate([pts, pad], axis=1))
        out = dict(batch)
        for key in _DEVICE_KEYS:
            if key not in batch:
                continue
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[key] = t
        return out

    def _drain(self, entry, dt_annos, timer):
        """Read back one in-flight batch and convert it to annos."""
        fetch, image_idx = entry
        with timer.stage("t_predict"):  # device->host wait, this batch only
            preds = fetch.result()
        with timer.stage("t_anno"):
            dt_annos += predictions_to_annos(
                preds, image_idx, self.class_names,
                self.cfg.model.postprocess.post_center_limit_range)

    def run(self, variables, max_samples: Optional[int] = None,
            save_path: Optional[str] = None,
            progress: bool = True) -> Tuple[List[Dict], List[Dict]]:
        """Returns (dt_annos, gt_annos). ``save_path`` pickles the dt_annos
        like the reference's per-epoch result.pkl (train.py:867-873).

        Pipelined with a bounded in-flight window: inference for batch i+k
        is dispatched while batch i's results convert to annos on the host
        (the reference runs these serially per frame, train.py:752-861).
        Stage timers keep the reference's names (train.py:629-712):
        t_preprocess = host batch build wait, t_network = dispatch,
        t_predict = device->host readback, t_anno = anno conversion."""
        variables = self.detector.state_to_device(variables)
        batch_size = self.cfg.eval_input.batch_size
        it = BatchIterator(self.dataset, batch_size, shuffle=False,
                           num_workers=self.cfg.eval_input.num_workers,
                           drop_remainder=False,
                           device_put_fn=self._device_put)
        total = (min(len(self.dataset), max_samples) if max_samples
                 else len(self.dataset))
        timer = StageTimer(enabled=self.measure_time)
        if self.measure_time:
            # first calls build kernels and let cuDNN pick its algorithms:
            # keep that out of the stage times
            if self._bucketed is not None:
                # every bucket rung, not the (never-dispatched) full width
                self._bucketed.warmup(variables, batch_size=batch_size)
            else:
                mp = self.cfg.model.voxel.max_points
                nf = self.cfg.model.num_point_features
                b = batch_size
                eye = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
                self.infer(variables, np.zeros((b, mp, nf), np.float32),
                           np.zeros((b,), np.int32), eye, eye)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        dt_annos: List[Dict] = []
        count = 0
        report_every = max(1, (total // batch_size) // 10 or 1)
        pending: List[Tuple] = []
        window = 4  # bounded in-flight depth
        src = iter(it)
        bi = 0
        t_sample = time.perf_counter()
        while True:
            with timer.stage("t_preprocess"):
                batch = next(src, None)
            if batch is None:
                break
            with timer.stage("t_network"):
                preds = self.infer(
                    variables, batch["points"], batch["num_points"],
                    batch["rect"], batch["trv2c"])
                fetch = HostFetch(preds)
            pending.append((fetch, batch["image_idx"]))
            if len(pending) > window:
                self._drain(pending.pop(0), dt_annos, timer)
            count += batch["points"].shape[0]
            timer.add("t_full_sample",
                      (time.perf_counter() - t_sample) * 1e3)
            t_sample = time.perf_counter()
            bi += 1
            if progress and bi % report_every == 0:
                pct = min(100, 100 * count // max(total, 1))
                msg = f"[eval] {count}/{total} clouds ({pct}%)"
                if self.measure_time:
                    avgs = timer.averages()
                    msg += "".join(f" {k} {v / batch_size:.2f}ms"
                                   for k, v in sorted(avgs.items()))
                print(msg)
            if max_samples and count >= max_samples:
                break
        while pending:
            self._drain(pending.pop(0), dt_annos, timer)
        if self.measure_time:
            avgs = timer.averages()
            self.last_stage_ms = {k: v / batch_size for k, v in avgs.items()}
            print("per-cloud: " + ", ".join(
                f"{k} {v / batch_size:.2f} ms"
                for k, v in sorted(avgs.items())) + f" ({count} clouds)")
        if save_path:
            with open(save_path, "wb") as f:
                pickle.dump(dt_annos, f, 2)
        if self.cfg.eval_input.no_annos_mode:
            # no labels to score against: predictions only
            # (reference train.py:876-880 exits before AP here)
            return dt_annos, []
        gt_annos = infos_to_gt_annos(self.dataset.infos)[: len(dt_annos)]
        return dt_annos, gt_annos

    def evaluate(self, variables, max_samples: Optional[int] = None,
                 save_path: Optional[str] = None):
        """Returns (result_str, mAPbev, mAP3d, mAPaos, score)."""
        dt_annos, gt_annos = self.run(variables, max_samples, save_path)
        if self.cfg.eval_input.no_annos_mode:
            # reference returns (score 0, "no evaluation") so the caller's
            # gating/logging still works (train.py:879-880)
            self.last_proxies = {}
            return "no evaluation (no_annos_mode)", 0.0, 0.0, 0.0, 0.0
        # detection-quality proxies: visible per-epoch movement long
        # before AP lifts off (eval/proxies.py)
        self.last_proxies = detection_quality_proxies(dt_annos, gt_annos)
        result, _, mAPbev, mAP3d, mAPaos = kitti_ap.get_official_eval_result(
            gt_annos, dt_annos, self.class_names, compute_bbox=False)
        score = kitti_ap.aggregate_eval_score(mAP3d, mAPaos, mAPbev)
        return result, mAPbev, mAP3d, mAPaos, score
