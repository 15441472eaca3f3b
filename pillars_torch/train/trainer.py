"""Training and evaluation (pillars_tpu/train/trainer.py; reference
train.py:126-460, train, and :480-932, evaluate): epochs of train steps on
the card, a full KITTI eval after each epoch, weights kept iff the aggregate
score improves.

Over several ranks (``runtime.num_devices`` > 1; one process per device,
started by ``pillars_torch.parallel.launch``), every rank reads the same
global batches from the same seeded loader and trains on its block of each
(train/loop.py reduces the statistics and gradients); the ``Evaluator``
splits full eval batches over the ranks, runs a batch that does not split
on rank 0 alone, and gathers the predictions in batch order. Only rank 0
writes checkpoints, ``metrics.csv``, result files and the archived
``train.yaml``. With ``train_input.num_workers`` > 1 the loader's threads
interleave the augmentation draws, as in the JAX package, so the ranks'
copies of a batch agree only with one worker.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pillars_torch.config import Config
from pillars_torch.data.pipeline import BatchIterator, PedestrianDataset
from pillars_torch.data.sampler import DataBaseSampler
from pillars_torch.eval import kitti_ap
from pillars_torch.eval.predict_to_anno import (infos_to_gt_annos,
                                                predictions_to_annos)
from pillars_torch.eval.proxies import detection_quality_proxies
from pillars_torch.models.detector import (HostFetch, PillarsDetector,
                                           Predictions)
from pillars_torch.parallel.collectives import (all_gather_cat, broadcast_,
                                                broadcast_object)
from pillars_torch.parallel.launch import is_main, resolve_num_devices
from pillars_torch.parallel.mesh import make_mesh, shard_batch
from pillars_torch.train import checkpoint as ckpt
from pillars_torch.train.loop import (batch_to_device, create_train_state,
                                      make_train_step, split_state, variables)
from pillars_torch.train.metrics import TrainMetricsState
from pillars_torch.train.metrics_log import MetricLogger
from pillars_torch.utils.profiling import StageTimer

# what the inference function reads of a batch; the rest stays on the host
_DEVICE_KEYS = ("points", "num_points", "rect", "trv2c")


class Evaluator:
    """Batched offline eval: dataset -> device inference -> KITTI AP.

    reference evaluate() (train.py:480-932), minus ROS (see data/stream.py
    for the production path). The state passed to :meth:`run` is moved to
    the detector's device once per call (a no-op when it is there already).
    ``eval_input.bn_recal_batches`` > 0 refreshes its BN statistics first
    (train/bn_recal.py).

    On the card the inference replays captured CUDA graphs, one per batch
    shape (``PillarsDetector.make_inference_fn``); a new batch shape is
    captured at its first batch. So does the recalibration step
    (``train/bn_recal.py``), which updates the statistics in place.

    Data-parallel over ``runtime.num_devices`` ranks (0: every rank of the
    process group, one device outside any group): each full batch that splits
    over the ranks is split, each rank infers its block (its postprocess
    launching the NMS kernel) and the blocks are gathered in batch order;
    a batch that does not split runs on rank 0 and its predictions are
    broadcast. Every rank returns the same annos; the AP is computed on
    rank 0 and broadcast. Each rank's inference holds no collective (the
    gather and the broadcast come after it), so it replays its own graphs
    whatever the backend, the remainder batch on rank 0 too; the
    collectives run eagerly between the replays."""

    def __init__(self, cfg: Config, detector: PillarsDetector,
                 measure_time: bool = False, buckets=None):
        self.cfg = cfg
        self.detector = detector
        self.device = detector.device
        self.dataset = PedestrianDataset(cfg, cfg.eval_input, training=False)
        self.class_names = list(cfg.eval_input.desired_objects)
        self.measure_time = measure_time
        self.last_proxies: Dict[str, float] = {}
        self._recal_batches = None  # host cache of the bn_recal scenes
        self._recal_step = None
        # ms per cloud of each stage of the last measured run
        self.last_stage_ms: Dict[str, float] = {}
        # bucketed dispatch (pillars_torch/infer.py): batches are sliced on
        # the host to the smallest bucket holding their largest cloud
        # BEFORE they go to the device, then routed to that bucket's
        # detector by the (now exact) points.shape[1]
        self.mesh = None
        n_dev = resolve_num_devices(cfg.runtime.num_devices)
        if n_dev > 1:
            axis = cfg.runtime.data_axis
            mesh = detector.mesh
            self.mesh = (mesh if mesh is not None and mesh.group(axis)
                         is not None else make_mesh(n_dev, axis))
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

    def _split(self, b: int) -> bool:
        """Whether a batch of ``b`` clouds splits over the data ranks."""
        return (self.mesh is not None
                and b % self.mesh.axis_size(self.cfg.runtime.data_axis) == 0)

    def _data_rank(self) -> int:
        return self.mesh.axis_index(self.cfg.runtime.data_axis)

    def _infer_batch(self, variables, batch) -> Predictions:
        """The predictions of the whole batch, on every rank."""
        args = [batch[k] for k in ("points", "num_points", "rect", "trv2c")]
        if self.mesh is None:
            return self.infer(variables, *args)
        group = self.mesh.group(self.cfg.runtime.data_axis)
        with torch.inference_mode():
            if batch["split"]:
                local = self.infer(variables, *args)
                return Predictions(*(_from_wire(all_gather_cat(
                    _to_wire(t), group), t.dtype) for t in local))
            if self._data_rank() == 0:
                preds = self.infer(variables, *args)
            else:  # receives rank 0's predictions of the batch
                b = len(batch["image_idx"])
                k = self.cfg.model.postprocess.nms_post_max_size
                dev = self.device
                preds = Predictions(
                    torch.empty((b, k, 7), device=dev),
                    torch.empty((b, k, 7), device=dev),
                    torch.empty((b, k), device=dev),
                    torch.empty((b, k), dtype=torch.int32, device=dev),
                    torch.empty((b, k), dtype=torch.bool, device=dev))
            return Predictions(*(_from_wire(broadcast_(
                _to_wire(t), 0, group), t.dtype) for t in preds))

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
        return {**batch, **batch_to_device(
            batch, self.device, [k for k in _DEVICE_KEYS if k in batch])}

    def _device_put_ranks(self, batch):
        """:meth:`_device_put` over the data ranks: this rank's block of a
        batch that splits over them, else the whole batch on rank 0 and
        nothing on the others."""
        split = self._split(len(batch["points"]))
        if split:
            batch = {**batch, **shard_batch(
                {k: batch[k] for k in _DEVICE_KEYS if k in batch},
                self.mesh, self.cfg.runtime.data_axis)}
        batch = dict(batch, split=split)
        if not split and self._data_rank() != 0:
            return batch  # rank 0 runs it
        return self._device_put(batch)

    def _drain(self, entry, dt_annos, timer):
        """Read back one in-flight batch and convert it to annos."""
        fetch, image_idx = entry
        with timer.stage("t_predict"):  # device->host wait, this batch only
            preds = fetch.result()
        with timer.stage("t_anno"):
            dt_annos += predictions_to_annos(
                preds, image_idx, self.class_names,
                self.cfg.model.postprocess.post_center_limit_range)

    def _maybe_recalibrate(self, variables):
        """AdaBN refresh of the BN statistics before eval
        (train/bn_recal.py). The scenes come from the TRAIN split read
        through the eval-mode (unaugmented) pipeline; no labels are read."""
        k = self.cfg.eval_input.bn_recal_batches
        if not k or not any(n.endswith("running_mean") for n in variables):
            return variables
        if self._recal_batches is None:
            reader = (self.cfg.train_input
                      if self.cfg.train_input.info_path else
                      self.cfg.eval_input)
            ds = (PedestrianDataset(self.cfg, reader, training=False)
                  if reader is self.cfg.train_input else self.dataset)
            batches = []
            for b in BatchIterator(ds, self.cfg.eval_input.batch_size,
                                   shuffle=False, num_workers=1,
                                   drop_remainder=True):
                batches.append({"points": np.asarray(b["points"]),
                                "num_points": np.asarray(b["num_points"])})
                if len(batches) >= k:
                    break
            self._recal_batches = batches
        from pillars_torch.train.bn_recal import build_recal_fn, recalibrate

        if self._recal_step is None:
            self._recal_step = build_recal_fn(self.cfg, device=self.device)
        return recalibrate(self.cfg, variables, self._recal_batches,
                           step=self._recal_step)

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
        variables = self._maybe_recalibrate(
            self.detector.state_to_device(variables))
        batch_size = self.cfg.eval_input.batch_size
        it = BatchIterator(self.dataset, batch_size, shuffle=False,
                           num_workers=self.cfg.eval_input.num_workers,
                           drop_remainder=False,
                           device_put_fn=(self._device_put_ranks if self.mesh
                                          else self._device_put))
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
                fetch = HostFetch(self._infer_batch(variables, batch))
            pending.append((fetch, batch["image_idx"]))
            if len(pending) > window:
                self._drain(pending.pop(0), dt_annos, timer)
            count += len(batch["image_idx"])
            timer.add("t_full_sample",
                      (time.perf_counter() - t_sample) * 1e3)
            t_sample = time.perf_counter()
            bi += 1
            if progress and is_main() and bi % report_every == 0:
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
        if save_path and is_main():
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
        out = None
        if self.mesh is None or self._data_rank() == 0:
            # detection-quality proxies: visible per-epoch movement long
            # before AP lifts off (eval/proxies.py)
            proxies = detection_quality_proxies(dt_annos, gt_annos)
            result, _, mAPbev, mAP3d, mAPaos = (
                kitti_ap.get_official_eval_result(
                    gt_annos, dt_annos, self.class_names,
                    compute_bbox=False))
            score = kitti_ap.aggregate_eval_score(mAP3d, mAPaos, mAPbev)
            out = (proxies, (result, mAPbev, mAP3d, mAPaos, score))
        if self.mesh is not None:
            out = broadcast_object(
                out, 0, self.mesh.group(self.cfg.runtime.data_axis))
        self.last_proxies, result = out
        return result


class Trainer:
    """Epoch loop, per-epoch eval and score-gated checkpoints on one device
    (the card unless ``device`` says otherwise), or data-parallel over the
    ranks of a process group when ``runtime.num_devices`` > 1 (0: every
    rank of the group, one device outside any group): each rank builds its
    own Trainer on its device; the global batch size must split over the
    ranks.

    On the card the step replays a captured CUDA graph per batch shape
    (``make_train_step``), over NCCL ranks with its collectives inside, and
    ``state`` holds its static tensors, updated in place by every step
    (donated, as the JAX package's jitted step is); the per-epoch eval and
    the checkpoints read them. Each replay bumps their versions, so the
    eval's captured inference copies the newest weights. Over gloo ranks
    the step runs eagerly."""

    def __init__(self, cfg: Config, use_wandb: bool = False, device=None):
        self.cfg = cfg
        n_dev = resolve_num_devices(cfg.runtime.num_devices)
        self.mesh = None
        if n_dev > 1:
            if cfg.train_input.batch_size % n_dev:
                raise ValueError(
                    f"batch_size {cfg.train_input.batch_size} not divisible "
                    f"by {n_dev} devices")
            self.mesh = make_mesh(n_dev, cfg.runtime.data_axis)
        self.is_main = is_main()
        self.detector = PillarsDetector(cfg, device=device, mesh=self.mesh)
        self.device = self.detector.device
        self.dirs = (ckpt.create_out_dirs(cfg.out_dir, cfg.model_id)
                     if self.is_main else None)
        if self.mesh is not None:
            self.dirs = broadcast_object(self.dirs, 0, self.mesh.group())
        if self.is_main:
            # archive the resolved config into the run dir (reference
            # copies configs/train.yaml, train.py:158)
            try:
                cfg.to_yaml(os.path.join(self.dirs["model_dir"],
                                         "train.yaml"))
            except RuntimeError:
                pass  # no yaml module: the run goes on, unarchived
        self.logger = MetricLogger(
            self.dirs["logs"] if self.is_main else None,
            use_wandb=use_wandb and self.is_main,
            run_name=f"model_{self.dirs['model_id']}")

        sampler = None
        if cfg.train_input.sampler.info_path:
            sampler = DataBaseSampler(
                cfg.train_input.sampler.info_path, cfg.train_input.sampler,
                rng=np.random.RandomState(cfg.train.seed))
        self.dataset = PedestrianDataset(
            cfg, cfg.train_input, training=True, sampler=sampler,
            rng=np.random.RandomState(cfg.train.seed))
        self.state, self.opt = create_train_state(
            self.detector, torch.Generator().manual_seed(cfg.train.seed),
            cfg.train_input.batch_size)
        self.step_fn = make_train_step(self.detector, self.opt,
                                       with_metrics=cfg.train.train_metrics)
        self.tm_state = (TrainMetricsState.init(self.device)
                         if cfg.train.train_metrics else None)
        self.evaluator = None
        if cfg.train.do_evaluate and cfg.eval_input.info_path:
            from pillars_torch.infer import parse_bucket_arg

            self.evaluator = Evaluator(
                cfg, self.detector,
                buckets=parse_bucket_arg(cfg.eval_input.buckets,
                                         cfg.model.voxel.max_points))
        if cfg.train.load_weights:
            self._load_variables(*ckpt.load_params(cfg.train.load_weights))
        self._start_epoch = 0
        self._best_score = 0.0
        # epoch whose eval/gating was interrupted (resume re-runs it)
        self._pending_eval_epoch: Optional[int] = None

    def _load_variables(self, params, batch_stats):
        from pillars_torch.weights import from_jax_variables

        full = from_jax_variables(params, batch_stats, self.cfg)
        p, s = split_state(self.detector.state_to_device(full))
        self.state = self.state._replace(
            params=p, batch_stats=s if batch_stats else self.state.batch_stats)

    # ------------------------------------------------------------------
    def resume(self, checkpoint_path: str) -> int:
        """Restore the FULL train state (parameters, BN statistics, Adam
        moments, step) from a checkpoint of either package, and the epoch
        counter, best-score gate and pending eval from its ``extra``, so a
        resumed run continues numbering and gating where the interrupted
        one stopped. Returns the restored step."""
        state, extra = ckpt.load_checkpoint(checkpoint_path)
        if isinstance(state, dict):  # params-only checkpoint
            self._load_variables(state["params"], state.get("batch_stats"))
        else:
            self.state = ckpt.train_state_from_host(state, self.cfg,
                                                    self.device)
        self._start_epoch = int(extra.get("epoch", -1)) + 1
        self._best_score = float(
            extra.get("best_score", extra.get("score", 0.0)))
        # the pre-eval temp checkpoint carries evaluated=False: a run that
        # died DURING the eval re-runs that epoch's eval and gating first
        self._pending_eval_epoch = (self._start_epoch - 1
                                    if not extra.get("evaluated", True)
                                    else None)
        return self.state.step

    # ------------------------------------------------------------------
    def variables(self) -> Dict[str, torch.Tensor]:
        return variables(self.state)

    # ------------------------------------------------------------------
    def train(self, epochs: Optional[int] = None,
              eval_max_samples: Optional[int] = None,
              overfit_first_batch: bool = False,
              replay_batch_file: Optional[str] = None,
              save_batch_file: Optional[str] = None,
              fixture_repeats: int = 100) -> float:
        """Debug fixtures of the reference's test strategy:
        ``overfit_first_batch`` repeats the first batch ``fixture_repeats``
        times per epoch (reference take_first, train.py:249),
        ``replay_batch_file`` trains on one pickled batch (from_file_mode,
        train.py:248-256), ``save_batch_file`` records the first batch."""
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.train.epochs_total
        batch_size = cfg.train_input.batch_size
        best_score = self._best_score
        step_count = self.state.step
        # H2D prefetch: the loader's thread copies each batch (this rank's
        # block of it) to the card through pinned memory, overlapping the
        # previous step
        def put(batch):
            if self.mesh is None:
                return {**batch, **batch_to_device(batch, self.device)}
            local = shard_batch(batch, self.mesh, cfg.runtime.data_axis)
            return {**local, **batch_to_device(local, self.device),
                    "global_batch": batch}

        if self._pending_eval_epoch is not None and self.evaluator is not None:
            best_score = self._eval_and_gate(
                self._pending_eval_epoch, best_score, eval_max_samples)
            self._pending_eval_epoch = None

        fixed_batch = None
        if replay_batch_file:
            with open(replay_batch_file, "rb") as f:
                fixed_batch = pickle.load(f)

        for epoch in range(self._start_epoch, epochs):
            if fixed_batch is not None:
                it = [put(fixed_batch)] * fixture_repeats
            elif overfit_first_batch:
                first = next(iter(BatchIterator(
                    self.dataset, batch_size, shuffle=False, num_workers=1)))
                it = [put(first)] * fixture_repeats
            else:
                it = BatchIterator(
                    self.dataset, batch_size, shuffle=cfg.train_input.shuffle,
                    num_workers=cfg.train_input.num_workers,
                    prefetch_depth=cfg.train_input.prefetch_depth,
                    device_put_fn=put, seed=cfg.train.seed + epoch)
            t_epoch = time.time()
            for batch in it:
                if save_batch_file and step_count == 0 and self.is_main:
                    whole = batch.get("global_batch", batch)
                    with open(save_batch_file, "wb") as f:
                        pickle.dump({k: (v.cpu().numpy()
                                         if isinstance(v, torch.Tensor)
                                         else v) for k, v in whole.items()},
                                    f, 2)
                if self.tm_state is not None:
                    self.state, self.tm_state, metrics, tm_values = \
                        self.step_fn(self.state, self.tm_state, batch)
                else:
                    self.state, metrics = self.step_fn(self.state, batch)
                    tm_values = None
                if (self.is_main
                        and step_count % cfg.train.log_every_steps == 0):
                    self.logger.log_train_step(step_count, epoch, metrics,
                                               extra=tm_values)
                if (self.is_main
                        and step_count % cfg.train.print_every_steps == 0):
                    print(f"[train] epoch {epoch} step {step_count} "
                          f"loss {float(metrics.loss):.4f} "
                          f"lr {float(metrics.learning_rate):.6f}")
                step_count += 1
            if self.is_main:
                print(f"[train] epoch {epoch} done in "
                      f"{time.time()-t_epoch:.1f}s")

            if self.evaluator is not None:
                best_score = self._eval_and_gate(epoch, best_score,
                                                 eval_max_samples)
        self._best_score = best_score
        return best_score

    # ------------------------------------------------------------------
    def _eval_and_gate(self, epoch: int, best_score: float,
                       eval_max_samples: Optional[int]) -> float:
        """Per-epoch eval and score-gated retention (reference
        train.py:403-440). The pre-eval temp checkpoint carries
        evaluated=False so a kill DURING the eval resumes by re-running it;
        after gating the temp is rewritten with evaluated=True."""
        step_count = self.state.step
        temp = os.path.join(self.dirs["checkpoints"], "weights_temp.pkl")
        if self.is_main:
            ckpt.save_checkpoint(temp, self.state, extra={
                "epoch": epoch, "best_score": best_score,
                "evaluated": False})
        result, bev, d3, aos, score = self.evaluator.evaluate(
            self.variables(), max_samples=eval_max_samples,
            save_path=os.path.join(self.dirs["results"],
                                   f"result_{epoch}.pkl"))
        if not self.is_main:  # the same score: the same gating
            return max(best_score, score)
        self.logger.log_eval(step_count, d3, aos, bev, score,
                             extra=self.evaluator.last_proxies)
        print(f"[eval] epoch {epoch} score {score:.2f} "
              f"(best {best_score:.2f})")
        with open(os.path.join(self.dirs["results"],
                               f"model_result_{epoch}.txt"), "w") as f:
            f.write(result)
        if score > best_score:
            best_score = score
            ckpt.save_checkpoint(
                os.path.join(self.dirs["checkpoints"],
                             f"weights_{epoch}.pkl"),
                self.state, extra={"score": score, "epoch": epoch,
                                   "best_score": best_score})
        ckpt.save_checkpoint(temp, self.state, extra={
            "epoch": epoch, "best_score": best_score, "evaluated": True})
        return best_score


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """Bool tensors cross the collectives as uint8."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()


def _from_wire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype) if t.dtype != dtype else t
