"""The train step and training state (pillars_tpu/train/loop.py).

One Python function per step, on the detector's device: voxelization,
anchors mask, target assignment, forward in train mode, loss, backward,
optimizer update. The state is passed in and a new one returned; the step
changes none of the tensors it was handed.

Over several ranks (the detector's ``mesh``, pillars_torch/parallel/), each
rank passes its block of the global batch (``parallel.shard_batch``); the
train-mode BNs reduce their statistics over the ranks, and after the
backward ONE all-reduce over a flat buffer of every gradient leaf sums them
over the spatial ranks and averages them over the data ranks. AdamW then
runs alike on every rank, so the parameters stay identical. Loss parts
(each rank's divided by its own batch) are averaged and ``num_positives``
summed over the data ranks: the global batch's values.

Batch layout (dense, padded; NumPy arrays or tensors):
    points      [B, MAXPTS, D] float32
    num_points  [B]            int32
    gt_boxes    [B, G, 7]      float32 (padding rows have dims == 1)
    gt_classes  [B, G]         int32
    gt_valid    [B, G]         bool
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from pillars_torch.models.detector import PillarsDetector
from pillars_torch.models.losses import LossOutput
from pillars_torch.ops.targets import TargetAssignment
from pillars_torch.parallel.collectives import (all_gather_cat,
                                                all_reduce_flat)
from pillars_torch.train import metrics as tm
from pillars_torch.train.optim import AdamState, AdamW

# what the step reads of a batch
BATCH_KEYS = ("points", "num_points", "gt_boxes", "gt_classes", "gt_valid")
_STAT_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState


class StepMetrics(NamedTuple):
    """Names follow the reference's wandb keys
    (libraries/train_helper_functions.py:6-14); tensors on the device. The
    first six are :class:`~pillars_torch.models.losses.LossOutput`'s."""

    loss: torch.Tensor
    loc_loss_reduced: torch.Tensor
    cls_loss_reduced: torch.Tensor
    dir_loss_reduced: torch.Tensor
    cls_pos_loss: torch.Tensor
    cls_neg_loss: torch.Tensor
    learning_rate: torch.Tensor
    num_positives: torch.Tensor


def split_state(state: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A network ``state_dict`` -> (parameters, BN statistics)."""
    stats = {k: v for k, v in state.items()
             if k.rsplit(".", 1)[-1] in _STAT_LEAVES}
    return {k: v for k, v in state.items() if k not in stats}, stats


def variables(state: TrainState) -> Dict[str, torch.Tensor]:
    """The network ``state_dict`` of a train state."""
    return {**state.params, **state.batch_stats}


def create_train_state(detector: PillarsDetector, generator: torch.Generator,
                       batch_size: int) -> Tuple[TrainState, AdamW]:
    params, stats = split_state(detector.init(generator, batch_size))
    opt = AdamW(detector.config.train.optimizer, batch_size)
    return TrainState(0, params, stats, opt.init(params)), opt


def batch_to_device(batch, device, keys=BATCH_KEYS
                    ) -> Dict[str, torch.Tensor]:
    """The ``keys`` entries of ``batch`` (arrays or tensors) as tensors on
    ``device``. Host data bound for the card goes through pinned memory and
    does not block; a tensor already there is passed through."""
    device = torch.device(device)
    out = {}
    for key in keys:
        t = torch.as_tensor(batch[key])
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


class Gradients(NamedTuple):
    """What one forward + backward of a batch gives."""

    loss: LossOutput
    grads: Dict[str, torch.Tensor]       # by parameter name
    batch_stats: Dict[str, torch.Tensor]  # the new BN statistics
    targets: TargetAssignment
    cls_preds: torch.Tensor
    num_positives: torch.Tensor  # int32, over the global batch


def _data_group(detector: PillarsDetector):
    mesh = detector.mesh
    if mesh is None:
        return None, 1
    axis = detector.config.runtime.data_axis
    return mesh.group(axis), mesh.axis_size(axis)


def forward_backward(detector: PillarsDetector, state: TrainState, batch,
                     anchor_area_threshold: float) -> Gradients:
    """Voxelize, anchors mask and targets (no gradient), then the train-mode
    forward, the loss and its gradient with respect to every parameter."""
    b = batch_to_device(batch, detector.device)
    with torch.no_grad():
        vox = detector.voxelize_batch(b["points"], b["num_points"])
        amask = detector.anchors_mask_batch(vox.coords, vox.pillar_mask,
                                            anchor_area_threshold)
        targets = detector.assign_targets(
            b["gt_boxes"], b["gt_classes"], b["gt_valid"], amask)
    with torch.enable_grad():
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        preds, new_stats = detector.apply({**params, **state.batch_stats},
                                          vox, train=True)
        out = detector.loss(preds, targets.labels, targets.bbox_targets)
        grads = torch.autograd.grad(out.loss, list(params.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(state.params.items(), grads)}
    out = LossOutput(*(t.detach() for t in out))
    n_pos = (targets.labels > 0).sum(dtype=torch.int32)
    if detector.mesh is not None:
        grads = dict(zip(grads, all_reduce_flat(
            grads.values(), detector.mesh.group(), detector.grad_scale)))
        group, n_data = _data_group(detector)
        if group is not None:
            *parts, n_pos = all_reduce_flat(
                list(out) + [n_pos.to(out.loss.dtype)], group)
            out = LossOutput(*(p / n_data for p in parts))
            n_pos = n_pos.round().to(torch.int32)
    return Gradients(out, grads, new_stats, targets,
                     preds["cls_preds"].detach(), n_pos)


def make_train_step(detector: PillarsDetector, opt: AdamW,
                    anchor_area_threshold: Optional[float] = None,
                    with_metrics: bool = False):
    """``step(state, batch) -> (state, StepMetrics)``.

    ``with_metrics=True`` (config ``train.train_metrics``) also threads a
    :class:`pillars_torch.train.metrics.TrainMetricsState` through the
    step: ``step(state, tm_state, batch) -> (state, tm_state, StepMetrics,
    running-values dict)``."""
    thr = (detector.config.train_input.anchor_area_threshold
           if anchor_area_threshold is None else anchor_area_threshold)
    num_class = detector.config.model.num_class

    def _core(state: TrainState, batch):
        fb = forward_backward(detector, state, batch, thr)
        new_params, new_opt = opt.update(fb.grads, state.opt_state,
                                         state.params)
        new_state = TrainState(state.step + 1, new_params,
                               {**state.batch_stats, **fb.batch_stats},
                               new_opt)
        metrics = StepMetrics(
            *fb.loss,
            learning_rate=torch.tensor(opt.schedule(state.step),
                                       dtype=torch.float32),
            num_positives=fb.num_positives)
        return new_state, metrics, fb

    if not with_metrics:
        def step(state: TrainState, batch):
            new_state, metrics, _ = _core(state, batch)
            return new_state, metrics

        return step

    def step_m(state: TrainState, tm_state: tm.TrainMetricsState, batch):
        new_state, metrics, fb = _core(state, batch)
        cls_preds, labels = fb.cls_preds, fb.targets.labels
        group, n_data = _data_group(detector)
        if n_data > 1:  # the streaming metrics of the global batch
            cls_preds = all_gather_cat(cls_preds, group)
            labels = all_gather_cat(labels, group)
        new_tm, values = tm.update_metrics(
            tm_state, fb.loss.cls_loss_reduced, fb.loss.loc_loss_reduced,
            cls_preds, labels, num_class)
        return new_state, new_tm, metrics, values

    return step_m
