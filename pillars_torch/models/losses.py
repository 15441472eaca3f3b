"""Detection losses (pillars_tpu/models/losses.py; reference
model/voxelnet.py:38-69, 156-512, 922-1049).

- sigmoid focal classification loss, the tf.nn formulation with its clip,
- weighted smooth-L1 localization loss (sigma 3, ``code_weights``) with the
  sin(a - b) encoding of the rotation residual,
- softmax direction-classifier loss on (rot_gt > 0),
- NormByNumPositives weights and the debug-only pos/neg split.

Computed in the lane-major [B, fields, A] layout of the JAX package, in at
least f32 whatever the head dtype (f64 heads stay f64).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pillars_torch import device_constant
from pillars_torch.config import LossConfig


class LossOutput(NamedTuple):
    loss: torch.Tensor
    loc_loss_reduced: torch.Tensor
    cls_loss_reduced: torch.Tensor
    dir_loss_reduced: torch.Tensor
    cls_pos_loss: torch.Tensor
    cls_neg_loss: torch.Tensor


def _sigmoid_cross_entropy_with_logits(logits, labels):
    """tf.nn.sigmoid_cross_entropy_with_logits with the reference's
    clip-by-value guard (model/voxelnet.py:237-259)."""
    loss = torch.clamp(logits, 0.0, 10000.0) - logits * labels
    return loss + torch.log1p(torch.exp(-torch.abs(logits)))


def prepare_loss_weights(labels, cfg: LossConfig, dtype=torch.float32):
    """[B, A] labels -> (cls_weights, reg_weights, cared), NormByNumPositives
    (reference model/voxelnet.py:461-512)."""
    cared = labels >= 0
    positives = (labels > 0).to(dtype)
    negatives = (labels == 0).to(dtype)
    cls_weights = (negatives * cfg.neg_class_weight
                   + positives * cfg.pos_class_weight)
    reg_weights = positives
    if cfg.loss_norm_type == "NormByNumPositives":
        pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True),
                               1.0, 100000.0)
        reg_weights = reg_weights / pos_norm
        cls_weights = cls_weights / pos_norm
    return cls_weights, reg_weights, cared


def _heads_to_lane_major(x, batch_size, fields):
    """[B, H, W, T*fields] head tensor -> [B, fields, A], anchor a = (y*W +
    x)*T + t on the last axis."""
    lt = x.reshape(batch_size, -1, x.shape[-1] // fields, fields)
    return lt.permute(0, 3, 1, 2).reshape(batch_size, fields, -1)


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(x, n)`` without its range check, which makes the host
    wait for the device (int64, ``x`` in [0, n))."""
    return (x[..., None] == torch.arange(n, device=x.device)).long()


def detection_loss(cfg: LossConfig, num_class: int, box_preds, cls_preds,
                   dir_preds, anchors, labels, reg_targets,
                   use_direction_classifier: bool = True) -> LossOutput:
    """Total detection loss for one batch.

    box_preds/cls_preds/dir_preds: [B, H, W, C_head] raw head outputs;
    anchors [A, 7]; labels [B, A] int; reg_targets [B, 7, A] (the
    :class:`~pillars_torch.ops.targets.TargetAssignment` layout) or
    [B, A, 7]."""
    batch_size = labels.shape[0]
    labels = labels.long()
    ft = torch.promote_types(box_preds.dtype, torch.float32)
    box_preds = _heads_to_lane_major(box_preds.to(ft), batch_size, 7)
    cls_preds = _heads_to_lane_major(cls_preds.to(ft), batch_size, num_class)
    if reg_targets.shape[-1] == 7 and reg_targets.shape[1] != 7:
        reg_targets = reg_targets.transpose(1, 2)
    reg_targets = reg_targets.to(ft)

    cls_weights, reg_weights, cared = prepare_loss_weights(labels, cfg, ft)
    cls_targets = labels * cared.to(labels.dtype)
    one_hot_targets = _one_hot(cls_targets, num_class + 1).permute(
        0, 2, 1)[:, 1:, :].to(box_preds.dtype)                    # [B, C, A]

    if cfg.encode_rad_error_by_sin:
        rp = box_preds[:, 6:7, :]
        rt = reg_targets[:, 6:7, :]
        box_preds_sin = torch.cat(
            [box_preds[:, :6, :], torch.sin(rp) * torch.cos(rt)], dim=1)
        reg_targets_sin = torch.cat(
            [reg_targets[:, :6, :], torch.cos(rp) * torch.sin(rt)], dim=1)
    else:
        box_preds_sin, reg_targets_sin = box_preds, reg_targets

    # weighted smooth L1 (sigma, code_weights), fields on axis 1
    sigma = cfg.smooth_l1_sigma
    code_w = device_constant(cfg.code_weights, box_preds.dtype,
                             box_preds.device).reshape(1, -1, 1)
    abs_diff = torch.abs(code_w * (box_preds_sin - reg_targets_sin))
    lt_mask = (abs_diff <= 1.0 / (sigma ** 2)).to(abs_diff.dtype)
    loc_loss = (lt_mask * 0.5 * (abs_diff * sigma) ** 2
                + (abs_diff - 0.5 / (sigma ** 2)) * (1.0 - lt_mask))
    loc_loss = loc_loss * reg_weights[:, None, :]

    # sigmoid focal loss, classes on axis 1
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    per_entry = _sigmoid_cross_entropy_with_logits(cls_preds, one_hot_targets)
    probs = torch.sigmoid(cls_preds)
    p_t = one_hot_targets * probs + (1 - one_hot_targets) * (1 - probs)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = (one_hot_targets * alpha + (1 - one_hot_targets) * (1 - alpha)
               if alpha is not None else 1.0)
    cls_loss = modulating * alpha_w * per_entry * cls_weights[:, None, :]

    loc_loss_reduced = loc_loss.sum() / batch_size * cfg.localization_weight
    cls_loss_reduced = cls_loss.sum() / batch_size * cfg.classification_weight

    # debug-only pos/neg split (reference model/voxelnet.py:48-61)
    if num_class == 1:
        cls_flat = cls_loss.reshape(batch_size, -1)
        cls_pos = ((labels > 0) * cls_flat).sum() / batch_size
        cls_neg = ((labels == 0) * cls_flat).sum() / batch_size
    else:
        # the class slices are strided views (classes are the minor axis in
        # memory): a contiguous copy keeps torch's blocked f32 sum (summed
        # in place, a 1.29M-anchor slice lost 7e-5 relative)
        cls_pos = cls_loss[:, 1:, :].contiguous().sum() / batch_size
        cls_neg = cls_loss[:, 0, :].contiguous().sum() / batch_size

    loss = loc_loss_reduced + cls_loss_reduced
    dir_loss_reduced = torch.zeros((), dtype=box_preds.dtype,
                                   device=box_preds.device)
    if use_direction_classifier:
        # direction target: (rot_gt > 0) one-hot (voxelnet.py:38-46)
        rot_gt = reg_targets[:, 6, :] + anchors[None, :, 6].to(
            reg_targets.dtype)
        dir_targets = _one_hot((rot_gt > 0).long(), 2).permute(0, 2, 1).to(
            box_preds.dtype)                                       # [B, 2, A]
        dir_logits = _heads_to_lane_major(dir_preds.to(ft), batch_size, 2)
        weights = (labels > 0).to(box_preds.dtype)
        weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                        1.0, 9999999.0)
        logprobs = F.log_softmax(dir_logits, dim=1)
        dir_loss = -(dir_targets * logprobs).sum(dim=1) * weights
        dir_loss_reduced = dir_loss.sum() / batch_size * cfg.direction_weight
        loss = loss + dir_loss_reduced

    return LossOutput(loss, loc_loss_reduced, cls_loss_reduced,
                      dir_loss_reduced, cls_pos, cls_neg)
