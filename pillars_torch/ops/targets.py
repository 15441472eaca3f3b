"""Anchor target assignment on the device (pillars_tpu/ops/targets.py;
reference create_target_np, load_data.py:331-532, positive_fraction=None).

Per sample, over [A] anchors x [G] padded gt boxes:
  1. similarity = axis-aligned IoU of nearest-standup boxes,
  2. force-match: every anchor that ties the per-gt max overlap is positive
     (gt with zero max overlap are dropped),
  3. positives: row max >= matched_threshold,
  4. background: row max < unmatched_threshold,
  5. priority: force > background > positive > don't-care (-1),
  6. anchors outside the anchors mask are pruned (label -1, weight 0).

The JAX package selects each anchor's matched gt by a one-hot matmul at
HIGHEST precision; here it is an exact gather of the argmax row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pillars_torch.geometry import boxes as gb


class TargetAssignment(NamedTuple):
    labels: torch.Tensor        # [A] int32: -1 don't care, 0 bg, >0 class id
    # [7, A] lane-major encoded residuals (0 for non-positive), the layout
    # detection_loss consumes
    bbox_targets: torch.Tensor
    reg_weights: torch.Tensor   # [A] float32: 1.0 for positives


def assign_targets(anchors_standup, anchors, gt_boxes, gt_classes, gt_valid,
                   anchors_mask, matched_threshold, unmatched_threshold
                   ) -> TargetAssignment:
    """One sample: [A,4]/[A,7] static anchors vs [G,7] padded gt boxes."""
    out = assign_targets_batched(anchors_standup, anchors, gt_boxes[None],
                                 gt_classes[None], gt_valid[None],
                                 anchors_mask[None], matched_threshold,
                                 unmatched_threshold)
    return TargetAssignment(*(t[0] for t in out))


def assign_targets_batched(anchors_standup, anchors, gt_boxes, gt_classes,
                           gt_valid, anchors_mask, matched_threshold,
                           unmatched_threshold) -> TargetAssignment:
    """gt_boxes [B,G,7], gt_classes/gt_valid [B,G], anchors_mask [B,A] ->
    labels [B,A], bbox_targets [B,7,A], reg_weights [B,A]."""
    b, g, _ = gt_boxes.shape
    # (x, y, w, l, r) by slices: a list index is a tensor made on the host
    gt_standup = gb.rbbox2d_to_near_bbox(torch.cat(
        [gt_boxes[..., 0:2], gt_boxes[..., 3:5], gt_boxes[..., 6:7]],
        dim=-1).reshape(b * g, 5))
    overlap = gb.iou_matrix(anchors_standup, gt_standup)          # [A, B*G]
    overlap = overlap.reshape(-1, b, g).permute(1, 0, 2)          # [B, A, G]
    participate = anchors_mask[:, :, None] & gt_valid[:, None, :]
    overlap = torch.where(participate, overlap,
                          torch.full_like(overlap, -1.0))

    # the first index of the row max, as jnp.argmax
    anchor_to_gt_max, anchor_to_gt_argmax = overlap.max(dim=2)   # [B, A]
    gt_to_anchor_max = overlap.amax(dim=1)                       # [B, G]
    # gt that match no anchor are removed (reference load_data.py:441-443)
    gt_to_anchor_max = torch.where(gt_to_anchor_max == 0.0,
                                   torch.full_like(gt_to_anchor_max, -1.0),
                                   gt_to_anchor_max)
    gt_to_anchor_max = torch.where(gt_valid, gt_to_anchor_max,
                                   torch.full_like(gt_to_anchor_max, -10.0))
    # force-match including ties; the >= 0 guard keeps pruned (-1) entries
    force = ((overlap == gt_to_anchor_max[:, None, :])
             & (overlap >= 0.0)).any(dim=2)

    pos = anchor_to_gt_max >= matched_threshold
    bg = (anchor_to_gt_max < unmatched_threshold) & anchors_mask

    matched_cls = torch.gather(gt_classes, 1, anchor_to_gt_argmax)
    labels = torch.full_like(matched_cls, -1)
    labels = torch.where(pos, matched_cls, labels)
    labels = torch.where(bg, torch.zeros_like(labels), labels)
    labels = torch.where(force, matched_cls, labels)

    fg = labels > 0
    matched = torch.gather(
        gt_boxes, 1, anchor_to_gt_argmax[..., None].expand(-1, -1, 7))
    encoded = gb.second_box_encode(matched, anchors[None])       # [B, A, 7]
    bbox_targets = torch.where(fg[:, None, :], encoded.transpose(1, 2),
                               torch.zeros((), dtype=encoded.dtype,
                                           device=encoded.device))
    return TargetAssignment(labels.to(torch.int32), bbox_targets,
                            fg.to(torch.float32))
