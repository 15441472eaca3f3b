"""Greedy standup-box NMS (pillars_tpu/ops/nms.py), batched.

Boxes are processed in descending score order; a box is kept iff no
higher-scored KEPT box overlaps it with iou > threshold (strict), where the
IoU keeps the reference's +1-pixel convention on metric boxes. The batch is a
leading dimension (the JAX package vmaps one sample at a time).

:func:`keep_mask_plain` is the plain twin of the CUDA kernel in
``csrc/nms_keep_mask.cu``: same arithmetic, op for op, so the two give
bit-equal keep masks.
"""

from __future__ import annotations

import torch


def _pixel_iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] standup boxes -> [..., K, K] IoU with the +1 convention.
    Element [i, j] is (area_i + area_j - inter) in that order, as the
    kernel computes it."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    area = (x1 - x0 + 1.0) * (y1 - y0 + 1.0)
    left = torch.maximum(x0[..., :, None], x0[..., None, :])
    right = torch.minimum(x1[..., :, None], x1[..., None, :])
    top = torch.maximum(y0[..., :, None], y0[..., None, :])
    bottom = torch.minimum(y1[..., :, None], y1[..., None, :])
    width = torch.clamp_min(right - left + 1.0, 0.0)
    height = torch.clamp_min(bottom - top + 1.0, 0.0)
    inter = width * height
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def keep_mask_plain(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """[B, K, 4] score-sorted boxes + [B, K] validity -> [B, K] keep mask,
    as one sequential sweep over the [B, K, K] overlap matrix."""
    k = boxes_sorted.shape[1]
    valid = valid_sorted.bool()
    thr = torch.tensor(iou_threshold, dtype=torch.float32)
    overlap = ((_pixel_iou_matrix(boxes_sorted) > thr.to(boxes_sorted.device))
               & valid[:, :, None] & valid[:, None, :])
    kept = torch.zeros_like(valid)
    for i in range(k):
        suppressed = (overlap[:, i, :i] & kept[:, :i]).any(dim=1)
        kept[:, i] = valid[:, i] & ~suppressed
    return kept


def nms_standup(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, iou_threshold: float,
                post_max_size: int, use_kernel: bool = True):
    """Greedy NMS over [B, K, 4] standup boxes.

    Returns (keep_indices [B, post_max], keep_valid [B, post_max]), indices
    into the INPUT order. ``use_kernel`` routes the keep mask through
    :func:`pillars_torch.ops.nms_cuda.nms_keep_mask` (the CUDA kernel for a
    CUDA tensor, the plain twin for a CPU one); otherwise the plain twin."""
    from pillars_torch.ops.nms_cuda import nms_keep_mask

    b = boxes.shape[0]
    masked = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    # ascending stable argsort, REVERSED (pillars_tpu/ops/nms.py:52): among
    # equal scores the higher index comes first — not the same order as
    # argsort(descending=True, stable=True)
    order = torch.argsort(masked, dim=1, stable=True).flip(1)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    if use_kernel:
        kept = nms_keep_mask(boxes_s.contiguous(), valid_s, iou_threshold)
    else:
        kept = keep_mask_plain(boxes_s, valid_s, iou_threshold)

    # stable-compact the kept boxes (already score-ordered) and trim
    rank = torch.cumsum(kept.to(torch.int32), dim=1) - 1
    slot = torch.where(kept & (rank < post_max_size), rank,
                       torch.full_like(rank, post_max_size)).long()
    out_idx = torch.zeros((b, post_max_size + 1), dtype=torch.int32,
                          device=boxes.device)
    out_idx.scatter_(1, slot, order.to(torch.int32))
    n_kept = torch.clamp_max(kept.sum(dim=1), post_max_size)
    out_valid = (torch.arange(post_max_size, device=boxes.device)[None]
                 < n_kept[:, None])
    return out_idx[:, :post_max_size], out_valid
