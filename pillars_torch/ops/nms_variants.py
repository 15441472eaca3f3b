"""Host-side NMS variants: rotated NMS and soft-NMS (a copy of
pillars_tpu/ops/nms_variants.py).

The reference ships these as exported-but-unused-in-the-hot-path kernels
(rotate_nms_cc via nms.so, reference nms_cpu.py:25-43; nms_jit/soft_nms_jit,
nms_cpu.py:46-169; rotate_nms_kernel, nms_gpu.py:419-490). Provided here so
downstream users relying on them find equivalents; the device hot path uses
ops/nms.py (the CUDA keep-mask kernel on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pillars_torch.geometry import np_boxes as nb
from pillars_torch.geometry.rotated_iou import rotated_iou_np


def rotated_nms(rbboxes: np.ndarray, scores: np.ndarray,
                iou_threshold: float = 0.5,
                pre_max_size: Optional[int] = None,
                post_max_size: Optional[int] = None) -> np.ndarray:
    """Greedy NMS with EXACT rotated IoU over [N, 5] (x, y, w, l, r) boxes.

    Equivalent of the reference's rotate_nms_cc (nms_cpu.py:25-36: standup
    prefilter + exact rotated IoU suppression). Returns kept indices into
    the input, score-descending."""
    n = len(scores)
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    order = np.argsort(-scores)
    if pre_max_size is not None:
        order = order[:pre_max_size]
    boxes_s = rbboxes[order]
    iou = rotated_iou_np(boxes_s, boxes_s)
    kept = []
    suppressed = np.zeros(len(order), dtype=bool)
    for i in range(len(order)):
        if suppressed[i]:
            continue
        kept.append(order[i])
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
        if post_max_size is not None and len(kept) >= post_max_size:
            break
    return np.asarray(kept, dtype=np.int64)


def soft_nms(boxes: np.ndarray, scores: np.ndarray,
             sigma: float = 0.5, score_threshold: float = 0.001,
             method: str = "gaussian") -> np.ndarray:
    """Soft-NMS over [N, 4] standup boxes: instead of suppressing, decay the
    scores of overlapping boxes (reference soft_nms_jit, nms_cpu.py:107-169).

    Returns the re-scored ``scores`` array ordered like the input; callers
    threshold on ``score_threshold``. method: 'linear' | 'gaussian'."""
    boxes = boxes.astype(np.float64).copy()
    out_scores = scores.astype(np.float64).copy()
    n = len(boxes)
    alive = np.ones(n, dtype=bool)
    for _ in range(n):
        cand = np.where(alive & (out_scores > score_threshold))[0]
        if len(cand) == 0:
            break
        i = cand[np.argmax(out_scores[cand])]
        alive[i] = False
        others = np.where(alive)[0]
        if len(others) == 0:
            break
        iou = nb.iou_matrix(boxes[i][None], boxes[others])[0]
        if method == "linear":
            decay = np.where(iou > 0.3, 1.0 - iou, 1.0)
        else:
            decay = np.exp(-(iou * iou) / sigma)
        out_scores[others] *= decay
    return out_scores
