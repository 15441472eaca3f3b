"""NumPy box geometry that anchor building needs: a copy of the matching
functions of pillars_tpu/geometry/np_boxes.py (same math, same conventions).
"""

from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    """reference load_data.py:805-806."""
    return val - np.floor(val / period + offset) * period


def center_to_minmax_2d(centers, dims):
    """reference load_data.py:549-556."""
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """Rotated [N,5] (x, y, w, l, r) -> nearest axis-aligned [N,4] standup
    box. reference load_data.py:533-548."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = np.abs(limit_period(rots, 0.5, np.pi))
    cond = (rots_0_pi_div_2 > np.pi / 4)[..., np.newaxis]
    bboxes_center = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    return center_to_minmax_2d(bboxes_center[:, :2], bboxes_center[:, 2:])
