"""The comparison that decides ``correct``: each delivered set of detections
against the reference's for the same cloud.

One number per delivery, the detection gap, and the run's is the widest:

- a program detection and a reference detection pair up, nearest first,
  where they differ by less than ``PAIR`` in score and in every box
  parameter (metres; yaw wrapped into [0, pi]); a pair's gap is that
  difference;
- a detection left without a partner is a decision the two sides took
  differently: keeping or dropping a box, or flipping its direction. Its
  gap is how near the reference's decision came to the other outcome (the
  reference's decision margin of that candidate: score against each
  threshold and the top-K boundary, IoU against the NMS threshold and the
  score gap to the boxes it overlaps, the direction logits, the yaw's sign).
  A program detection that is no candidate of the reference at all reads
  its distance to the nearest one.

Sound float32 runs read rounding (1e-6 to 1e-5); the float32 reference
computed with TF32 reads about 1e-3; a wrong box reads its error.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from port_bench.reference.pointpillars import Candidates, decision_margin

# a pair differs by less than this in score and in every box parameter
PAIR = 0.05


class Gap(NamedTuple):
    gap: float
    paired: int
    unpaired: int


def _distance(a_boxes, a_scores, b_boxes, b_scores, flip_b=False):
    """[n, m] the largest difference in score, x, y, z, w, l, h and yaw
    (wrapped into [0, pi]); with ``flip_b`` the yaw of ``b`` turned by pi
    counts as well."""
    d = np.abs(a_scores[:, None] - b_scores[None, :])
    d = np.maximum(d, np.abs(a_boxes[:, None, :6]
                             - b_boxes[None, :, :6]).max(axis=-1, initial=0))
    dr = np.abs(np.angle(np.exp(1j * (a_boxes[:, None, 6].astype(np.float64)
                                      - b_boxes[None, :, 6]))))
    if flip_b:
        dr = np.minimum(dr, np.pi - dr)
    return np.maximum(d, dr)


def delivery_gap(boxes: np.ndarray, scores: np.ndarray, cand: Candidates,
                 model: Dict, margins: np.ndarray = None) -> Gap:
    """The detection gap of one delivery (``boxes`` [n, 7], ``scores`` [n])
    against the reference's candidates ``cand`` of the same cloud."""
    if margins is None:
        margins = decision_margin(cand, model)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
    scores = np.asarray(scores, np.float32).reshape(-1)
    ref_idx = cand.final
    rb, rs = cand.boxes[ref_idx], cand.scores[ref_idx]
    d = _distance(boxes, scores, rb, rs)
    pairs: List[Tuple[int, int]] = []
    free_p, free_r = set(range(len(boxes))), set(range(len(ref_idx)))
    if d.size:
        for flat in np.argsort(d, axis=None, kind="stable"):
            i, j = divmod(int(flat), d.shape[1])
            if d[i, j] >= PAIR:
                break
            if i in free_p and j in free_r:
                pairs.append((i, j))
                free_p.discard(i)
                free_r.discard(j)
    gap = max((float(d[i, j]) for i, j in pairs), default=0.0)
    for j in free_r:  # served by the reference, not by the program
        gap = max(gap, float(margins[ref_idx[j]]))
    if free_p:
        valid = np.flatnonzero(cand.valid)
        dc = _distance(boxes, scores, cand.boxes[valid], cand.scores[valid],
                       flip_b=True)
        for i in free_p:  # served by the program, not by the reference
            if not len(valid):
                gap = max(gap, 1.0)
                continue
            j = int(np.argmin(dc[i]))
            gap = max(gap, float(dc[i, j]) if dc[i, j] >= PAIR
                      else max(float(dc[i, j]), float(margins[valid[j]])))
    return Gap(gap, len(pairs), len(free_p) + len(free_r))


def run_gap(deliveries, cands: List[Candidates], model: Dict) -> Dict:
    """The widest detection gap over ``deliveries`` [(bank index, boxes,
    scores)], each against ``cands[bank index]``; identical deliveries of
    one cloud are judged once."""
    margins = {}
    seen = {}
    widest, paired, unpaired = 0.0, 0, 0
    for idx, boxes, scores in deliveries:
        key = (idx, np.asarray(boxes, np.float32).tobytes(),
               np.asarray(scores, np.float32).tobytes())
        if key not in seen:
            if idx not in margins:
                margins[idx] = decision_margin(cands[idx], model)
            seen[key] = delivery_gap(boxes, scores, cands[idx], model,
                                     margins[idx])
        g = seen[key]
        widest = max(widest, g.gap)
        paired += g.paired
        unpaired += g.unpaired
    return {"detection_gap": widest, "deliveries": len(deliveries),
            "distinct": len(seen), "paired": paired, "unpaired": unpaired}
