"""KITTI-style AP evaluation: bbox/BEV/3D/AOS, 41 recall points, the
6-threshold matrix of the reference.

Port of reference second/utils/eval.py (997 LoC) with identical semantics:
  - 41 sample points, every 4th precision averaged / 11 (get_mAP_v2,
    eval.py:686-690),
  - threshold selection from TP scores (get_thresholds, eval.py:19-38),
  - greedy per-frame matcher with ignore semantics
    (compute_statistics_jit, eval.py:166-286),
  - difficulty filtering via occlusion/truncation/bbox-height
    (clean_data, eval.py:40-94),
  - the stacked min_overlaps matrix 0.5..0.75
    (get_official_eval_result, eval.py:836-917).

The numba kernels become plain NumPy (the matcher loop is per-frame over at
most ~50 detections — trivial on host); the rotated-IoU CUDA kernel is
replaced by pillars_torch.geometry.rotated_iou (vectorized, exact), optionally
the native C++ version when built.
"""

from __future__ import annotations

import io
from typing import List

import numpy as np

from pillars_torch import native
from pillars_torch.geometry.rotated_iou import rotated_iou_np


def _rotated_overlap(boxes, qboxes, criterion=-1):
    """Rotated overlap matrix: native C++ (OpenMP) when built, NumPy twin
    otherwise. Same algorithm either way (csrc/geometry_ops.cc)."""
    if boxes.shape[0] and qboxes.shape[0]:
        out = native.rotated_overlap_matrix(boxes, qboxes, criterion)
        if out is not None:
            return out
    return rotated_iou_np(boxes, qboxes, criterion)

N_SAMPLE_PTS = 41

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting",
               "car", "tractor", "trailer"]
NAME_TO_CLASS = {
    "Car": 0, "Pedestrian": 1, "Cyclist": 2, "Van": 3, "Person_sitting": 4,
    "car": 5, "tractor": 6, "trailer": 7,
}

# KITTI difficulty gates (easy, moderate, hard): max occlusion level / max
# truncation fraction / min projected bbox height in pixels
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)
MIN_HEIGHT = (40, 25, 25)
NO_DETECTION = -10000000  # reference sentinel, kept for the test oracles


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> List[float]:
    """reference eval.py:19-38, closed-form.

    The reference walks every sorted score; but its skip condition depends
    only on the index i, never the score value: skip while
    (i+2)/num_gt - c < c - (i+1)/num_gt  ~  i + 1.5 < c * num_gt, where c
    is the running recall target. So each selected index is near
    ceil(c*num_gt - 1.5); jump there, then settle with the reference's
    EXACT float comparison (the algebraic form rounds differently) so the
    result is bit-identical to `_get_thresholds_loop`, in O(41) not O(n).
    """
    scores = np.sort(scores)[::-1]
    n = len(scores)
    thresholds = []
    current_recall = 0.0
    i = 0
    step = 1 / (num_sample_pts - 1.0)
    while i < n:
        # jump 2 below the algebraic first-non-skipped index (FP safety
        # margin), then scan with the exact reference predicate; the last
        # index never skips (reference disables the skip at i == n-1)
        j = int(np.ceil(current_recall * num_gt - 1.5)) - 2
        i = min(max(i, j), n - 1)
        while (i < n - 1 and ((i + 2) / num_gt - current_recall)
               < (current_recall - (i + 1) / num_gt)):
            i += 1
        thresholds.append(scores[i])
        current_recall += step
        i += 1
    return thresholds


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int,
               gt_names=None, dt_names=None):
    """reference eval.py:40-94, vectorized (same branch precedence: exact
    class match -> 1; pedestrian/person_sitting and car/van neighbor -> 0;
    else -1; difficulty gates by occlusion/truncation/pixel height).

    gt_names/dt_names: optional pre-lowered name arrays (eval_class computes
    them once per run instead of 6x per anno here)."""
    current_cls_name = CLASS_NAMES[current_class]  # table is lowercase
    if gt_names is None:
        gt_names = np.char.lower(np.asarray(gt_anno["name"], dtype=str))
    valid_class = np.full(gt_names.shape[0], -1, dtype=np.int64)
    if current_cls_name == "pedestrian":
        valid_class[gt_names == "person_sitting"] = 0
    elif current_cls_name == "car":
        valid_class[gt_names == "van"] = 0
    valid_class[gt_names == current_cls_name] = 1
    height = gt_anno["bbox"][:, 3] - gt_anno["bbox"][:, 1]
    ignore = ((np.asarray(gt_anno["occluded"]) > MAX_OCCLUSION[difficulty])
              | (np.asarray(gt_anno["truncated"])
                 > MAX_TRUNCATION[difficulty])
              | (height <= MIN_HEIGHT[difficulty]))
    ignored_gt = np.where(
        (valid_class == 1) & ~ignore, 0,
        np.where((valid_class == 0) | (ignore & (valid_class == 1)), 1, -1))
    num_valid_gt = int((ignored_gt == 0).sum())
    dc_bboxes = list(gt_anno["bbox"][
        np.asarray(gt_anno["name"], dtype=str) == "DontCare"])

    if dt_names is None:
        dt_names = np.char.lower(np.asarray(dt_anno["name"], dtype=str))
    dt_height = np.abs(dt_anno["bbox"][:, 3] - dt_anno["bbox"][:, 1])
    ignored_dt = np.where(
        dt_height < MIN_HEIGHT[difficulty], 1,
        np.where(dt_names == current_cls_name, 0, -1)).astype(np.int64)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Axis-aligned 2D image-box IoU (reference eval.py:97-125), vectorized."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), dtype=np.float64)
    qa = ((query_boxes[:, 2] - query_boxes[:, 0])
          * (query_boxes[:, 3] - query_boxes[:, 1]))
    ba = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    inter = iw * ih
    if criterion == -1:
        denom = ba[:, None] + qa[None, :] - inter
    elif criterion == 0:
        denom = np.broadcast_to(ba[:, None], inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(qa[None, :], inter.shape)
    else:
        denom = np.ones_like(inter)
    out = np.zeros_like(inter, dtype=np.float64)
    pos = inter > 0
    out[pos] = (inter / denom)[pos]
    return out


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """reference eval.py:127-129."""
    return _rotated_overlap(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D IoU in CAMERA coords: rotated BEV intersection x height overlap.

    reference eval.py:132-163 (d3_box_overlap + kernel). boxes [N, 7] camera
    (x, y, z, l, h, w, ry); BEV uses (x, z, l, w, ry); the y axis points
    DOWN, the location is the box bottom."""
    rinc = _rotated_overlap(boxes[:, [0, 2, 3, 5, 6]],
                            qboxes[:, [0, 2, 3, 5, 6]], 2)
    rinc = rinc.astype(np.float64)
    # Height intersection, fully vectorized (the reference runs this as a
    # numba prange double loop, eval.py:132-156; semantics identical).
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    inc = iw * rinc
    if criterion == -1:
        area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
        area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(
            (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None], rinc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(
            (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :], rinc.shape)
    else:
        ua = np.ones_like(rinc)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inc / ua
    return np.where(rinc > 0, np.where(iw > 0, iou, 0.0), rinc)


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy KITTI TP/FP/FN matcher with ignore semantics — same contract
    as the reference's ``compute_statistics_jit`` (eval.py:166-286), built
    differently: the GT loop stays sequential (the greedy consume-in-GT-order
    policy is load-bearing for AP parity) but each GT's candidate selection
    is a vectorized reduction over the remaining detections instead of an
    arrival-order scan; the semantics are pinned to a line-faithful loop
    oracle by a randomized differential test (tests/test_eval_ap.py).

    Matching policy per (non-skipped) GT, derived from the reference's
    arrival-scan invariants:
      * threshold-collection mode (``compute_fp=False``): the highest-score
        unconsumed detection overlapping above ``min_overlap`` (ignored
        detections compete in the same pool);
      * counting mode (``compute_fp=True``): the best-OVERLAP real detection
        (``ignored_det == 0``; ties -> lowest index, matching the strict ">"
        running max), falling back to the first ignored detection only when
        no real one qualifies — an ignored match consumes the GT without
        scoring a TP.
    A match against an ignored GT or by an ignored detection consumes the
    detection silently. Unconsumed real detections count as FP, minus those
    swallowed by DontCare regions (metric 0 only, criterion-0 overlap).

    overlaps: [num_dt, num_gt]. Returns
    (tp, fp, fn, similarity, matched-TP scores in GT order).
    """
    n_dt = dt_datas.shape[0]
    n_gt = gt_datas.shape[0]
    scores = dt_datas[:, -1]
    ignored_gt = np.asarray(ignored_gt)
    ignored_det = np.asarray(ignored_det)
    overlaps = np.asarray(overlaps)

    usable = ignored_det != -1
    if compute_fp:
        usable &= ~(scores < thresh)
    free = usable.copy()          # not yet consumed by a GT
    real = ignored_det == 0

    tp = 0
    fn = 0
    tp_scores: list = []
    aos_terms: list = []
    for g in range(n_gt):
        if ignored_gt[g] == -1:
            continue
        cand = free & (overlaps[:, g] > min_overlap)
        pick = -1
        if compute_fp:
            real_ids = np.flatnonzero(cand & real)
            if real_ids.size:
                pick = int(real_ids[np.argmax(overlaps[real_ids, g])])
            else:
                ign_ids = np.flatnonzero(cand)
                if ign_ids.size:
                    pick = int(ign_ids[0])
        else:
            ids = np.flatnonzero(cand)
            if ids.size:
                pick = int(ids[np.argmax(scores[ids])])
        if pick < 0:
            if ignored_gt[g] == 0:
                fn += 1
            continue
        free[pick] = False
        if ignored_gt[g] == 1 or ignored_det[pick] == 1:
            continue  # consumed without scoring
        tp += 1
        tp_scores.append(scores[pick])
        if compute_aos:
            aos_terms.append(
                (1.0 + np.cos(gt_datas[g, 4] - dt_datas[pick, 4])) / 2.0)

    fp = 0
    similarity = 0.0
    if compute_fp:
        stray = free & real
        fp = int(stray.sum())
        if metric == 0 and len(dc_bboxes) > 0:
            dc = (np.stack(dc_bboxes, 0) if isinstance(dc_bboxes, list)
                  else np.asarray(dc_bboxes))
            dc_hit = image_box_overlap(
                dt_datas[:, :4], dc, 0).max(axis=1) > min_overlap
            fp -= int((stray & dc_hit).sum())
        if compute_aos:
            similarity = (float(np.sum(aos_terms))
                          if (tp > 0 or fp > 0) else -1.0)
    return tp, fp, fn, similarity, np.asarray(tp_scores, dtype=np.float64)


def _frame_data(gt, dt, current_class, difficulty, gt_names, dt_names):
    """One frame's matcher inputs for a (class, difficulty) slice: the
    bbox+alpha(+score) data columns and the clean_data ignore labels
    (reference _prepare_data did this for all frames at once,
    eval.py:425-453; here one frame = one tuple so eval_class can stream)."""
    n_valid, ign_gt, ign_dt, dc = clean_data(gt, dt, current_class,
                                             difficulty, gt_names=gt_names,
                                             dt_names=dt_names)
    dc_arr = (np.stack(dc, 0).astype(np.float64) if dc
              else np.zeros((0, 4), np.float64))
    gt_cols = np.hstack([gt["bbox"], gt["alpha"][:, None]])
    dt_cols = np.hstack([dt["bbox"], dt["alpha"][:, None],
                         dt["score"][:, None]])
    return (gt_cols, dt_cols, np.asarray(ign_gt, np.int64),
            np.asarray(ign_dt, np.int64), dc_arr, n_valid)


def _prepare_data(gt_annos, dt_annos, current_class, difficulty,
                  name_cache=None):
    """Columnar view over all frames: transpose the per-frame tuples and
    total the valid-GT count."""
    rows = [
        _frame_data(gt, dt, current_class, difficulty,
                    name_cache[0][i] if name_cache else None,
                    name_cache[1][i] if name_cache else None)
        for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos))
    ]
    gt_datas, dt_datas, ign_gts, ign_dts, dcs, n_valids = zip(*rows) if rows \
        else ((), (), (), (), (), ())
    dc_counts = np.array([d.shape[0] for d in dcs])
    return (list(gt_datas), list(dt_datas), list(ign_gts), list(ign_dts),
            list(dcs), dc_counts, int(sum(n_valids)))


def _camera_boxes(anno, bev: bool) -> np.ndarray:
    """Stack an anno's camera-frame boxes: full 7-dof [x,y,z,l,h,w,ry], or
    the BEV 5-dof [x,z,l,w,ry] slice (y/h are the height axis in camera
    coords)."""
    cols = [0, 2] if bev else [0, 1, 2]
    return np.hstack([anno["location"][:, cols],
                      anno["dimensions"][:, cols],
                      anno["rotation_y"][:, None]])


def calculate_iou(gt_annos, dt_annos, metric):
    """Per-frame dt-x-gt overlap matrices (reference calculate_iou_partly,
    eval.py:348-422; partitioning is unnecessary with vectorized IoU)."""
    if metric == 0:
        pair = lambda dt, gt: image_box_overlap(dt["bbox"], gt["bbox"])
    elif metric == 1:
        pair = lambda dt, gt: bev_box_overlap(
            _camera_boxes(dt, True), _camera_boxes(gt, True))
    elif metric == 2:
        pair = lambda dt, gt: d3_box_overlap(
            _camera_boxes(dt, False), _camera_boxes(gt, False))
    else:
        raise ValueError(f"unknown metric {metric}")
    return [pair(dt, gt).astype(np.float64)
            for gt, dt in zip(gt_annos, dt_annos)]


def _accumulate_pr(overlaps, slices, metric, min_overlap, thresholds,
                   compute_aos, frames):
    """Sum (tp, fp, fn, similarity) over frames for every threshold —
    [T, 4]. Uses the native fused matcher when built, else the NumPy
    matcher per (frame, threshold)."""
    if frames is not None:
        return frames.fused_statistics(metric, min_overlap, thresholds,
                                       compute_aos)
    gt_datas, dt_datas, ign_gts, ign_dts, dcs = slices
    pr = np.zeros((len(thresholds), 4))
    for ov, g, d, ig, idt, dc in zip(overlaps, gt_datas, dt_datas,
                                     ign_gts, ign_dts, dcs):
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics(
                ov, g, d, ig, idt, dc, metric, min_overlap=min_overlap,
                thresh=thresh, compute_fp=True, compute_aos=compute_aos)
            pr[t] += (tp, fp, fn, sim if sim != -1 else 0.0)
    return pr


def _collect_match_scores(overlaps, slices, metric, min_overlap, frames):
    """All matched-TP scores across frames (threshold-selection pass)."""
    if frames is not None:
        return frames.match_scores(metric, min_overlap)
    gt_datas, dt_datas, ign_gts, ign_dts, dcs = slices
    out: List[float] = []
    for ov, g, d, ig, idt, dc in zip(overlaps, gt_datas, dt_datas,
                                     ign_gts, ign_dts, dcs):
        out += compute_statistics(ov, g, d, ig, idt, dc, metric,
                                  min_overlap=min_overlap, thresh=0.0,
                                  compute_fp=False)[4].tolist()
    return out


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """AP curves for every (class, difficulty, overlap-level) cell — the
    reference's eval_class_v3 contract (eval.py:552-659), organised as:
    one data-preparation per (class, difficulty) slice, then per overlap
    level a two-pass match (score collection -> 41 thresholds -> counted
    P/R), with the P/R -> precision/recall/aos conversion and the
    right-to-left running max done as array ops."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou(gt_annos, dt_annos, metric)
    ov_flat = native.flatten_overlaps(overlaps) if native.available() else None
    name_cache = (
        [np.char.lower(np.asarray(a["name"], dtype=str)) for a in gt_annos],
        [np.char.lower(np.asarray(a["name"], dtype=str)) for a in dt_annos])
    shape = (len(current_classes), len(difficultys), len(min_overlaps),
             N_SAMPLE_PTS)
    curves = {key: np.zeros(shape) for key in ("recall", "precision",
                                               "orientation")}
    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas, dt_datas, ign_gts, ign_dts, dcs, _dc_counts,
             n_valid_gt) = _prepare_data(gt_annos, dt_annos, current_class,
                                         difficulty, name_cache=name_cache)
            slices = (gt_datas, dt_datas, ign_gts, ign_dts, dcs)
            frames = (native.EvalFrames(overlaps, gt_datas, dt_datas,
                                        ign_gts, ign_dts, dcs,
                                        ov_flat=ov_flat)
                      if ov_flat is not None else None)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                scores = _collect_match_scores(overlaps, slices, metric,
                                               min_overlap, frames)
                thresholds = np.asarray(
                    get_thresholds(np.asarray(scores), n_valid_gt))
                pr = np.asarray(_accumulate_pr(
                    overlaps, slices, metric, min_overlap, thresholds,
                    compute_aos, frames))
                tp, fp, fn, sim = pr.T
                cell = {"recall": tp / (tp + fn),
                        "precision": tp / (tp + fp)}
                if compute_aos:
                    cell["orientation"] = sim / (tp + fp)
                for key, vals in cell.items():
                    # KITTI interpolated AP: each point takes the running
                    # max of everything to its right
                    mono = np.maximum.accumulate(vals[::-1])[::-1]
                    curves[key][m, l, k, :len(mono)] = mono
    return curves


def get_mAP(prec):
    """41-pt interpolated AP: every 4th recall point averaged over the 11
    kept samples, as a percentage (reference get_mAP_v2, eval.py:686-690)."""
    return prec[..., ::4].sum(axis=-1) / 11 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, difficultys=(0, 1, 2), compute_bbox=True):
    """(mAP_bbox, mAP_bev, mAP_3d, mAP_aos) over the three metrics
    (reference do_eval_v2, eval.py:694-753). AOS rides the BEV pass."""
    def run(metric, aos=False):
        return eval_class(gt_annos, dt_annos, current_classes, difficultys,
                          metric, min_overlaps, aos)

    bbox = get_mAP(run(0, compute_aos)["precision"]) if compute_bbox else None
    bev_curves = run(1, compute_aos)
    bev = get_mAP(bev_curves["precision"])
    aos = get_mAP(bev_curves["orientation"]) if compute_aos else None
    d3 = get_mAP(run(2)["precision"])
    return bbox, bev, d3, aos


def _min_overlaps_matrix() -> np.ndarray:
    """The stacked [6, 3 metrics, 8 classes] min-overlap tensor the
    reference evaluates at (eval.py:843-866). Level 0 is KITTI's official
    table; levels 1..5 sweep the PEDESTRIAN column 0.55 -> 0.75 (bbox row
    +0.2) with every other class pinned to its official hard threshold —
    the reference author's 6-threshold experiment, reproduced
    programmatically rather than as six pasted tables."""
    # KITTI official (bbox, bev, 3d) x (car, ped, cyc, van, p_sit, car,
    # tractor, trailer)
    official = np.array([[0.7, 0.7, 0.5, 0.7, 0.5, 0.5, 0.5, 0.5],
                         [0.5, 0.5, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5],
                         [0.5, 0.5, 0.25, 0.5, 0.25, 0.5, 0.5, 0.5]])
    levels = [official]
    for ped in (0.55, 0.60, 0.65, 0.70, 0.75):
        t = np.full((3, 8), 0.7)
        t[:, [2, 4]] = 0.5          # cyclist / person_sitting
        t[:, 1] = (ped + 0.2, ped, ped)  # pedestrian; bbox stricter
        levels.append(t)
    return np.stack(levels, axis=0)


def _as_class_ids(classes) -> List[int]:
    """Normalize a class spec (single, name, id, or mixed list) to ids."""
    if not isinstance(classes, (list, tuple)):
        classes = [classes]
    return [NAME_TO_CLASS[c] if isinstance(c, str) else int(c)
            for c in classes]


def _aos_available(dt_annos) -> bool:
    """AOS is computable iff the first non-empty detection set carries a
    real alpha (the reference's -10 sentinel marks alpha-less predictions,
    eval.py:899-905)."""
    first = next((a for a in dt_annos if a["alpha"].shape[0]), None)
    return first is not None and first["alpha"][0] != -10


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             difficultys=(0, 1, 2), compute_bbox=True):
    """reference get_official_eval_result (eval.py:836-917).

    Returns (result_str, mAPbbox, mAPbev, mAP3d, mAPaos); each mAP has shape
    [num_class, num_difficulty, 6]."""
    current_classes = _as_class_ids(current_classes)
    min_overlaps = _min_overlaps_matrix()[:, :, current_classes]
    compute_aos = _aos_available(dt_annos)
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        list(difficultys), compute_bbox=compute_bbox)
    s = io.StringIO()
    class_names_cap = {v: k for k, v in NAME_TO_CLASS.items()}
    for j, curcls in enumerate(current_classes):
        for i in range(len(min_overlaps)):
            print(f"{class_names_cap[curcls]} "
                  "AP@{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[i, :, j]),
                  file=s)
            if compute_bbox and mAPbbox is not None:
                print(f"bbox AP:{mAPbbox[j, 0, i]:.2f}, "
                      f"{mAPbbox[j, 1, i]:.2f}, {mAPbbox[j, 2, i]:.2f}", file=s)
            print(f"bev  AP:{mAPbev[j, 0, i]:.2f}, "
                  f"{mAPbev[j, 1, i]:.2f}, {mAPbev[j, 2, i]:.2f}", file=s)
            print(f"3d   AP:{mAP3d[j, 0, i]:.2f}, "
                  f"{mAP3d[j, 1, i]:.2f}, {mAP3d[j, 2, i]:.2f}", file=s)
            if compute_aos:
                print(f"aos  AP:{mAPaos[j, 0, i]:.2f}, "
                      f"{mAPaos[j, 1, i]:.2f}, {mAPaos[j, 2, i]:.2f}", file=s)
    return s.getvalue(), mAPbbox, mAPbev, mAP3d, mAPaos


# [start, stop, num] per class (reference eval.py:941-951)
_COCO_CLASS_RANGE = {
    0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
    3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10], 5: [0.5, 0.95, 10],
    6: [0.5, 0.95, 10], 7: [0.5, 0.95, 10],
}


def get_coco_eval_result(gt_annos, dt_annos, current_classes,
                         compute_bbox: bool = True):
    """COCO-style AP averaged over an IoU range (reference
    get_coco_eval_result + do_coco_style_eval, eval.py:755-775, :920-997)."""
    current_classes = _as_class_ids(current_classes)
    # [num levels, 3 metrics, classes]: each class sweeps its own
    # linspace(lo, hi, n), identical across the three metrics
    ranges = [_COCO_CLASS_RANGE[c] for c in current_classes]
    min_overlaps = np.stack(
        [np.tile(np.linspace(lo, hi, int(n))[:, None], (1, 3))
         for lo, hi, n in ranges], axis=2)
    compute_aos = _aos_available(dt_annos)
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        compute_bbox=compute_bbox)
    take = lambda m: None if m is None else m.mean(-1)
    s = io.StringIO()
    class_names_cap = {v: k for k, v in NAME_TO_CLASS.items()}
    bbox_m, bev_m, d3_m = take(mAPbbox), take(mAPbev), take(mAP3d)
    aos_m = take(mAPaos)
    for j, curcls in enumerate(current_classes):
        lo, hi, num = ranges[j]
        step = (hi - lo) / (num - 1)
        print(f"{class_names_cap[curcls]} "
              f"coco AP@{lo:.2f}:{step:.2f}:{hi:.2f}:", file=s)
        if bbox_m is not None:
            print(f"bbox AP:{bbox_m[j, 0]:.2f}, {bbox_m[j, 1]:.2f}, "
                  f"{bbox_m[j, 2]:.2f}", file=s)
        print(f"bev  AP:{bev_m[j, 0]:.2f}, {bev_m[j, 1]:.2f}, "
              f"{bev_m[j, 2]:.2f}", file=s)
        print(f"3d   AP:{d3_m[j, 0]:.2f}, {d3_m[j, 1]:.2f}, "
              f"{d3_m[j, 2]:.2f}", file=s)
        if aos_m is not None:
            print(f"aos  AP:{aos_m[j, 0]:.2f}, {aos_m[j, 1]:.2f}, "
                  f"{aos_m[j, 2]:.2f}", file=s)
    return s.getvalue(), bbox_m, bev_m, d3_m, aos_m


def aggregate_eval_score(mAP3d, mAPaos, mAPbev) -> float:
    """The reference's checkpoint-gating score:
    (sum(3d) + sum(aos) + sum(bev)) / 18 over the 6 thresholds
    (reference train.py:418, :926).

    When every detection set is empty, AOS is undefined (the reference's
    compute_aos sniffing, eval.py:899-905) — count it as zero instead of
    crashing like the reference would."""
    aos_sum = mAPaos[0][0].sum() if mAPaos is not None else 0.0
    return float((mAP3d[0][0].sum() + aos_sum + mAPbev[0][0].sum()) / 18)
