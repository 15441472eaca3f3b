"""Convert device Predictions to KITTI-style annotation dicts.

reference libraries/eval_helper_functions.py:150-330 (predict_kitti_to_anno,
get_start_result_anno, empty_result_anno). The center-range filter lives
here (as in the reference), applied on the host to the fixed-size device
output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def empty_result_anno() -> Dict[str, np.ndarray]:
    return {
        "name": np.array([]),
        "truncated": np.array([]),
        "occluded": np.array([]),
        "alpha": np.array([]),
        "bbox": np.zeros([0, 4]),
        "dimensions": np.zeros([0, 3]),
        "location": np.zeros([0, 3]),
        "rotation_y": np.array([]),
        "score": np.array([]),
    }


def predictions_to_annos(predictions, image_idx: np.ndarray,
                         class_names: Sequence[str],
                         center_limit_range: Optional[Sequence[float]] = None
                         ) -> List[Dict[str, np.ndarray]]:
    """predictions: models.detector.Predictions (host numpy or device arrays).

    Matches the reference's anno layout, including the fake 2D bbox
    [400, 200, 500, 400] (reference voxelnet.py:1357-1360) and
    alpha = -arctan2(-y_lidar, x_lidar) + ry_camera
    (reference eval_helper_functions.py:241-243)."""
    boxes_lidar = np.asarray(predictions.boxes_lidar)
    boxes_camera = np.asarray(predictions.boxes_camera)
    scores = np.asarray(predictions.scores)
    labels = np.asarray(predictions.labels)
    valid = np.asarray(predictions.valid)
    limit = (np.asarray(center_limit_range)
             if center_limit_range is not None else None)

    annos = []
    for b in range(boxes_lidar.shape[0]):
        anno = {k: [] for k in ("name", "truncated", "occluded", "alpha",
                                "bbox", "dimensions", "location",
                                "rotation_y", "score")}
        num = 0
        for k in range(boxes_lidar.shape[1]):
            if not valid[b, k]:
                continue
            box_lidar = boxes_lidar[b, k]
            box = boxes_camera[b, k]
            if limit is not None:
                if (np.any(box_lidar[:3] < limit[:3])
                        or np.any(box_lidar[:3] > limit[3:])):
                    continue
            anno["name"].append(class_names[int(labels[b, k])])
            anno["bbox"].append(np.array([400.0, 200.0, 500.0, 400.0]))
            anno["truncated"].append(0.0)
            anno["occluded"].append(0)
            anno["alpha"].append(
                -np.arctan2(-box_lidar[1], box_lidar[0]) + box[6])
            anno["dimensions"].append(box[3:6])
            anno["location"].append(box[:3])
            anno["rotation_y"].append(box[6])
            anno["score"].append(scores[b, k])
            num += 1
        if num:
            anno = {k: np.stack(v) for k, v in anno.items()}
        else:
            anno = empty_result_anno()
        anno["batch_idx"] = np.array([image_idx[b]] * num, dtype=np.int64)
        annos.append(anno)
    return annos


def infos_to_gt_annos(infos: Sequence[Dict]) -> List[Dict]:
    """Ground-truth annos for the evaluator, straight from the info dicts
    (reference train.py:876-883)."""
    return [info["annos"] for info in infos]
