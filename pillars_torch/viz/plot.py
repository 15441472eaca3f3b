"""Matplotlib BEV / 3D box plotting + confidence-map rendering (a copy of
pillars_tpu/viz/plot.py). matplotlib is imported inside the functions: the
package runs without it.

reference second/utils/bbox_plot.py (463 LoC, matplotlib/pyqtgraph) and the
printConfidenceMap debug path (train.py:646-674): the cls-head sigmoid
heatmap over the BEV grid.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pillars_torch.geometry import np_boxes as nb


def plot_bev(points: Optional[np.ndarray] = None,
             gt_boxes: Optional[np.ndarray] = None,
             pred_boxes: Optional[np.ndarray] = None,
             scores: Optional[np.ndarray] = None,
             point_cloud_range: Sequence[float] = (0, -2.56, -3, 6.4, 2.56, 3),
             ax=None, save_path: Optional[str] = None):
    """Bird's-eye-view scene rendering: points + gt (green) + preds (red)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 8))
    pcr = np.asarray(point_cloud_range)
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 1], s=0.3, c=points[:, 2],
                   cmap="viridis", alpha=0.5)

    def draw(boxes, color, labels=None):
        boxes = np.asarray(boxes).reshape(-1, 7)
        if not len(boxes):
            return
        corners = nb.center_to_corner_box2d(
            boxes[:, :2], boxes[:, 3:5], boxes[:, 6])
        for i, c in enumerate(corners):
            poly = np.concatenate([c, c[:1]], axis=0)
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.5)
            if labels is not None:
                ax.annotate(f"{labels[i]:.2f}", c[0], color=color, fontsize=7)

    if gt_boxes is not None:
        draw(gt_boxes, "limegreen")
    if pred_boxes is not None:
        draw(pred_boxes, "red", scores)
    ax.set_xlim(pcr[0] - 0.5, pcr[3] + 0.5)
    ax.set_ylim(pcr[1] - 0.5, pcr[4] + 0.5)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if save_path:
        import matplotlib.pyplot as plt

        plt.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close()
    return ax


def confidence_map(cls_preds: np.ndarray, point_cloud_range, voxel_size,
                   save_path: Optional[str] = None):
    """Render the cls-head sigmoid heatmap over the BEV grid (the reference's
    printConfidenceMap, train.py:646-674, rendered a box grid to RVIZ)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scores = 1 / (1 + np.exp(-np.asarray(cls_preds)))
    # [ny, nx, n_anchor] -> max over anchors
    heat = scores.reshape(scores.shape[0], scores.shape[1], -1).max(-1)
    fig, ax = plt.subplots(figsize=(10, 8))
    pcr = np.asarray(point_cloud_range)
    im = ax.imshow(heat, origin="lower", cmap="inferno",
                   extent=[pcr[0], pcr[3], pcr[1], pcr[4]], vmin=0, vmax=1)
    fig.colorbar(im, ax=ax, label="confidence")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if save_path:
        plt.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close()
    return ax


def replay_offline_topic(topic_dir: str, out_dir: str,
                         point_cloud_range=(0, -2.56, -3, 6.4, 2.56, 3)):
    """Render OfflinePublisher recordings to PNGs (the headless analogue of
    scripts/rviz_show_predictions.py)."""
    import glob
    import os
    import pickle

    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for path in sorted(glob.glob(f"{topic_dir}/*.pkl")):
        with open(path, "rb") as f:
            rec = pickle.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        if isinstance(rec, dict) and "centers" in rec:
            boxes = np.concatenate(
                [rec["centers"], rec["dims"], rec["yaws"][:, None]], axis=1)
            plot_bev(pred_boxes=boxes, scores=rec.get("confidences"),
                     point_cloud_range=point_cloud_range,
                     save_path=f"{out_dir}/{name}.png")
        else:
            plot_bev(points=rec, point_cloud_range=point_cloud_range,
                     save_path=f"{out_dir}/{name}.png")
        outs.append(f"{out_dir}/{name}.png")
    return outs
