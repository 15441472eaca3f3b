"""Metric logging with the reference's wandb key names, pluggable sinks
(a copy of pillars_tpu/train/metrics_log.py; values may be tensors on the
card, read with ``float``).

reference libraries/train_helper_functions.py:6-40: loss scalars every 10
steps ('loc_loss_reduced', 'cls_loss_reduced', 'dir_loss_reduced', 'loss',
'learning_rate', 'epochs'), 18 eval APs + average per epoch ('ev_3d_50'
... 'ev_3d_75', 'ev_aos_50' ... 'ev_aos_75', 'ev_bev_70' ... 'ev_bev_95'
-- the BEV columns are labeled by the BEV IoU ladder 0.70-0.95, not the
3D ladder -- and 'avg'). Key names match the reference's actual wandb
keys for dashboard comparability. Sinks: wandb (if importable +
configured), CSV, stdout.
"""

from __future__ import annotations

import csv
import os
import sys
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, use_wandb: bool = False,
                 wandb_project: str = "pillars_torch", run_name: str = "run"):
        self.sinks = []
        self._csv_path = None
        self._csv_keys = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=run_name)
                self._wandb = wandb
            except Exception as e:  # wandb genuinely optional
                print(f"[metrics] wandb unavailable ({e}); falling back to CSV",
                      file=sys.stderr)

    # ------------------------------------------------------------------
    def log(self, step: int, metrics: Dict[str, float]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._csv_path:
            row = {"step": step, "time": time.time(), **metrics}
            new_keys = [k for k in row if k not in (self._csv_keys or [])]
            if new_keys:
                # key set grew (train-step keys vs eval keys): rewrite the
                # file with the merged header so every row stays aligned
                self._csv_keys = (self._csv_keys or []) + new_keys
                old_rows = []
                if os.path.exists(self._csv_path):
                    with open(self._csv_path, newline="") as f:
                        old_rows = list(csv.DictReader(f))
                with open(self._csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._csv_keys,
                                       extrasaction="ignore")
                    w.writeheader()
                    for r in old_rows:
                        w.writerow(r)
                    w.writerow(row)
            else:
                with open(self._csv_path, "a", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._csv_keys,
                                       extrasaction="ignore")
                    w.writerow(row)

    # ------------------------------------------------------------------
    def log_train_step(self, step: int, epoch: int, m,
                       extra: Optional[Dict[str, float]] = None) -> None:
        """reference log_wandb_loss (train_helper_functions.py:6-14).
        ``extra``: e.g. the streaming train-metrics dict
        (train/metrics.py::update_metrics) when train.train_metrics is on."""
        row = {
            "loc_loss_reduced": m.loc_loss_reduced,
            "cls_loss_reduced": m.cls_loss_reduced,
            "dir_loss_reduced": m.dir_loss_reduced,
            "loss": m.loss,
            "learning_rate": m.learning_rate,
            "epochs": epoch,
        }
        if extra:
            row.update(extra)
        self.log(step, row)

    def log_eval(self, step: int, mAP3d, mAPaos, mAPbev, score: float,
                 extra: Optional[Dict[str, float]] = None) -> None:
        """reference log_wandb_eval (train_helper_functions.py:18-40).
        BEV columns carry the reference's 70-95 labels (its BEV IoU
        ladder); 3d/aos carry 50-75. ``extra``: repo-local detection-
        quality proxies (eval/proxies.py) appended to the same row."""
        metrics = {}
        for i, t in enumerate(["50", "55", "60", "65", "70", "75"]):
            metrics[f"ev_3d_{t}"] = mAP3d[0][0][i]
            metrics[f"ev_aos_{t}"] = (mAPaos[0][0][i]
                                      if mAPaos is not None else 0.0)
        for i, t in enumerate(["70", "75", "80", "85", "90", "95"]):
            metrics[f"ev_bev_{t}"] = mAPbev[0][0][i]
        metrics["avg"] = score
        if extra:
            metrics.update(extra)
        self.log(step, metrics)
