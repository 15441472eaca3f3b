"""One sensor in a closed loop through the detector's inference entry,
``PillarsDetector.make_inference_fn``, batch 1: for configurations whose
clouds carry more than xyz, which ``run_stream`` cannot serve (it stages
three columns).

The loop does what ``run_stream`` does for one frame with a window of 1:
the cloud copied into a pinned host buffer with a zero tail, one call (on
the card the replay of the captured graph), the predictions fetched through
``HostFetch``, the detections filtered by ``runtime.prediction_min_score``.
The next cloud is handed over when the previous cloud's detections are on
the host. The first call, which captures, comes before the warm-up.

Traffic parameters: ``bank``, ``warmup``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.loops._window import Window


def run(cell):
    from pillars_torch.models.detector import HostFetch

    cfg, det, bank = cell.cfg, cell.detector, cell.bank
    maxpts = cfg.model.voxel.max_points
    dim = cfg.model.num_point_features
    min_score = cfg.runtime.prediction_min_score
    state = det.state_to_device(cell.state)
    eye = torch.eye(4, dtype=torch.float32, device=det.device)[None]
    infer = det.make_inference_fn(cfg.eval_input.anchor_area_threshold)
    infer(state, np.zeros((1, maxpts, dim), np.float32),
          np.asarray([0], np.int32), eye, eye)
    if det.device.type == "cuda":
        torch.cuda.synchronize(det.device)
    staging = torch.zeros((1, maxpts, dim), dtype=torch.float32,
                          pin_memory=det.device.type == "cuda")
    pts = staging.numpy()
    win = Window(cell, cell.traffic["warmup"])
    deliveries = []
    sent = 0
    while True:
        idx = sent % len(bank)
        sent += 1
        t0 = time.perf_counter()
        cloud = bank[idx]
        n = min(len(cloud), maxpts)
        pts[0, :n] = cloud[:n, :dim]
        pts[0, n:] = 0.0
        out = HostFetch(infer(state, staging, np.asarray([n], np.int32),
                              eye, eye)).result()
        keep = out.valid[0] & (out.scores[0] >= min_score)
        deliveries.append((idx, out.boxes_lidar[0][keep], out.scores[0][keep]))
        if not win.delivered(idx, t0):
            break
    return win.record(in_flight=1, deliveries=deliveries, attempted=sent,
                      delivered=len(deliveries), slots=1)
