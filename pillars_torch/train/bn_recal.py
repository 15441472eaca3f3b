"""AdaBN-style BatchNorm recalibration for evaluation
(pillars_tpu/train/bn_recal.py; Li et al., arXiv:1603.04779).

The running statistics average over the TRAINING distribution (sampler-
pasted objects, global augmentation), which is not the eval distribution.
Before evaluating, K forward passes in train mode over unaugmented scenes
(the train split read through the eval-mode pipeline, no labels) refresh
them with a fast EMA momentum. Parameters are untouched; only the BN
statistics of the state handed to the eval call are replaced.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from pillars_torch.config import Config


def build_recal_fn(cfg: Config, momentum: float = 0.9, device=None):
    """step(state, points, num_points) -> the new BN statistics as
    ``state`` entries. The recal detector is the SAME network with every BN
    momentum set to ``momentum`` (same names; only the EMA constant
    differs), applied in train mode. After K batches the initial statistics
    keep a weight of ``momentum**K`` (0.9**32 ~ 0.03)."""
    from pillars_torch.models.detector import PillarsDetector

    cfg2 = (cfg.override("model.pfn.bn_momentum", momentum)
               .override("model.rpn.bn_momentum", momentum))
    det = PillarsDetector(cfg2, device=device)

    @torch.no_grad()
    def step(state, points, num_points):
        points = torch.as_tensor(points).to(det.device, non_blocking=True)
        num_points = torch.as_tensor(num_points).to(det.device,
                                                    non_blocking=True)
        vox = det.voxelize_batch(points, num_points)
        _, new_stats = det.apply(state, vox, train=True)
        return new_stats

    return step


def recalibrate(cfg: Config, state: Dict[str, torch.Tensor],
                batches: List[Dict], momentum: float = 0.9, step=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Refresh the BN statistics of ``state`` over ``batches`` (each with
    'points' [B, N, D] and 'num_points' [B]). Returns a NEW state dict; the
    one handed in is untouched. Pass a cached ``step`` from
    :func:`build_recal_fn` when calling repeatedly."""
    if step is None:
        step = build_recal_fn(cfg, momentum, device)
    for b in batches:
        state = {**state, **step(state, b["points"], b["num_points"])}
    return state
