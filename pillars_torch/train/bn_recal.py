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
from pillars_torch.cuda_graph import CapturedCall, StaticState


def build_recal_fn(cfg: Config, momentum: float = 0.9, device=None):
    """step(state, points, num_points) -> the new BN statistics as
    ``state`` entries. The recal detector is the SAME network with every BN
    momentum set to ``momentum`` (same names; only the EMA constant
    differs), applied in train mode. After K batches the initial statistics
    keep a weight of ``momentum**K`` (0.9**32 ~ 0.03).

    On the card, the counterpart of the JAX package's ``jax.jit`` of this
    step: a :class:`CapturedRecal` replaying one captured graph per batch
    shape, which writes the new statistics in place into its static tensors
    and returns those; the recal detector has no mesh, so this holds on
    every rank of a distributed ``Evaluator`` too. On the CPU the eager
    step. Either has the eager step as its ``eager`` attribute."""
    from pillars_torch.models.detector import PillarsDetector

    cfg2 = (cfg.override("model.pfn.bn_momentum", momentum)
               .override("model.rpn.bn_momentum", momentum))
    det = PillarsDetector(cfg2, device=device)

    @torch.no_grad()
    def step(state, points, num_points):
        points = torch.as_tensor(points).to(det.device, non_blocking=True)
        num_points = torch.as_tensor(num_points).to(det.device,
                                                    non_blocking=True)
        return recal_body(det, state, points, num_points)

    step.eager = step
    if not det.captures(True):
        return step
    return CapturedRecal(det, step)


def recal_body(det, state: Dict[str, torch.Tensor], points: torch.Tensor,
               num_points: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One recalibration forward on device tensors (no host sync, no host
    constant): the new BN statistics."""
    vox = det.voxelize_batch(points, num_points)
    _, new_stats = det.apply(state, vox, train=True)
    return new_stats


class CapturedRecal:
    """The recalibration step on the card: ``step(state, points,
    num_points)`` copies in each tensor of ``state`` that its static
    tensors do not hold already (the parameters once, and nothing of the
    statistics it returned last), replays the graph of the batch shape,
    which writes the new statistics into the static tensors, and returns
    those: each call's statistics are the next call's input, in place, and
    are overwritten by the next call."""

    def __init__(self, det, eager):
        self.det = det
        self.eager = eager
        self.static = StaticState()
        self.call = CapturedCall(self._body, det.device,
                                 (torch.float32, torch.int32),
                                 context=torch.no_grad)
        self.graphs = self.call.graphs
        self._written = ()

    def _body(self, points, num_points):
        st = self.static.tensors
        new = recal_body(self.det, st, points, num_points)
        torch._foreach_copy_([st[k] for k in new], list(new.values()))
        self._written = tuple(new)
        return []

    def __call__(self, state, points, num_points):
        with torch.no_grad():
            self.static.load(state, self.det.device)
        self.call(points, num_points)
        self.static.written(self._written)
        return {k: self.static.tensors[k] for k in self._written}


def recalibrate(cfg: Config, state: Dict[str, torch.Tensor],
                batches: List[Dict], momentum: float = 0.9, step=None,
                device=None) -> Dict[str, torch.Tensor]:
    """Refresh the BN statistics of ``state`` over ``batches`` (each with
    'points' [B, N, D] and 'num_points' [B]). Returns a NEW state dict; the
    one handed in is untouched (on the card its statistics are the captured
    step's static tensors, valid until the step's next call). Pass a cached
    ``step`` from :func:`build_recal_fn` when calling repeatedly."""
    if step is None:
        step = build_recal_fn(cfg, momentum, device)
    for b in batches:
        state = {**state, **step(state, b["points"], b["num_points"])}
    return state
