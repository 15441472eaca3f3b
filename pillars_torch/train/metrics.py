"""Streaming train-time metrics (pillars_tpu/train/metrics.py; reference
libraries/metrics.py:33-198, which its train loop never ran): state in,
state out, computed on the device inside the train step, read by the host
only when logged.

The reference's quirks are kept:
- Scalar skips zero values (metrics.py:41-43);
- Accuracy counts matches UNWEIGHTED while counting examples weighted
  (metrics.py:80-82);
- PrecisionRecall freezes a threshold's accumulators on batches with no
  candidates for it (metrics.py:128-134);
- default weights mask ``labels != -1`` (ignore index).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pillars_torch import device_constant

PR_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95)
IGNORE_IDX = -1


def _zeros(n=(), device=None):
    return torch.zeros(n, dtype=torch.float32, device=device)


class ScalarState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, device=None) -> "ScalarState":
        return cls(_zeros(device=device), _zeros(device=device))

    @property
    def value(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)


def scalar_update(state: ScalarState, value: torch.Tensor) -> ScalarState:
    """Running mean that ignores exact-zero values (metrics.py:39-43)."""
    value = value.detach().float()
    nz = (value != 0.0).float()
    return ScalarState(state.total + nz * value, state.count + nz)


class AccuracyState(NamedTuple):
    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, device=None) -> "AccuracyState":
        return cls(_zeros(device=device), _zeros(device=device))

    @property
    def value(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)


def _weights(labels, weights):
    if weights is None:
        return (labels != IGNORE_IDX).float()
    return weights.float()


def accuracy_update(state: AccuracyState, labels, cls_preds,
                    weights: Optional[torch.Tensor] = None,
                    threshold: float = 0.5) -> AccuracyState:
    """metrics.py:46-84 (encode_background_as_zeros): the predicted label is
    argmax+1 where any sigmoid score clears the threshold, else 0. labels
    [B, A], cls_preds [B, A, C]."""
    scores = torch.sigmoid(cls_preds)
    labels_pred = cls_preds.argmax(dim=-1) + 1
    pred_labels = torch.where((scores > threshold).any(dim=-1), labels_pred,
                              torch.zeros_like(labels_pred))
    weights = _weights(labels, weights)
    num_examples = torch.clamp(weights.sum(), 1.0, 1e6)
    # quirk kept: matches counted UNWEIGHTED (metrics.py:80-82)
    total = (pred_labels == labels).float().sum()
    return AccuracyState(state.total + total, state.count + num_examples)


class PrecisionRecallState(NamedTuple):
    prec_total: torch.Tensor
    prec_count: torch.Tensor
    rec_total: torch.Tensor
    rec_count: torch.Tensor

    @classmethod
    def init(cls, n: int = len(PR_THRESHOLDS), device=None
             ) -> "PrecisionRecallState":
        return cls(*(_zeros((n,), device) for _ in range(4)))

    @property
    def precision(self) -> torch.Tensor:
        return self.prec_total / torch.clamp(self.prec_count, 1.0, 1e5)

    @property
    def recall(self) -> torch.Tensor:
        return self.rec_total / torch.clamp(self.rec_count, 1.0, 1e5)


def precision_recall_update(state: PrecisionRecallState, labels, cls_preds,
                            weights: Optional[torch.Tensor] = None,
                            thresholds: Tuple[float, ...] = PR_THRESHOLDS
                            ) -> PrecisionRecallState:
    """metrics.py:87-141: binary foreground PR at fixed score thresholds,
    all thresholds at once. labels [B, A], cls_preds [B, A, C]."""
    scores = torch.sigmoid(cls_preds).amax(dim=-1).reshape(-1)
    weights = _weights(labels, weights).reshape(-1)
    trues = (labels > 0).reshape(-1)
    thr = device_constant(thresholds, scores.dtype, scores.device)
    pred_trues = scores[None, :] > thr[:, None]                   # [T, N]
    tp = (weights * (trues & pred_trues).float()).sum(dim=1)
    fp = (weights * (~trues & pred_trues).float()).sum(dim=1)
    fn = (weights * (trues & ~pred_trues).float()).sum(dim=1)
    rec_count, prec_count = tp + fn, tp + fp
    # quirk kept: accumulators freeze on a batch with no candidates for the
    # threshold (metrics.py:128-134)
    rgate = (rec_count > 0).float()
    pgate = (prec_count > 0).float()
    return PrecisionRecallState(state.prec_total + pgate * tp,
                                state.prec_count + pgate * prec_count,
                                state.rec_total + rgate * tp,
                                state.rec_count + rgate * rec_count)


class TrainMetricsState(NamedTuple):
    """Aggregate of the reference's update_metrics (metrics.py:166-198)."""

    rpn_acc: AccuracyState
    rpn_pr: PrecisionRecallState
    rpn_cls_loss: ScalarState
    rpn_loc_loss: ScalarState

    @classmethod
    def init(cls, device=None) -> "TrainMetricsState":
        return cls(AccuracyState.init(device), PrecisionRecallState.init(
            device=device), ScalarState.init(device), ScalarState.init(device))


def update_metrics(state: TrainMetricsState, cls_loss, loc_loss, cls_preds,
                   labels, num_class: int,
                   sampled: Optional[torch.Tensor] = None):
    """One streaming update (reference metrics.py:166-198); returns
    (new_state, dict of the current running values). cls_preds [B, ..., C]
    is reshaped to [B, A, C] like the reference."""
    b = cls_preds.shape[0]
    cls_preds = cls_preds.detach().float().reshape(b, -1, num_class)
    labels = labels.long()
    acc = accuracy_update(state.rpn_acc, labels, cls_preds, sampled)
    pr = precision_recall_update(state.rpn_pr, labels, cls_preds, sampled)
    cl = scalar_update(state.rpn_cls_loss, cls_loss)
    ll = scalar_update(state.rpn_loc_loss, loc_loss)
    ret = {
        "cls_loss": cl.value,
        "cls_loss_rt": cls_loss.detach(),
        "loc_loss": ll.value,
        "loc_loss_rt": loc_loss.detach(),
        "rpn_acc": acc.value,
    }
    precision, recall = pr.precision, pr.recall
    for i, thresh in enumerate(PR_THRESHOLDS):
        ret[f"prec@{int(thresh * 100)}"] = precision[i]
        ret[f"rec@{int(thresh * 100)}"] = recall[i]
    return TrainMetricsState(acc, pr, cl, ll), ret
