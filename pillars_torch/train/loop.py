"""The train step and training state (pillars_tpu/train/loop.py).

One body per step, on device tensors, with no host sync and no host
constant: voxelization, anchors mask, target assignment, forward in train
mode, loss, backward, optimizer update (:func:`train_body`). On the card,
:func:`make_train_step` returns the counterpart of the JAX package's
``jax.jit(step, donate_argnums=(0,))``: a :class:`CapturedTrainStep` that
replays one captured CUDA graph per batch shape
(pillars_torch/cuda_graph.py), its state donated: the state it returns holds
the graph's static tensors, updated in place by every step. Over a mesh of
NCCL ranks too, the collectives inside the graph, as XLA puts them inside
the jitted program over a ``Mesh``. The CPU, and a mesh over gloo (whose
collectives copy through host memory, which a graph cannot hold), run the
same body op by op; the state is then passed in and a new one returned, and
none of the tensors handed in changes.

Over several ranks (the detector's ``mesh``, pillars_torch/parallel/), each
rank passes its block of the global batch (``parallel.shard_batch``); the
train-mode BNs reduce their statistics over the ranks, and after the
backward ONE all-reduce over a flat buffer of every gradient leaf (of the
trainable parameters: a frozen one takes no gradient) sums them
over the spatial ranks and averages them over the data ranks. AdamW then
runs alike on every rank, so the parameters stay identical. Loss parts
(each rank's divided by its own batch) are averaged and ``num_positives``
summed over the data ranks: the global batch's values.

Batch layout (dense, padded; NumPy arrays or tensors):
    points      [B, MAXPTS, D] float32
    num_points  [B]            int32
    gt_boxes    [B, G, 7]      float32 (padding rows have dims == 1)
    gt_classes  [B, G]         int32
    gt_valid    [B, G]         bool
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from pillars_torch.cuda_graph import CapturedCall, StaticState
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.models.losses import LossOutput
from pillars_torch.ops.targets import TargetAssignment
from pillars_torch.parallel.collectives import (all_gather_cat,
                                                all_reduce_flat)
from pillars_torch.train import metrics as tm
from pillars_torch.train.optim import AdamState, AdamW
from pillars_torch.utils import tracing

# what the step reads of a batch, and the dtypes it reads them in
BATCH_KEYS = ("points", "num_points", "gt_boxes", "gt_classes", "gt_valid")
BATCH_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32,
                torch.bool)
# the spans of the train body (utils/tracing.py), in order; under
# torch.profiler each is a record_function range of its name
TRAIN_STAGES = ("voxelize", "anchors_mask", "assign_targets", "forward",
                "loss", "backward", "adamw")
_STAT_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState


class StepMetrics(NamedTuple):
    """Names follow the reference's wandb keys
    (libraries/train_helper_functions.py:6-14); tensors on the device. The
    first six are :class:`~pillars_torch.models.losses.LossOutput`'s."""

    loss: torch.Tensor
    loc_loss_reduced: torch.Tensor
    cls_loss_reduced: torch.Tensor
    dir_loss_reduced: torch.Tensor
    cls_pos_loss: torch.Tensor
    cls_neg_loss: torch.Tensor
    learning_rate: torch.Tensor
    num_positives: torch.Tensor


def split_state(state: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A network ``state_dict`` -> (parameters, BN statistics)."""
    stats = {k: v for k, v in state.items()
             if k.rsplit(".", 1)[-1] in _STAT_LEAVES}
    return {k: v for k, v in state.items() if k not in stats}, stats


def variables(state: TrainState) -> Dict[str, torch.Tensor]:
    """The network ``state_dict`` of a train state."""
    return {**state.params, **state.batch_stats}


def create_train_state(detector: PillarsDetector, generator: torch.Generator,
                       batch_size: int) -> Tuple[TrainState, AdamW]:
    params, stats = split_state(detector.init(generator, batch_size))
    opt = AdamW(detector.config.train.optimizer, batch_size)
    return TrainState(0, params, stats, opt.init(params)), opt


def batch_to_device(batch, device, keys=BATCH_KEYS
                    ) -> Dict[str, torch.Tensor]:
    """The ``keys`` entries of ``batch`` (arrays or tensors) as tensors on
    ``device``. Host data bound for the card goes through pinned memory and
    does not block; a tensor already there is passed through."""
    device = torch.device(device)
    out = {}
    for key in keys:
        t = torch.as_tensor(batch[key])
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[key] = t.to(device, non_blocking=True)
    return out


class Gradients(NamedTuple):
    """What one forward + backward of a batch gives."""

    loss: LossOutput
    grads: Dict[str, torch.Tensor]       # by parameter name
    batch_stats: Dict[str, torch.Tensor]  # the new BN statistics
    targets: TargetAssignment
    cls_preds: torch.Tensor
    num_positives: torch.Tensor  # int32, over the global batch


def _data_group(detector: PillarsDetector):
    mesh = detector.mesh
    if mesh is None:
        return None, 1
    axis = detector.config.runtime.data_axis
    return mesh.group(axis), mesh.axis_size(axis)


def forward_backward(detector: PillarsDetector, state: TrainState, batch,
                     anchor_area_threshold: float) -> Gradients:
    """Voxelize, anchors mask and targets (no gradient), then the train-mode
    forward, the loss and its gradient with respect to every parameter; the
    batch anywhere (:func:`gradients` on it, moved to the device)."""
    return gradients(detector, state.params, state.batch_stats,
                     batch_to_device(batch, detector.device),
                     anchor_area_threshold)


def gradients(detector: PillarsDetector, params: Dict[str, torch.Tensor],
              batch_stats: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor], thr: float,
              names: Optional[Sequence[str]] = None) -> Gradients:
    """:func:`forward_backward`'s body on a batch on the device: no host
    sync, no host constant (what a graph captures), and over a mesh the
    collectives.

    ``names``: the parameters to differentiate (default every one); the
    others go in as constants, so the backward stops at the first layer
    that holds a named parameter, as XLA drops what optax's
    ``set_to_zero`` never reads (``freeze_patterns``). ``grads`` holds the
    named leaves alone, and over a mesh only they are summed. The frozen
    layers' BN statistics are updated all the same."""
    with torch.no_grad():
        with tracing.span("voxelize"):
            vox = detector.voxelize_batch(batch["points"],
                                          batch["num_points"])
        with tracing.span("anchors_mask"):
            amask = detector.anchors_mask_batch(vox.coords, vox.pillar_mask,
                                                thr)
        with tracing.span("assign_targets"):
            targets = detector.assign_targets(
                batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
                amask)
    names = list(params) if names is None else list(names)
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items() if k in names}
        with tracing.span("forward"):
            preds, new_stats = detector.apply(
                {**params, **leaves, **batch_stats}, vox, train=True)
        with tracing.span("loss"):
            out = detector.loss(preds, targets.labels, targets.bbox_targets)
        with tracing.span("backward"):
            grads = torch.autograd.grad(out.loss,
                                        [leaves[k] for k in names],
                                        allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
    out = LossOutput(*(t.detach() for t in out))
    n_pos = (targets.labels > 0).sum(dtype=torch.int32)
    if detector.mesh is not None:
        grads = dict(zip(grads, all_reduce_flat(
            grads.values(), detector.mesh.group(), detector.grad_scale)))
        group, n_data = _data_group(detector)
        if group is not None:
            *parts, n_pos = all_reduce_flat(
                list(out) + [n_pos.to(out.loss.dtype)], group)
            out = LossOutput(*(p / n_data for p in parts))
            n_pos = n_pos.round().to(torch.int32)
    return Gradients(out, grads, new_stats, targets,
                     preds["cls_preds"].detach(), n_pos)


class StepOutput(NamedTuple):
    """What one step computes (:func:`train_body`)."""

    params: Dict[str, torch.Tensor]       # every parameter, new
    batch_stats: Dict[str, torch.Tensor]  # every BN statistic, new
    mu: Dict[str, torch.Tensor]           # Adam's moments, new
    nu: Dict[str, torch.Tensor]
    metrics: StepMetrics
    fb: Gradients


def train_body(detector: PillarsDetector, opt: AdamW, thr: float,
               params: Dict[str, torch.Tensor],
               batch_stats: Dict[str, torch.Tensor],
               mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
               counts: torch.Tensor, batch: Dict[str, torch.Tensor]
               ) -> StepOutput:
    """One step on device tensors, the same for the eager and the captured
    step. ``counts``: int32 [2] on the device, the state's step (the rate
    of the metrics) and Adam's count (the update's). Only the leaves that
    Adam moves (``mu``'s: every one unless ``freeze_patterns``) are
    differentiated."""
    fb = gradients(detector, params, batch_stats, batch, thr, names=mu)
    with tracing.span("adamw"):
        new_params, new_mu, new_nu = opt.step(fb.grads, mu, nu, params,
                                              counts[1])
    metrics = StepMetrics(*fb.loss, learning_rate=opt.schedule(counts[0]),
                          num_positives=fb.num_positives)
    return StepOutput(new_params, {**batch_stats, **fb.batch_stats}, new_mu,
                      new_nu, metrics, fb)


def _metrics_body(detector: PillarsDetector, tm_state, fb: Gradients):
    """The streaming train metrics of one step (of the global batch over
    the data ranks)."""
    cls_preds, labels = fb.cls_preds, fb.targets.labels
    group, n_data = _data_group(detector)
    if n_data > 1:
        cls_preds = all_gather_cat(cls_preds, group)
        labels = all_gather_cat(labels, group)
    return tm.update_metrics(
        tm_state, fb.loss.cls_loss_reduced, fb.loss.loc_loss_reduced,
        cls_preds, labels, detector.config.model.num_class)


def _counts(state: TrainState) -> torch.Tensor:
    """The state's step and Adam count as an int32 [2] host tensor."""
    return torch.tensor([state.step, state.opt_state.count],
                        dtype=torch.int32)


def make_train_step(detector: PillarsDetector, opt: AdamW,
                    anchor_area_threshold: Optional[float] = None,
                    with_metrics: bool = False, donate: bool = True):
    """``step(state, batch) -> (state, StepMetrics)``.

    ``with_metrics=True`` (config ``train.train_metrics``) also threads a
    :class:`pillars_torch.train.metrics.TrainMetricsState` through the
    step: ``step(state, tm_state, batch) -> (state, tm_state, StepMetrics,
    running-values dict)``.

    On the card a :class:`CapturedTrainStep`, whose returned states hold
    its static tensors (``donate=False``: copies of them), unless a
    collective of the body runs over gloo (``PillarsDetector.captures``):
    then, and on the CPU, the eager step. Either has the eager step as its
    ``eager`` attribute (the eager one itself). Over a mesh, every rank
    takes the same steps at the same batch shapes, so every rank captures
    at the same call and replays its collectives in the same order; the
    mesh's host constants (``grad_scale``, the data ranks) are fixed, and
    the graph holds them."""
    thr = (detector.config.train_input.anchor_area_threshold
           if anchor_area_threshold is None else anchor_area_threshold)
    dev = detector.device

    def _core(state: TrainState, batch):
        out = train_body(detector, opt, thr, state.params, state.batch_stats,
                         state.opt_state.mu, state.opt_state.nu,
                         _counts(state).to(dev, non_blocking=True),
                         batch_to_device(batch, dev))
        new_state = TrainState(state.step + 1, out.params, out.batch_stats,
                               AdamState(state.opt_state.count + 1, out.mu,
                                         out.nu))
        return new_state, out

    if not with_metrics:
        def step(state: TrainState, batch):
            new_state, out = _core(state, batch)
            return new_state, out.metrics
    else:
        def step(state: TrainState, tm_state: tm.TrainMetricsState, batch):
            new_state, out = _core(state, batch)
            new_tm, values = _metrics_body(detector, tm_state, out.fb)
            return new_state, new_tm, out.metrics, values

    step.eager = step
    if not detector.captures(True):
        return step
    return CapturedTrainStep(detector, opt, thr, with_metrics, donate, step)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple of NamedTuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _rebuild(like, leaves):
    """A tree shaped as ``like`` from an iterator of tensors."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    return type(like)(*(_rebuild(sub, leaves) for sub in like))


def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    """``dst[i].copy_(src[i])``, one multi-tensor copy per dtype."""
    by_dtype: Dict[torch.dtype, Tuple[list, list]] = {}
    for d, s in zip(dst, src):
        pair = by_dtype.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in by_dtype.values():
        torch._foreach_copy_(d, s)


class CapturedTrainStep:
    """The train step of :func:`make_train_step` on the card, replaying one
    captured graph per batch shape: the counterpart of the JAX package's
    ``jax.jit(step, donate_argnums=(0,))``.

    The graph reads and writes :class:`~pillars_torch.cuda_graph.
    StaticState` tensors: the parameters, BN statistics, Adam moments and,
    with metrics, the streaming metrics' state. A call copies in each
    tensor of the state it is handed that the static tensors do not hold
    already (nothing, for the state the last call returned), stages the
    step and Adam count (host ints, as int32 [2]) and the batch into the
    graph's static inputs, replays, bumps the versions of what the graph
    wrote, and returns a state of the static tensors (``donate``) or of
    copies of them; the metrics are copies. The first call at a batch shape
    runs the body eagerly on a side stream, which takes that step, and then
    captures it. ``eager`` is the eager step, ``static`` the static state,
    ``call`` the :class:`~pillars_torch.cuda_graph.CapturedCall`."""

    def __init__(self, detector: PillarsDetector, opt: AdamW, thr: float,
                 with_metrics: bool, donate: bool, eager):
        self.detector = detector
        self.opt = opt
        self.thr = thr
        self.with_metrics = with_metrics
        self.donate = donate
        self.eager = eager
        self.static = StaticState()
        self.call = CapturedCall(self._body, detector.device,
                                 (torch.int32,) + BATCH_DTYPES,
                                 context=torch.no_grad)
        self.graphs = self.call.graphs
        self._written: Tuple[str, ...] = ()
        self._value_keys: Tuple[str, ...] = ()
        self._tm_like = None
        self._names: Optional[Dict[str, List[Tuple[str, str]]]] = None

    def _flat(self, state: TrainState, tm_state) -> Dict[str, torch.Tensor]:
        flat = {}
        for prefix, d in (("params", state.params),
                          ("stats", state.batch_stats),
                          ("mu", state.opt_state.mu),
                          ("nu", state.opt_state.nu)):
            flat.update((f"{prefix}/{k}", v) for k, v in d.items())
        if tm_state is not None:
            flat.update((f"tm/{i}", t) for i, t in enumerate(
                _leaves(tm_state)))
        return flat

    def _part(self, prefix: str) -> Dict[str, torch.Tensor]:
        """The static tensors of one part of the state (``params``,
        ``stats``, ``mu``, ``nu``) by their names in it."""
        if self._names is None:
            self._names = {}
            for full in self.static.tensors:
                head, name = full.split("/", 1)
                self._names.setdefault(head, []).append((name, full))
        st = self.static.tensors
        return {name: st[full]
                for name, full in self._names.get(prefix, [])}

    def _body(self, counts, *batch):
        st = self.static.tensors
        out = train_body(self.detector, self.opt, self.thr,
                         self._part("params"), self._part("stats"),
                         self._part("mu"), self._part("nu"), counts,
                         dict(zip(BATCH_KEYS, batch)))
        pairs = [(f"params/{k}", out.params[k]) for k in out.mu]
        pairs += [(f"stats/{k}", v) for k, v in out.fb.batch_stats.items()]
        pairs += [(f"mu/{k}", v) for k, v in out.mu.items()]
        pairs += [(f"nu/{k}", v) for k, v in out.nu.items()]
        results = list(out.metrics)
        if self.with_metrics:
            tm_state = _rebuild(self._tm_like, iter(
                st[f"tm/{i}"] for i in range(len(_leaves(self._tm_like)))))
            new_tm, values = _metrics_body(self.detector, tm_state, out.fb)
            pairs += [(f"tm/{i}", t) for i, t in enumerate(_leaves(new_tm))]
            self._value_keys = tuple(values)
            results += [values[k] for k in self._value_keys]
        _copy_into([st[k] for k, _ in pairs], [v for _, v in pairs])
        self._written = tuple(k for k, _ in pairs)
        return results

    def __call__(self, state: TrainState, *rest):
        tm_state, batch = rest if self.with_metrics else (None, rest[0])
        if tm_state is not None:
            self._tm_like = tm_state
        with torch.no_grad():
            self.static.load(self._flat(state, tm_state),
                             self.detector.device)
        outs = self.call(_counts(state), *(batch[k] for k in BATCH_KEYS))
        self.static.written(self._written)
        keep = (lambda t: t) if self.donate else torch.Tensor.clone
        part = lambda prefix: {k: keep(v)  # noqa: E731
                               for k, v in self._part(prefix).items()}
        new_state = TrainState(state.step + 1, part("params"), part("stats"),
                               AdamState(state.opt_state.count + 1,
                                         part("mu"), part("nu")))
        metrics = StepMetrics(*outs[:len(StepMetrics._fields)])
        if not self.with_metrics:
            return new_state, metrics
        st = self.static.tensors
        new_tm = _rebuild(tm_state, iter(
            keep(st[f"tm/{i}"]) for i in range(len(_leaves(tm_state)))))
        values = dict(zip(self._value_keys, outs[len(StepMetrics._fields):]))
        return new_state, new_tm, metrics, values
