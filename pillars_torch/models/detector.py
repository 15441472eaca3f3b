"""The detector (pillars_tpu/models/detector.py): voxelize -> PFN ->
canvas -> RPN -> [train] targets + loss | [eval] decode + top-k + NMS +
direction flip, with fixed-size outputs and a validity mask.

The networks of the JAX package. ``apply`` (the network every config trains
through): the point-major ``VoxelizedPoints`` -> ``PointwisePFN``, or the
dense ``VoxelizedSample`` -> ``PillarFeatureNet`` (``pfn.pointwise`` off),
or SECOND's SimpleVoxel means (``pfn.simple_mean``); then the canvas
scatter, or SECOND's sparse or dense 3D middle (``middle.enabled``); then
the RPN. With ``rpn.use_pallas_blocks`` the point-major PointPillars
inference path runs the three downsample blocks as the fused kernel
(``_forward_fast``: ``ops/rpn_blocks.py``, the CUDA kernel on the card, its
plain twin on the CPU) and ``RPNTail`` follows. Dense cell
(``_forward_dense``, inference on the default config): the pillar space is
the cell grid and the canvas a reshape. The networks read one state dict.

Precision: the JAX reference on the CPU computes in full f32, while cuDNN
convolutions default to TF32 (about 3 decimal digits). Every stage of these
paths therefore turns TF32 off for convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``, process-wide flags).

``runtime.compute_dtype=bfloat16``: every network computes in bfloat16 at
the JAX package's rounding points (models/layers.py), the fused blocks read
and write bfloat16 and compute in float32 (ops/rpn_cuda.py), and the heads
come out in bfloat16; ``postprocess`` and the loss cast them to float32, so
predictions and losses stay float32. In train mode (``apply(train=True)``)
the BNs take their batch statistics in float32, the parameters stay
float32 and receive float32 gradients through the casts.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pillars_torch import resolve_device
from pillars_torch.config import Config, ModelConfig
from pillars_torch.cuda_graph import (CapturedCall, CapturedInference,
                                      StaticState)
from pillars_torch.geometry import boxes as gb
from pillars_torch.models.layers import BatchNorm, collect_batch_stats
from pillars_torch.models.losses import LossOutput, detection_loss
from pillars_torch.models.middle import (MiddleExtractor3D, output_depth,
                                         scatter_to_grid3d)
from pillars_torch.models.pfn import (DenseCellPFN, PillarFeatureNet,
                                      PointwisePFN)
from pillars_torch.models.rpn import RPN, RPNTail
from pillars_torch.models.sparse_middle import (SparseMiddleExtractor,
                                                output_dims)
# the kernel wrappers the paths below call: importing them declares their
# launch counters (utils/tracing.py) wherever a detector is
from pillars_torch.ops import (bn_relu_cuda, conv_cuda,  # noqa: F401
                               nms_cuda, pfn_cuda, rpn_cuda)
from pillars_torch.ops.anchors import (anchors_mask_batched,
                                       anchors_mask_from_dense, build_anchors,
                                       clamp_sat_tables)
from pillars_torch.ops.nms import nms_standup
from pillars_torch.ops.rpn_blocks import FoldedBlocksCache, fused_rpn_blocks
from pillars_torch.ops.scatter import scatter_to_canvas_batched
from pillars_torch.ops.targets import TargetAssignment, assign_targets_batched
from pillars_torch.ops.voxelize import (VoxelizedPoints, make_cell_voxelizer,
                                        make_point_voxelizer, make_voxelizer)
from pillars_torch.parallel.collectives import graph_safe
from pillars_torch.parallel.spatial import (gather_canvas, halo_exchange,
                                            shard_canvas)
from pillars_torch.utils import tracing


class Predictions(NamedTuple):
    """Fixed-size per-sample detections, [B, K, ...] with K = nms_post_max."""

    boxes_lidar: torch.Tensor   # [B, K, 7]
    boxes_camera: torch.Tensor  # [B, K, 7]
    scores: torch.Tensor        # [B, K]
    labels: torch.Tensor        # [B, K] int32
    valid: torch.Tensor         # [B, K] bool


class HostFetch:
    """The copy of a :class:`Predictions` to the host, enqueued behind the
    work that computes it, and the event that says it has arrived.

    The thread that dispatched the batch makes the object; any thread may
    call :meth:`result`, which waits for THIS batch only (the event, not the
    device: a device-wide synchronize would wait for every later batch too)
    and releases the GIL while it waits. Each fetch owns its pinned
    buffers. On the CPU the predictions are already there. Tracing: the
    spans ``fetch.enqueue`` (the pinned buffers, the copies and the event)
    and ``fetch.wait`` (:meth:`result`, on the thread that calls it, under
    the request id of the dispatch that made the fetch)."""

    def __init__(self, preds: Predictions):
        self.event = None
        with tracing.span("fetch.enqueue"):
            self.rid = tracing.current_rid()
            if preds.valid.is_cuda:
                preds = Predictions(*(
                    torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t, non_blocking=True)
                    for t in preds))
                self.event = torch.cuda.Event()
                self.event.record()
        self._host = preds

    def result(self) -> Predictions:
        """The predictions as NumPy arrays."""
        with tracing.span("fetch.wait", rid=self.rid):
            if self.event is not None:
                self.event.synchronize()
            return Predictions(*(t.numpy() for t in self._host))


def _full_f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def uses_dense_cell(mcfg: ModelConfig) -> bool:
    """The JAX package's rule: the dense-cell front end serves inference on
    every grid that fits in max_voxels, unless a middle extractor is on.
    Also not where its PFN cannot read the network's weights (SimpleVoxel
    has none, and ``PillarFeatureNet`` with ``with_distance`` is a wider
    Dense), configs on which the JAX package's dense cell fails."""
    gx, gy, gz = mcfg.voxel.grid_size
    pcfg = mcfg.pfn
    return (pcfg.dense_cell and not mcfg.middle.enabled
            and not pcfg.simple_mean
            and (pcfg.pointwise or not pcfg.with_distance)
            and gx * gy * gz <= mcfg.voxel.max_voxels)


def canvas_channels(mcfg: ModelConfig) -> int:
    """The channels of the BEV canvas the RPN reads."""
    if mcfg.middle.enabled and mcfg.middle.sparse:
        return output_dims(mcfg)[0] * mcfg.middle.num_filters[-1]
    if mcfg.middle.enabled:
        return output_depth(mcfg) * mcfg.middle.num_filters[-1]
    return voxel_channels(mcfg)


def voxel_channels(mcfg: ModelConfig) -> int:
    """The width of the per-voxel features: SimpleVoxel's point-feature
    means, or the PFN's filters."""
    return (mcfg.num_point_features if mcfg.pfn.simple_mean
            else mcfg.pfn.num_filters)


class Network(nn.Module):
    """PFN + canvas + RPN. Dense cell: ``forward(points, num_valid)`` ->
    (NHWC head tensors, [B, ny, nx] occupied-cell count summed over z).
    Otherwise ``forward(voxelized)`` -> NHWC head tensors, with the front
    end the config names: SimpleVoxel (``pfn.simple_mean``: per-voxel
    means, no parameters), ``PointwisePFN`` over :class:`VoxelizedPoints`
    (``pfn.pointwise``) or ``PillarFeatureNet`` over
    :class:`VoxelizedSample`; then the canvas scatter, or SECOND's sparse or
    dense middle (``middle.enabled``). The networks share parameter names,
    so one checkpoint loads into either. ``dense_cell`` defaults to
    :func:`uses_dense_cell`; ``dtype`` is the compute dtype of every part
    (None: float32)."""

    def __init__(self, mcfg: ModelConfig, dense_cell: Optional[bool] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mcfg = mcfg
        pcfg = mcfg.pfn
        self.dense_cell = (uses_dense_cell(mcfg) if dense_cell is None
                           else dense_cell)
        if self.dense_cell:
            self.pfn = DenseCellPFN(mcfg, dtype)
            self.cell_voxelize = make_cell_voxelizer(mcfg.voxel)
        elif not pcfg.simple_mean:
            self.pfn = (PointwisePFN if pcfg.pointwise
                        else PillarFeatureNet)(mcfg, dtype)
        if mcfg.middle.enabled and not self.dense_cell:
            self.middle = (SparseMiddleExtractor if mcfg.middle.sparse
                           else MiddleExtractor3D)(mcfg, voxel_channels(mcfg),
                                                   dtype)
        self.rpn = RPN(mcfg, canvas_channels(mcfg), dtype)
        # (axis name, mesh) of BEV-grid spatial parallelism, set by the
        # detector: the RPN then runs on this rank's band of canvas rows
        self.spatial = None

    def voxel_features(self, v) -> torch.Tensor:
        """[B, P, C] per-voxel features of a voxelized batch."""
        b, p = v.pillar_mask.shape
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        if self.mcfg.pfn.simple_mean and isinstance(v, VoxelizedPoints):
            # SECOND's SimpleVoxel, the means the voxelizer took scan-wise
            return v.voxel_mean
        if self.mcfg.pfn.simple_mean:
            # padded slots are zero: sum / clamped count is the mean over
            # the real points
            cnt = torch.clamp(v.num_points, min=1).to(v.voxels.dtype)
            return v.voxels.sum(dim=2) / cnt[..., None]
        if isinstance(v, VoxelizedPoints):
            # per-sample pillar ids offset into the folded [B*P] rows; the
            # sentinel segment's id may reach the next sample's row 0, but
            # its points are not kept and cannot win a max
            offset = torch.arange(b, dtype=torch.int32,
                                  device=v.points.device) * p
            feats = self.pfn(flat(v.points),
                             flat(v.point_pillar + offset[:, None]),
                             flat(v.point_kept), flat(v.point_mean),
                             flat(v.point_zyx), flat(v.num_points),
                             flat(v.pillar_mask))
        else:
            feats = self.pfn(flat(v.voxels), flat(v.num_points),
                             flat(v.coords), flat(v.pillar_mask))
        return feats.reshape(b, p, -1)

    def canvas(self, v) -> torch.Tensor:
        """[B, ny, nx, C] BEV canvas of a voxelized batch."""
        feats = self.voxel_features(v)
        mcfg = self.mcfg
        _, ny, nx = mcfg.feature_map_size
        if mcfg.middle.enabled and mcfg.middle.sparse:
            return self.middle(feats, v.coords, v.pillar_mask)
        if mcfg.middle.enabled:
            nz = mcfg.voxel.grid_size[2]
            return self.middle(scatter_to_grid3d(feats, v.coords,
                                                 v.pillar_mask, nz, ny, nx))
        return scatter_to_canvas_batched(feats, v.coords, v.pillar_mask,
                                         ny, nx)

    def forward(self, *inputs, canvas_only: bool = False):
        """``canvas_only``: the BEV canvas without the RPN (not on the dense
        cell)."""
        if not self.dense_cell:
            canvas = self.canvas(*inputs)
            tracing.mark("pfn")
            if canvas_only:
                return canvas
            heads = (self.rpn(canvas) if self.spatial is None
                     else self.banded_rpn(canvas))
            tracing.mark("rpn")
            return heads
        points, num_valid = inputs
        b = points.shape[0]
        nx, ny, nz = self.mcfg.voxel.grid_size
        n_cells = nx * ny * nz
        cv = self.cell_voxelize(points, num_valid)
        tracing.mark("voxelize")
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        offset = torch.arange(b, dtype=torch.int32,
                              device=points.device)[:, None] * n_cells
        cell_global = cv.cell + offset  # stays non-decreasing over the fold
        cell_feats, num_points = self.pfn(
            flat(cv.points), flat(cv.cell), flat(cell_global), flat(cv.kept),
            flat(cv.count), flat(cv.mean), b * n_cells, cv.num_pillars)
        # cell id = (z*ny + y)*nx + x, so the canvas is a reshape; the
        # z-layer SUM keeps the reference's scatter-ADD quirk (in the
        # features' dtype, as the JAX package sums)
        canvas = cell_feats.reshape(b, nz, ny, nx, -1).sum(dim=1)
        dense_grid = (num_points > 0).reshape(b, nz, ny, nx).to(
            torch.float32).sum(dim=1)
        tracing.mark("pfn")
        heads = self.rpn(canvas)
        tracing.mark("rpn")
        return heads, dense_grid

    def banded_rpn(self, canvas):
        """The RPN over this rank's band of the canvas rows, halos
        exchanged with the neighbour bands, the heads gathered whole on
        every rank of the spatial group (parallel/spatial.py)."""
        axis, mesh = self.spatial
        multiple = math.prod(self.mcfg.rpn.layer_strides)
        rows = canvas.shape[1]
        band = shard_canvas(canvas, axis, mesh, multiple)
        heads = self.rpn(band, halo=lambda t: halo_exchange(t, axis, mesh))
        return {k: gather_canvas(v, axis, mesh,
                                 rows * v.shape[1] // band.shape[1],
                                 multiple * v.shape[1] // band.shape[1])
                for k, v in heads.items()}


def _front_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of ``state`` that the canvas reads (all but the RPN's):
    the fewer tensors ``functional_call`` swaps in, the less host time."""
    return {k: v for k, v in state.items() if not k.startswith("rpn.")}


def _sub_state(state: Dict[str, torch.Tensor], module: nn.Module,
               prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``state`` under ``prefix`` that ``module`` holds."""
    return {k: state[prefix + k] for k in module.state_dict()}


COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _reducing(group):
    """``group``, or None where it has one rank and nothing to reduce."""
    if group is None or torch.distributed.get_world_size(group) == 1:
        return None
    return group


class PillarsDetector:
    """Binds the config, the anchor tables and the network on one device;
    the state (weights) is passed to each call, as in the JAX package.
    ``dtype``: the networks' compute dtype from ``runtime.compute_dtype``
    (None for float32).

    ``mesh`` (pillars_torch/parallel/): this rank's place among several.
    Its ``runtime.data_axis`` splits the batch: the train-mode BNs of
    ``apply`` take the statistics of the global batch (the front end's over
    the data axis, the RPN's over every rank). With ``runtime.spatial_axis``
    set, ``apply`` runs the RPN on this rank's band of BEV rows
    (``Network.banded_rpn``); the front end stays replicated within the
    spatial axis. ``apply`` raises when ``runtime.spatial_axis`` names an
    axis the mesh lacks, as the JAX package does; the dense-cell and fused
    inference paths never shard, as there."""

    def __init__(self, config: Config, device=None, mesh=None):
        self.config = config
        self.mcfg = config.model
        if config.runtime.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"runtime.compute_dtype {config.runtime.compute_dtype!r}: "
                f"one of {sorted(COMPUTE_DTYPES)}")
        self.dtype = COMPUTE_DTYPES[config.runtime.compute_dtype]
        self.device = resolve_device(device)
        self.dense_cell = uses_dense_cell(self.mcfg)
        # the network of apply and training, and of inference off the dense
        # cell; the dense-cell network reads the same state
        self.network = Network(self.mcfg, dense_cell=False,
                               dtype=self.dtype).to(self.device).eval()
        self.voxelize = (make_point_voxelizer if self.mcfg.pfn.pointwise
                         else make_voxelizer)(self.mcfg.voxel)
        self.dense_network = (Network(
            self.mcfg, dense_cell=True, dtype=self.dtype).to(
                self.device).eval() if self.dense_cell else None)
        rcfg = self.mcfg.rpn
        # the fused blocks: the CUDA kernel on the card, its twin on the CPU
        self.fast = (rcfg.use_pallas_blocks and rcfg.use_separable_conv
                     and self.mcfg.pfn.pointwise and not self.dense_cell
                     and not self.mcfg.pfn.simple_mean
                     and not self.mcfg.middle.enabled)
        if self.fast:
            self.rpn_tail = RPNTail(self.mcfg, self.dtype).to(
                self.device).eval()
            # the blocks' folded, packed weights, kept while the state
            # passed to the calls stays the same
            self.folded_blocks = FoldedBlocksCache()
        _, self.ny, self.nx = self.mcfg.feature_map_size
        self.anchor_set = build_anchors(self.mcfg)
        dev = self.device
        self.anchors = torch.as_tensor(self.anchor_set.anchors, device=dev)
        self.sat_corners, self.sat_structured = clamp_sat_tables(
            self.anchor_set, self.ny, self.nx, dev)
        self.anchors_standup = torch.as_tensor(self.anchor_set.standup_bv,
                                               device=dev)
        self.matched_thresholds = torch.as_tensor(
            self.anchor_set.matched_thresholds, device=dev)
        self.unmatched_thresholds = torch.as_tensor(
            self.anchor_set.unmatched_thresholds, device=dev)
        self.mesh = mesh
        self.spatial_axis = config.runtime.spatial_axis or None
        self.grad_scale = 1.0
        if mesh is not None:
            self._bind_mesh(mesh)
        # the state copy that make_inference_fn's graphs read, where the
        # inference body is captured (cuda_graph.py)
        self.graph_state = StaticState() if self.captures(False) else None

    def _bind_mesh(self, mesh):
        rt = self.config.runtime
        extra = set(mesh.axis_names) - {rt.data_axis, rt.spatial_axis}
        if extra:
            raise ValueError(f"mesh axes {sorted(extra)} are neither "
                             f"runtime.data_axis nor runtime.spatial_axis")
        banded = (self.spatial_axis is not None
                  and mesh.group(self.spatial_axis) is not None)
        if banded:
            self.network.spatial = (self.spatial_axis, mesh)
        # the front end is replicated within a spatial axis: its statistics
        # reduce over the data axis only; each RPN band over every rank
        front = _reducing(mesh.group(rt.data_axis))
        rpn = _reducing(mesh.group()) if banded else front
        for name, m in self.network.named_modules():
            if isinstance(m, BatchNorm):
                m.group = rpn if name.startswith("rpn.") else front
        # the ranks along the spatial axis each hold a part of the
        # gradient (sum); the data ranks each a whole one (mean)
        self.grad_scale = (mesh.axis_size(self.spatial_axis) if banded
                           else 1) / mesh.size

    def captures(self, train: bool) -> bool:
        """The rule of the captured paths (``make_inference_fn``, and
        ``make_train_step`` for ``train``), on the card: a body without a
        collective (no mesh, or inference without a spatial band, since
        eval-mode BNs reduce nothing) is captured whatever the backend; a
        body with collectives only where a graph can hold them
        (``parallel/collectives.py::graph_safe``: NCCL; every axis group
        has the world's backend). The CPU runs every body eagerly."""
        collectives = self.mesh is not None and (
            train or self.network.spatial is not None)
        return self.device.type == "cuda" and (
            not collectives or graph_safe(self.mesh.group()))

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, batch_size: int = 1
             ) -> Dict[str, torch.Tensor]:
        """A fresh ``state_dict`` on this detector's device, drawn from
        ``generator`` with the JAX package's initialisers: every kernel
        uniform in +-sqrt(6 / fan_in) (flax's fan_in: the input features of
        a Dense, kh*kw*in/groups of a conv, kh*kw*in of a ConvTranspose,
        27*in of a conv3d, K*in of the sparse convs' [K, in, out] taps),
        BN scale 1, bias 0, running mean 0 and variance 1, head biases 0
        but the class head's, which takes the focal prior -log((1 - p) / p)
        when ``model.rpn.cls_bias_prior`` is set. Same keys and shapes as
        :func:`pillars_torch.weights.from_jax_variables`; the values are
        not flax's for any seed. ``batch_size`` is accepted for the JAX
        package's signature (flax traces a dummy batch) and unused."""
        del batch_size
        prior = self.mcfg.rpn.cls_bias_prior
        state = {}
        for name, ref in self.network.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            t = torch.zeros(ref.shape, dtype=ref.dtype)
            if leaf == "running_var" or (leaf == "weight" and t.ndim == 1):
                t.fill_(1)
            elif leaf == "weight":
                if t.ndim == 3:  # sparse-conv taps [K, Cin, Cout]
                    fan_in = t.shape[0] * t.shape[1]
                else:
                    k = t[0, 0].numel() if t.ndim >= 4 else 1
                    # torch keeps a ConvTranspose kernel as [in, out, k, k]
                    fan_in = (t.shape[0] if ".deconv." in name
                              else t.shape[1]) * k
                bound = math.sqrt(6.0 / fan_in)
                t.uniform_(-bound, bound, generator=generator)
            elif name == "rpn.conv_cls.bias" and prior is not None:
                t.fill_(-math.log((1.0 - float(prior)) / float(prior)))
            state[name] = t
        return self.state_to_device(state)

    # ------------------------------------------------------------------
    def state_to_device(self, state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """A ``state_dict`` (e.g. from :func:`pillars_torch.weights.
        from_jax_variables`) moved onto this detector's device."""
        return {k: v.to(self.device) for k, v in state.items()}

    # ------------------------------------------------------------------
    def _forward_dense(self, state, points, num_valid, thr: float
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Head tensors (NHWC) and the [B, A] anchors mask."""
        _full_f32()
        preds, dense_grid = torch.func.functional_call(
            self.dense_network, state, (points, num_valid))
        amask = anchors_mask_from_dense(dense_grid, self.sat_corners, thr,
                                        structured=self.sat_structured)
        return preds, amask

    # ------------------------------------------------------------------
    def voxelize_batch(self, points, num_valid):
        """[B, MAXPTS, D] + [B] -> the batch's voxelization: point-major
        (each sample as the JAX package's ``voxelize_points`` gives it) or,
        with ``pfn.pointwise`` off, the dense [P, N, D] layout
        (``voxelize``)."""
        return self.voxelize(points, num_valid)

    def anchors_mask_batch(self, coords, pillar_mask, threshold: float):
        """[B, P, 3] pillar coords + [B, P] mask -> [B, A] anchors mask."""
        # voxel-grid -> feature-map downscale (1 for PointPillars)
        stride = max(1, self.mcfg.voxel.grid_size[1] // self.ny)
        return anchors_mask_batched(
            coords, pillar_mask, self.sat_corners, self.ny, self.nx,
            threshold, structured=self.sat_structured, coord_stride=stride)

    def apply(self, state, voxelized, train: bool = False):
        """Front end + canvas (or middle) + RPN -> NHWC head tensors; with
        ``train``, (head tensors, the new BN statistics as ``state`` entries)
        from the batch statistics, the counterpart of flax's
        ``mutable=["batch_stats"]``. The tensors of ``state`` are left as
        they were."""
        if self.spatial_axis and self.network.spatial is None:
            raise ValueError(
                f"runtime.spatial_axis={self.spatial_axis!r} needs a mesh "
                f"that defines that axis: PillarsDetector(..., "
                f"mesh=spatial_mesh(n)) in each of n ranks")
        _full_f32()
        net = self.network
        if not train:
            return torch.func.functional_call(net, state, (voxelized,))
        collect_batch_stats(net)  # drop what a remat recomputation left
        net.train()
        try:
            preds = torch.func.functional_call(net, state, (voxelized,))
            return preds, collect_batch_stats(net)
        finally:
            net.eval()

    def assign_targets(self, gt_boxes, gt_classes, gt_valid, amask
                       ) -> TargetAssignment:
        """[B, G, 7] gt boxes, [B, G] classes and valid, [B, A] anchors mask
        -> labels [B, A], bbox_targets [B, 7, A], reg_weights [B, A]."""
        return assign_targets_batched(
            self.anchors_standup, self.anchors, gt_boxes, gt_classes,
            gt_valid, amask, self.matched_thresholds,
            self.unmatched_thresholds)

    def loss(self, preds: Dict[str, torch.Tensor], labels, reg_targets
             ) -> LossOutput:
        return detection_loss(
            self.mcfg.loss, self.mcfg.num_class, preds["box_preds"],
            preds["cls_preds"], preds.get("dir_cls_preds"), self.anchors,
            labels, reg_targets,
            use_direction_classifier=self.mcfg.postprocess
            .use_direction_classifier)

    def _forward_fast(self, state, voxelized: VoxelizedPoints, folded=None
                      ) -> Dict[str, torch.Tensor]:
        """:meth:`apply` with the three downsample blocks as one fused
        kernel launch (BN folded once per state, through ``folded`` or this
        detector's cache; in bfloat16 the blocks read and write bfloat16 and
        compute in float32), then :class:`RPNTail`."""
        _full_f32()
        canvas = torch.func.functional_call(
            self.network, _front_state(state), (voxelized,),
            {"canvas_only": True})
        if folded is None:
            folded = self.folded_blocks
        b1, b2, b3 = fused_rpn_blocks(canvas, state, self.mcfg.rpn, folded)
        heads = torch.func.functional_call(
            self.rpn_tail, _sub_state(state, self.rpn_tail, "rpn."),
            (b1, b2, b3))
        tracing.mark("rpn")
        return heads

    # ------------------------------------------------------------------
    def postprocess(self, preds: Dict[str, torch.Tensor], anchors_mask,
                    rect, trv2c) -> Predictions:
        """Decode + top-k + NMS + direction flip over the batch."""
        _full_f32()
        pp = self.mcfg.postprocess
        C = self.mcfg.num_class
        nb = self.mcfg.box_code_size
        b = preds["box_preds"].shape[0]
        box = preds["box_preds"].float().reshape(b, -1, nb)        # [B, A, 7]
        n_anchor = box.shape[1]
        dir_p = (preds["dir_cls_preds"].float().reshape(b, n_anchor, 2)
                 if pp.use_direction_classifier
                 else box.new_zeros((b, n_anchor, 2)))
        cls = preds["cls_preds"].reshape(b, n_anchor, C)
        # sigmoid after max == max of sigmoids (monotone)
        scores_all = torch.sigmoid(cls.amax(dim=-1).float())

        neg_inf = torch.full((), float("-inf"), device=box.device)
        masked = torch.where(anchors_mask, scores_all, neg_inf)
        if pp.nms_score_threshold > 0.0:
            masked = torch.where(masked >= pp.nms_score_threshold, masked,
                                 neg_inf)

        # top-k as a stable descending sort sliced to k: like lax.top_k,
        # equal scores keep the lower anchor index first (torch.topk does
        # not promise an order, and trained scores saturate to 1.0)
        k = pp.nms_pre_max_size
        top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        top_valid = torch.isfinite(top_scores)

        def rows(a, idx):  # a [B, N, c], idx [B, k] -> [B, k, c]
            return torch.gather(a, 1, idx[..., None].expand(-1, -1,
                                                            a.shape[-1]))

        sel_box = rows(box, top_idx)
        sel_anchor = self.anchors[top_idx]
        sel_dir = rows(dir_p, top_idx).argmax(dim=-1)
        # deferred label argmax over the k selected rows (first max wins;
        # all zeros when C == 1)
        sel_label = rows(cls, top_idx).argmax(dim=-1).to(torch.int32)

        decoded = gb.second_box_decode(sel_box, sel_anchor)         # [B, k, 7]
        # (x, y, w, l, r) by slices: a list index is a tensor made on the host
        bev = torch.cat([decoded[..., 0:2], decoded[..., 3:5],
                         decoded[..., 6:7]], dim=-1).reshape(-1, 5)
        corners = gb.center_to_corner_box2d(bev[:, :2], bev[:, 2:4],
                                            bev[:, 4])
        standup = gb.corner_to_standup(corners).reshape(b, k, 4)
        keep_idx, keep_valid = nms_standup(
            standup, top_scores, top_valid, pp.nms_iou_threshold,
            pp.nms_post_max_size, use_kernel=pp.use_pallas_nms)
        keep_idx = keep_idx.long()

        out_boxes = rows(decoded, keep_idx)
        out_scores = torch.gather(top_scores, 1, keep_idx)
        out_dir = torch.gather(sel_dir, 1, keep_idx)
        out_label = torch.gather(sel_label, 1, keep_idx)

        if pp.use_direction_classifier:
            # (rot > 0) xor dir -> += pi (reference voxelnet.py:1300-1310)
            rot = out_boxes[..., 6]
            opp = torch.logical_xor(rot > 0, out_dir > 0)
            rot = rot + torch.where(opp, math.pi, 0.0)
            out_boxes = torch.cat([out_boxes[..., :6], rot[..., None]], dim=-1)

        cam = gb.box_lidar_to_camera(out_boxes, rect, trv2c)
        return Predictions(out_boxes, cam, out_scores, out_label, keep_valid)

    # ------------------------------------------------------------------
    def profile_stages(self, state, points, num_valid, rect, trv2c,
                       iters: int = 20) -> Dict[str, float]:
        """The reference's measure_time_extended tier (voxelnet.py:753-903)
        with the JAX package's stage names: device ms per call of the
        point-major voxelizer (``t_voxel_features``), of :meth:`apply` in
        eval mode (``t_spatial_features_plus_rpn``) and of the anchors mask
        + :meth:`postprocess` (``t_nms_func``). Each stage is captured as a
        graph of its own (:func:`profiled_stages`) and its back-to-back
        replays are timed with CUDA events, as the JAX package times each
        stage's jitted program on the device; each graph's launch is in its
        stage's time, so the sum exceeds the three stages in one graph by
        about two graph launches. The card only: raises on the CPU."""
        from pillars_torch.cuda_graph import replay_ms

        if self.device.type != "cuda":
            raise RuntimeError("profile_stages times captured stages with "
                               "CUDA events; this detector is on the CPU")
        calls = self.profiled_stages(state, points, num_valid, rect, trv2c)
        return {name: replay_ms(call, iters) for name, call in calls.items()
                if name != "t_whole"}

    def profiled_stages(self, state, points, num_valid, rect, trv2c
                        ) -> Dict[str, CapturedCall]:
        """The stages of :meth:`profile_stages`, each captured and replayed
        once on the outputs of the stage before (and ``t_whole``: the three
        in one graph), as :class:`~pillars_torch.cuda_graph.CapturedCall`
        objects holding one graph each."""
        thr = self.config.eval_input.anchor_area_threshold
        dev = self.device
        vox_type = []

        def voxelize(p, n):
            v = self.voxelize_batch(p, n)
            vox_type[:] = [type(v)]
            return list(v)

        heads = []

        def network(*v):
            preds = self.apply(state, vox_type[0](*v))
            heads[:] = sorted(preds)
            return [preds[k] for k in heads]

        def nms_func(coords, pillar_mask, r, t, *h):
            amask = self.anchors_mask_batch(coords, pillar_mask, thr)
            return list(self.postprocess(dict(zip(heads, h)), amask, r, t))

        def whole(p, n, r, t):
            v = voxelize(p, n)
            h = network(*v)
            v = vox_type[0](*v)
            return nms_func(v.coords, v.pillar_mask, r, t, *h)

        inputs = [torch.as_tensor(a, dtype=dtype).to(dev) for a, dtype in (
            (points, torch.float32), (num_valid, torch.int32),
            (rect, torch.float32), (trv2c, torch.float32))]
        calls = {name: CapturedCall(fn, dev) for name, fn in (
            ("t_voxel_features", voxelize),
            ("t_spatial_features_plus_rpn", network),
            ("t_nms_func", nms_func), ("t_whole", whole))}
        v = calls["t_voxel_features"](*inputs[:2])
        calls["t_voxel_features"](*inputs[:2])
        h = calls["t_spatial_features_plus_rpn"](*v)
        calls["t_spatial_features_plus_rpn"](*v)
        v = vox_type[0](*v)
        for _ in range(2):
            calls["t_nms_func"](v.coords, v.pillar_mask, *inputs[2:], *h)
            calls["t_whole"](*inputs)
        return calls

    # ------------------------------------------------------------------
    def _infer(self, state, points, num_valid, rect, trv2c, thr: float,
               folded=None) -> Predictions:
        """The inference body on tensors on this detector's device: what a
        graph captures (no host sync, no host constant, static shapes).

        Its device marks (utils/tracing.py ``mark``), each closing the stage
        of its name: ``start``; ``voxelize`` (the voxelizer); ``pfn`` (PFN
        and canvas scatter, or SECOND's middle; on the point-major paths the
        anchors mask, which runs after the voxelizer, counts here; on the
        dense cell the occupancy grid); ``rpn`` (backbone and heads: the
        RPN, or the fused blocks and the tail); ``post`` (decode, top-K,
        NMS, direction; on the dense cell the anchors mask counts here)."""
        tracing.mark("start")
        if self.dense_cell:
            preds, amask = self._forward_dense(state, points, num_valid, thr)
        else:
            voxelized = self.voxelize_batch(points, num_valid)
            tracing.mark("voxelize")
            amask = self.anchors_mask_batch(
                voxelized.coords, voxelized.pillar_mask, thr)
            preds = (self._forward_fast(state, voxelized, folded) if self.fast
                     else self.apply(state, voxelized))
        out = self.postprocess(preds, amask, rect, trv2c)
        tracing.mark("post")
        return out

    def make_inference_fn(self, anchor_area_threshold: Optional[float] = None):
        """fn(state, points [B, MAXPTS, D], num_valid [B], rect [B, 4, 4],
        trv2c [B, 4, 4]) -> Predictions, on this detector's device.

        On the card, the counterpart of the JAX package's ``jax.jit``: a
        :class:`pillars_torch.cuda_graph.CapturedInference` that replays one
        captured CUDA graph per input shape, its inputs arrays or tensors
        anywhere (a pinned host tensor is copied without blocking the host;
        the caller then leaves it alone until the batch is done). On a mesh
        too (:meth:`captures`): a data-only mesh's body holds no collective,
        and a spatial band's halo exchanges and heads' gather are captured
        over NCCL. The CPU, and a band whose collectives run over gloo
        (which copies through host memory, where a graph cannot follow),
        get the eager function, which runs the body op by op; a tensor is
        copied to the card without blocking the host, an array through a
        pageable, blocking copy. Either has the eager function as its
        ``eager`` attribute (the eager one itself), which tests use to
        compare the two."""
        thr = (self.config.eval_input.anchor_area_threshold
               if anchor_area_threshold is None else anchor_area_threshold)
        dev = self.device

        def put(a, dtype=None):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype, non_blocking=True)
            return torch.as_tensor(a, dtype=dtype, device=dev)

        def eager(state, points, num_valid, rect, trv2c):
            with torch.inference_mode():
                return self._infer(state, put(points, torch.float32),
                                   put(num_valid), put(rect, torch.float32),
                                   put(trv2c, torch.float32), thr)

        eager.eager = eager
        if self.graph_state is None:
            return eager
        return CapturedInference(
            functools.partial(self._infer, thr=thr, folded=self.graph_state),
            eager, self.graph_state, dev, Predictions)
