"""The d435i detector (pillars_tpu/models/detector.py): voxelize -> PFN ->
canvas -> RPN -> [train] targets + loss | [eval] decode + top-k + NMS +
direction flip, with fixed-size outputs and a validity mask.

Two front ends, as in the JAX package. Point-major (``apply``, the network
every config trains through): ``VoxelizedPoints`` -> ``PointwisePFN`` ->
canvas scatter -> RPN; with ``rpn.use_pallas_blocks`` the inference path
runs the three downsample blocks as the fused kernel (``_forward_fast``:
``ops/rpn_blocks.py``, the CUDA kernel on the card, its plain twin on the
CPU) and ``RPNTail`` follows. Dense cell (``_forward_dense``, inference on
the default config): the pillar space is the cell grid and the canvas a
reshape. Both networks read the same state dict.

Precision: the JAX reference on the CPU computes in full f32, while cuDNN
convolutions default to TF32 (about 3 decimal digits). Every stage of these
paths therefore turns TF32 off for convolutions and matmuls
(``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32``, process-wide flags).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pillars_torch import resolve_device
from pillars_torch.config import Config, ModelConfig
from pillars_torch.geometry import boxes as gb
from pillars_torch.models.layers import collect_batch_stats
from pillars_torch.models.losses import LossOutput, detection_loss
from pillars_torch.models.pfn import DenseCellPFN, PointwisePFN
from pillars_torch.models.rpn import RPN, RPNTail
from pillars_torch.ops.anchors import (StructuredSAT, anchors_mask_batched,
                                       anchors_mask_from_dense, build_anchors)
from pillars_torch.ops.nms import nms_standup
from pillars_torch.ops.rpn_blocks import FoldedBlocksCache, fused_rpn_blocks
from pillars_torch.ops.scatter import scatter_to_canvas_batched
from pillars_torch.ops.targets import TargetAssignment, assign_targets_batched
from pillars_torch.ops.voxelize import (VoxelizedPoints, make_cell_voxelizer,
                                        make_point_voxelizer)


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
    buffers. On the CPU the predictions are already there."""

    def __init__(self, preds: Predictions):
        self.event = None
        if preds.valid.is_cuda:
            preds = Predictions(*(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True) for t in preds))
            self.event = torch.cuda.Event()
            self.event.record()
        self._host = preds

    def result(self) -> Predictions:
        """The predictions as NumPy arrays."""
        if self.event is not None:
            self.event.synchronize()
        return Predictions(*(t.numpy() for t in self._host))


def _full_f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def point_canvas(pfn, v: VoxelizedPoints, ny: int, nx: int) -> torch.Tensor:
    """Point-major front end: ``pfn`` (a :class:`PointwisePFN` or a call
    of one) over the batch folded into the point and pillar axes, then the
    canvas scatter -> [B, ny, nx, C]."""
    b, p = v.pillar_mask.shape
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    # per-sample pillar ids offset into the folded [B*P] rows; the sentinel
    # segment's id may reach the next sample's row 0, but its points are
    # not kept and cannot win a max
    offset = torch.arange(b, dtype=torch.int32, device=v.points.device) * p
    feats = pfn(flat(v.points), flat(v.point_pillar + offset[:, None]),
                flat(v.point_kept), flat(v.point_mean), flat(v.point_zyx),
                flat(v.num_points), flat(v.pillar_mask))
    return scatter_to_canvas_batched(feats.reshape(b, p, -1), v.coords,
                                     v.pillar_mask, ny, nx)


def uses_dense_cell(mcfg: ModelConfig) -> bool:
    """The JAX package's rule: the dense-cell front end serves inference on
    every grid that fits in max_voxels, unless a middle extractor is on."""
    gx, gy, gz = mcfg.voxel.grid_size
    return (mcfg.pfn.dense_cell and not mcfg.middle.enabled
            and gx * gy * gz <= mcfg.voxel.max_voxels)


def _unported_point_major(mcfg: ModelConfig):
    return [name for name, on in (
        ("model.middle.enabled", mcfg.middle.enabled),
        ("model.pfn.simple_mean", mcfg.pfn.simple_mean),
        ("model.pfn.pointwise=false", not mcfg.pfn.pointwise)) if on]


class Network(nn.Module):
    """PFN + canvas + RPN. Dense cell: ``forward(points, num_valid)`` ->
    (NHWC head tensors, [B, ny, nx] occupied-cell count summed over z).
    Point-major: ``forward(voxelized)`` -> NHWC head tensors. The two
    share parameter names, so one checkpoint loads into either.
    ``dense_cell`` defaults to :func:`uses_dense_cell`."""

    def __init__(self, mcfg: ModelConfig, dense_cell: Optional[bool] = None):
        super().__init__()
        self.mcfg = mcfg
        self.dense_cell = (uses_dense_cell(mcfg) if dense_cell is None
                           else dense_cell)
        if not self.dense_cell:
            unported = _unported_point_major(mcfg)
            if unported:
                raise NotImplementedError(
                    f"not ported yet: {', '.join(unported)} (the dense-cell "
                    f"and the point-major PointwisePFN front ends are)")
        self.pfn = (DenseCellPFN(mcfg) if self.dense_cell
                    else PointwisePFN(mcfg))
        self.rpn = RPN(mcfg)
        if self.dense_cell:
            self.cell_voxelize = make_cell_voxelizer(mcfg.voxel)

    def forward(self, *inputs):
        if not self.dense_cell:
            _, ny, nx = self.mcfg.feature_map_size
            return self.rpn(point_canvas(self.pfn, *inputs, ny, nx))
        points, num_valid = inputs
        b = points.shape[0]
        nx, ny, nz = self.mcfg.voxel.grid_size
        n_cells = nx * ny * nz
        cv = self.cell_voxelize(points, num_valid)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        offset = torch.arange(b, dtype=torch.int32,
                              device=points.device)[:, None] * n_cells
        cell_global = cv.cell + offset  # stays non-decreasing over the fold
        cell_feats, num_points = self.pfn(
            flat(cv.points), flat(cv.cell), flat(cell_global), flat(cv.kept),
            flat(cv.count), flat(cv.mean), b * n_cells)
        # cell id = (z*ny + y)*nx + x, so the canvas is a reshape; the
        # z-layer SUM keeps the reference's scatter-ADD quirk
        canvas = cell_feats.reshape(b, nz, ny, nx, -1).sum(dim=1)
        dense_grid = (num_points > 0).reshape(b, nz, ny, nx).to(
            torch.float32).sum(dim=1)
        return self.rpn(canvas), dense_grid


def _sub_state(state: Dict[str, torch.Tensor], module: nn.Module,
               prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``state`` under ``prefix`` that ``module`` holds."""
    return {k: state[prefix + k] for k in module.state_dict()}


class PillarsDetector:
    """Binds the config, the anchor tables and the network on one device;
    the state (weights) is passed to each call, as in the JAX package."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.mcfg = config.model
        self.device = resolve_device(device)
        if config.runtime.compute_dtype != "float32":
            raise NotImplementedError("only float32 compute is ported")
        self.dense_cell = uses_dense_cell(self.mcfg)
        # the point-major network: apply, training, and inference off the
        # dense cell; built for every config it is ported for (a dense-cell
        # config of another front end keeps its inference path)
        self.network = None
        if not (self.dense_cell and _unported_point_major(self.mcfg)):
            self.network = Network(self.mcfg, dense_cell=False).to(
                self.device).eval()
            self.voxelize = make_point_voxelizer(self.mcfg.voxel)
        self.dense_network = (Network(self.mcfg, dense_cell=True).to(
            self.device).eval() if self.dense_cell else None)
        rcfg = self.mcfg.rpn
        # the fused blocks: the CUDA kernel on the card, its twin on the CPU
        self.fast = (rcfg.use_pallas_blocks and rcfg.use_separable_conv
                     and self.mcfg.pfn.pointwise and not self.dense_cell)
        if self.fast:
            self.rpn_tail = RPNTail(self.mcfg).to(self.device).eval()
            # the blocks' folded, packed weights, kept while the state
            # passed to the calls stays the same
            self.folded_blocks = FoldedBlocksCache()
        _, self.ny, self.nx = self.mcfg.feature_map_size
        self.anchor_set = build_anchors(self.mcfg)
        dev = self.device
        self.anchors = torch.as_tensor(self.anchor_set.anchors, device=dev)
        self.sat_corners = torch.as_tensor(self.anchor_set.sat_corners,
                                           dtype=torch.long, device=dev)
        s = self.anchor_set.sat_structured
        self.sat_structured = None if s is None else StructuredSAT(
            *(torch.as_tensor(a, dtype=torch.long, device=dev) for a in s))
        self.anchors_standup = torch.as_tensor(self.anchor_set.standup_bv,
                                               device=dev)
        self.matched_thresholds = torch.as_tensor(
            self.anchor_set.matched_thresholds, device=dev)
        self.unmatched_thresholds = torch.as_tensor(
            self.anchor_set.unmatched_thresholds, device=dev)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, batch_size: int = 1
             ) -> Dict[str, torch.Tensor]:
        """A fresh ``state_dict`` on this detector's device, drawn from
        ``generator`` with the JAX package's initialisers: every kernel
        uniform in +-sqrt(6 / fan_in) (flax's fan_in: the input features of
        a Dense, kh*kw*in/groups of a conv, kh*kw*in of a ConvTranspose),
        BN scale 1, bias 0, running mean 0 and variance 1, head biases 0
        but the class head's, which takes the focal prior -log((1 - p) / p)
        when ``model.rpn.cls_bias_prior`` is set. Same keys and shapes as
        :func:`pillars_torch.weights.from_jax_variables`; the values are
        not flax's for any seed. ``batch_size`` is accepted for the JAX
        package's signature (flax traces a dummy batch) and unused."""
        del batch_size
        prior = self.mcfg.rpn.cls_bias_prior
        state = {}
        net = self.network if self.network is not None else self.dense_network
        for name, ref in net.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            t = torch.zeros(ref.shape, dtype=ref.dtype)
            if leaf == "running_var" or (leaf == "weight" and t.ndim == 1):
                t.fill_(1)
            elif leaf == "weight":
                k = t[0, 0].numel() if t.ndim == 4 else 1
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
    def _point_major(self):
        if self.network is None:
            raise NotImplementedError(
                f"not ported yet: {', '.join(_unported_point_major(self.mcfg))}"
                f" (the point-major PointwisePFN front end is)")
        return self.network

    def voxelize_batch(self, points, num_valid) -> VoxelizedPoints:
        """[B, MAXPTS, D] + [B] -> the point-major voxelization of the batch
        (each sample as the JAX package's ``voxelize_points`` gives it)."""
        self._point_major()
        return self.voxelize(points, num_valid)

    def anchors_mask_batch(self, coords, pillar_mask, threshold: float):
        """[B, P, 3] pillar coords + [B, P] mask -> [B, A] anchors mask."""
        # voxel-grid -> feature-map downscale (1 for PointPillars)
        stride = max(1, self.mcfg.voxel.grid_size[1] // self.ny)
        return anchors_mask_batched(
            coords, pillar_mask, self.sat_corners, self.ny, self.nx,
            threshold, structured=self.sat_structured, coord_stride=stride)

    def apply(self, state, voxelized: VoxelizedPoints, train: bool = False):
        """Point-major PFN + canvas + RPN -> NHWC head tensors; with
        ``train``, (head tensors, the new BN statistics as ``state`` entries)
        from the batch statistics, the counterpart of flax's
        ``mutable=["batch_stats"]``. The tensors of ``state`` are left as
        they were."""
        _full_f32()
        net = self._point_major()
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

    def _forward_fast(self, state, voxelized: VoxelizedPoints
                      ) -> Dict[str, torch.Tensor]:
        """:meth:`apply` with the three downsample blocks as one fused
        kernel launch (BN folded once per state), then :class:`RPNTail`."""
        _full_f32()
        pfn = self.network.pfn
        pfn_state = _sub_state(state, pfn, "pfn.")
        canvas = point_canvas(
            lambda *a: torch.func.functional_call(pfn, pfn_state, a),
            voxelized, self.ny, self.nx)
        b1, b2, b3 = fused_rpn_blocks(canvas, state, self.mcfg.rpn,
                                      self.folded_blocks)
        return torch.func.functional_call(
            self.rpn_tail, _sub_state(state, self.rpn_tail, "rpn."),
            (b1, b2, b3))

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

        neg_inf = torch.tensor(float("-inf"), device=box.device)
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
        bev = decoded[..., [0, 1, 3, 4, 6]].reshape(-1, 5)
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
    def make_inference_fn(self, anchor_area_threshold: Optional[float] = None):
        """fn(state, points [B, MAXPTS, D], num_valid [B], rect [B, 4, 4],
        trv2c [B, 4, 4]) -> Predictions, on this detector's device.

        Inputs may be arrays or tensors anywhere. A tensor is copied to the
        card without blocking the host, which is asynchronous when it lies
        in pinned memory (the caller then leaves the buffer alone until the
        batch is done); an array goes through a pageable, blocking copy."""
        thr = (self.config.eval_input.anchor_area_threshold
               if anchor_area_threshold is None else anchor_area_threshold)
        dev = self.device

        def put(a, dtype=None):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype, non_blocking=True)
            return torch.as_tensor(a, dtype=dtype, device=dev)

        def fn(state, points, num_valid, rect, trv2c):
            with torch.inference_mode():
                points = put(points, torch.float32)
                num_valid = put(num_valid)
                rect = put(rect, torch.float32)
                trv2c = put(trv2c, torch.float32)
                if self.dense_cell:
                    preds, amask = self._forward_dense(state, points,
                                                       num_valid, thr)
                else:
                    voxelized = self.voxelize_batch(points, num_valid)
                    amask = self.anchors_mask_batch(
                        voxelized.coords, voxelized.pillar_mask, thr)
                    forward = self._forward_fast if self.fast else self.apply
                    preds = forward(state, voxelized)
                return self.postprocess(preds, amask, rect, trv2c)

        return fn
