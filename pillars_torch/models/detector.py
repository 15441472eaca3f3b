"""End-to-end d435i inference (pillars_tpu/models/detector.py, dense-cell
path): voxelize -> DenseCellPFN -> canvas -> RPN -> decode + top-k + NMS +
direction flip, with fixed-size outputs and a validity mask.

Precision: the JAX reference on the CPU computes in full f32, while cuDNN
convolutions default to TF32 (about 3 decimal digits). Both stages of this
path therefore turn TF32 off for convolutions and matmuls
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
from pillars_torch.models.pfn import DenseCellPFN
from pillars_torch.models.rpn import RPN
from pillars_torch.ops.anchors import (StructuredSAT, anchors_mask_from_dense,
                                       build_anchors)
from pillars_torch.ops.nms import nms_standup
from pillars_torch.ops.voxelize import make_cell_voxelizer


class Predictions(NamedTuple):
    """Fixed-size per-sample detections, [B, K, ...] with K = nms_post_max."""

    boxes_lidar: torch.Tensor   # [B, K, 7]
    boxes_camera: torch.Tensor  # [B, K, 7]
    scores: torch.Tensor        # [B, K]
    labels: torch.Tensor        # [B, K] int32
    valid: torch.Tensor         # [B, K] bool


def _full_f32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Network(nn.Module):
    """Dense-cell front end + RPN: padded clouds -> (NHWC head tensors,
    [B, ny, nx] occupied-cell count summed over z)."""

    def __init__(self, mcfg: ModelConfig):
        super().__init__()
        self.mcfg = mcfg
        self.pfn = DenseCellPFN(mcfg)
        self.rpn = RPN(mcfg)
        self.cell_voxelize = make_cell_voxelizer(mcfg.voxel)

    def forward(self, points, num_valid):
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


class PillarsDetector:
    """Binds the config, the anchor tables and the network on one device;
    the state (weights) is passed to each call, as in the JAX package."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.mcfg = config.model
        self.device = resolve_device(device)
        if config.runtime.compute_dtype != "float32":
            raise NotImplementedError("only float32 compute is ported")
        gx, gy, gz = self.mcfg.voxel.grid_size
        self.dense_cell = (self.mcfg.pfn.dense_cell
                           and not self.mcfg.middle.enabled
                           and gx * gy * gz <= self.mcfg.voxel.max_voxels)
        if not self.dense_cell:
            raise NotImplementedError(
                "only the dense-cell front end is ported (pfn.dense_cell with "
                "a grid of at most max_voxels cells and no middle extractor)")
        self.anchor_set = build_anchors(self.mcfg)
        self.network = Network(self.mcfg).to(self.device).eval()
        dev = self.device
        self.anchors = torch.as_tensor(self.anchor_set.anchors, device=dev)
        self.sat_corners = torch.as_tensor(self.anchor_set.sat_corners,
                                           dtype=torch.long, device=dev)
        s = self.anchor_set.sat_structured
        self.sat_structured = None if s is None else StructuredSAT(
            *(torch.as_tensor(a, dtype=torch.long, device=dev) for a in s))

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
            self.network, state, (points, num_valid))
        amask = anchors_mask_from_dense(dense_grid, self.sat_corners, thr,
                                        structured=self.sat_structured)
        return preds, amask

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
        trv2c [B, 4, 4]) -> Predictions, on this detector's device."""
        thr = (self.config.eval_input.anchor_area_threshold
               if anchor_area_threshold is None else anchor_area_threshold)
        dev = self.device

        def fn(state, points, num_valid, rect, trv2c):
            with torch.inference_mode():
                points = torch.as_tensor(points, dtype=torch.float32,
                                         device=dev)
                num_valid = torch.as_tensor(num_valid, device=dev)
                rect = torch.as_tensor(rect, dtype=torch.float32, device=dev)
                trv2c = torch.as_tensor(trv2c, dtype=torch.float32,
                                        device=dev)
                preds, amask = self._forward_dense(state, points, num_valid,
                                                   thr)
                return self.postprocess(preds, amask, rect, trv2c)

        return fn
