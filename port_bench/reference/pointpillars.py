"""Plain PyTorch PointPillars inference: the reference the benchmark holds the
program's detections against.

Written from the model's definition (PointPillars, Lang et al., CVPR 2019,
and the reference repository's d435i variant), with its own checkpoint
reader, anchors and postprocess. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the raw checkpoint
file, the configuration's file and the clouds. Every tensor is float32; the
convolutions and products run with TF32 off, or on where the caller asks
for the lower-precision control (``tf32=True``).

One cloud at a time through the front end, the RPN over blocks of canvases:

- voxelize: cell = floor((p - corner) * (1 / voxel)) with the reciprocal
  rounded to float32 (the configuration's stated arithmetic: a product, as
  the program's jitted ancestor computes it); out-of-range points dropped;
  pillars in arrival order, and where a cloud opens more than
  ``max_voxels`` pillars, every point from the one that would open the next
  pillar on is dropped; each pillar keeps its first ``max_points_per_voxel``
  points in input order.
- PFN: per point (xyz[, intensity], offset to the pillar's point mean,
  offset to the pillar centre) -> Linear -> BN (running statistics) -> ReLU;
  per pillar the max over its points, and over relu(bn(0)), the padded
  slot of the reference's [P, N, D] layout, where it has fewer than N.
- canvas: pillar features added into their (y, x) cell (the d435i grid's
  two z layers sum); the RPN's three blocks of 3x3 convs (separable where
  the configuration says so) with BN and ReLU, three transposed convs, the
  1x1 heads over their concatenation.
- postprocess: anchors over empty BEV regions masked (summed-area table of
  the occupied pillars), scores sigmoid(max class logit), a stable top-K,
  SECOND's box decode, greedy NMS on the standup boxes with the
  reference's +1 IoU, the direction flip, and the serving filter
  ``score >= prediction_min_score``.

A configuration without a trained checkpoint gets seeded weights
(:meth:`Reference.write_seeded`): drawn from a seed, then calibrated by this
reference on a few clouds of the configuration's traffic.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import cost


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

class _Fields(tuple):
    """Stand-in for any class the checkpoint pickle names outside NumPy: the
    train state and the optimizer's states, kept as their fields."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _Reader(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "numpy" or module.startswith("numpy."):
            try:
                return super().find_class(module, name)
            except ModuleNotFoundError:
                import importlib

                legacy = module.replace("numpy._core", "numpy.core", 1)
                return getattr(importlib.import_module(legacy), name)
        return _Fields


def load_checkpoint(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) trees of NumPy arrays of a checkpoint file: a
    pickled ``{"state": (step, params, batch_stats, opt_state), ...}`` or
    ``{"state": {"params", "batch_stats"}}``."""
    with open(path, "rb") as f:
        payload = _Reader(f).load()
    state = payload["state"] if isinstance(payload, dict) else payload
    if isinstance(state, dict):
        return state["params"], state["batch_stats"]
    return state[1], state[2]


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

def make_anchors(model: Dict) -> np.ndarray:
    """[ny * nx * per_loc, 7] anchors (x, y, z, w, l, h, r), in the heads'
    order: y, x, then generator, size and rotation."""
    nx, ny, _ = model["voxel"]["grid_size"]
    per_loc = []
    for g in model["anchor_generators"]:
        xs = np.arange(nx, dtype=np.float32) * np.float32(g["strides"][0]) \
            + np.float32(g["offsets"][0])
        ys = np.arange(ny, dtype=np.float32) * np.float32(g["strides"][1]) \
            + np.float32(g["offsets"][1])
        z = np.float32(g["offsets"][2])
        sizes = np.asarray(g["sizes"], np.float32).reshape(-1, 3)
        rots = np.asarray(g["rotations"], np.float32)
        a = np.zeros((ny, nx, len(sizes), len(rots), 7), np.float32)
        a[..., 0] = xs[None, :, None, None]
        a[..., 1] = ys[:, None, None, None]
        a[..., 2] = z
        a[..., 3:6] = sizes[None, None, :, None, :]
        a[..., 6] = rots[None, None, None, :]
        per_loc.append(a.reshape(ny, nx, -1, 7))
    return np.concatenate(per_loc, axis=2).reshape(-1, 7)


def anchor_corners(model: Dict, anchors: np.ndarray) -> np.ndarray:
    """[A, 4] (x0, y0, x1, y1) summed-area-table cells of each anchor's
    nearest axis-aligned BEV box, clipped to the grid."""
    vs = np.asarray(model["voxel"]["voxel_size"], np.float32)
    pcr = np.asarray(model["voxel"]["point_cloud_range"], np.float32)
    nx, ny, _ = model["voxel"]["grid_size"]
    r = anchors[:, 6]
    wrapped = np.abs(r - np.floor(r / np.float32(np.pi) + np.float32(0.5))
                     * np.float32(np.pi))
    swap = wrapped > np.pi / 4
    w = np.where(swap, anchors[:, 4], anchors[:, 3])
    l = np.where(swap, anchors[:, 3], anchors[:, 4])  # noqa: E741
    bv = np.stack([anchors[:, 0] - w / 2, anchors[:, 1] - l / 2,
                   anchors[:, 0] + w / 2, anchors[:, 1] + l / 2], axis=1)
    c = np.stack([np.floor((bv[:, 0] - pcr[0]) / vs[0]),
                  np.floor((bv[:, 1] - pcr[1]) / vs[1]),
                  np.floor((bv[:, 2] - pcr[0]) / vs[0]),
                  np.floor((bv[:, 3] - pcr[1]) / vs[1])], axis=1)
    c[:, 0::2] = np.clip(c[:, 0::2], 0, nx - 1)
    c[:, 1::2] = np.clip(c[:, 1::2], 0, ny - 1)
    return c.astype(np.int64)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class Candidates(NamedTuple):
    """One cloud's top-K candidates and what decided their fate."""

    boxes: np.ndarray       # [K, 7] decoded, direction applied
    scores: np.ndarray      # [K] (-inf where invalid)
    valid: np.ndarray       # [K] bool
    standup: np.ndarray     # [K, 4] NMS boxes (x0, y0, x1, y1)
    dir_margin: np.ndarray  # [K] |difference of the two direction logits|
    rot: np.ndarray         # [K] decoded yaw before the direction flip
    boundary: float         # the best score left out of the top K
    final: np.ndarray       # indices of the served detections, served order
    nms_pairs: int          # (box, kept box before it) pairs greedy NMS met
    flops: float            # operations of this cloud's forward pass


class Detections(NamedTuple):
    """What the serving loop delivers for one cloud."""

    boxes: np.ndarray   # [n, 7] lidar boxes
    scores: np.ndarray  # [n]


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reference:
    """PointPillars of a configuration file's ``model`` section with a
    checkpoint's weights, on ``device``. ``checkpoint``: a checkpoint file,
    or its (params, batch_stats) trees."""

    def __init__(self, model: Dict, checkpoint, device="cpu"):
        self.m = model
        self.device = torch.device(device)
        params, stats = (checkpoint if isinstance(checkpoint, tuple)
                         else load_checkpoint(checkpoint))
        dev = self.device

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        self.p = _map_tree(params, t)
        self.s = _map_tree(stats, t)
        self.anchors_np = make_anchors(model)
        self.anchors = t(self.anchors_np)
        self.corners = torch.as_tensor(anchor_corners(model, self.anchors_np),
                                       device=dev)
        # paths of the BatchNorms calibrated so far (write_seeded only)
        self._calibrated = None

    def flops(self, kept_points: int) -> float:
        """Operations of one cloud's forward pass (``port_bench/cost.py``)."""
        return cost.model_flops(self.m, kept_points)

    # -- front end ----------------------------------------------------------
    def _bn(self, x, path, channel_dim=-1):
        p, s = _get(self.p, path), _get(self.s, path)
        eps = self.m["rpn"]["bn_eps"] if path[0] == "rpn" \
            else self.m["pfn"]["bn_eps"]
        if self._calibrated is not None and path not in self._calibrated:
            dims = [d for d in range(x.dim()) if d != channel_dim % x.dim()]
            s["mean"] = _coarse(x.mean(dim=dims))
            s["var"] = _coarse(x.var(dim=dims, unbiased=False))
            self._calibrated.add(path)
        shape = [1] * x.dim()
        shape[channel_dim] = -1
        inv = torch.rsqrt(s["var"] + eps)
        return ((x - s["mean"].view(shape)) * (inv * p["scale"]).view(shape)
                + p["bias"].view(shape))

    def canvas(self, cloud: np.ndarray):
        """One cloud [n, D] -> (canvas [ny, nx, F], occupied pillars per
        (y, x) [ny, nx], points kept)."""
        v = self.m["voxel"]
        dev = self.device
        nx, ny, nz = v["grid_size"]
        P, N = v["max_voxels"], v["max_points_per_voxel"]
        pts = torch.as_tensor(np.asarray(cloud[:v["max_points"]], np.float32),
                              device=dev)
        pcr = torch.tensor(v["point_cloud_range"][:3], dtype=torch.float32,
                           device=dev)
        inv = torch.tensor(np.float32(1) / np.asarray(v["voxel_size"],
                                                      np.float32), device=dev)
        c = torch.floor((pts[:, :3] - pcr) * inv).long()
        grid = torch.tensor([nx, ny, nz], device=dev)
        inside = ((c >= 0) & (c < grid)).all(dim=1)
        pts, c = pts[inside], c[inside]
        cell = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
        order = torch.arange(len(cell), device=dev)
        uniq, inverse = torch.unique(cell, return_inverse=True)
        first = torch.full((len(uniq),), len(cell), device=dev).scatter_reduce(
            0, inverse, order, "amin")
        if len(uniq) > P:
            # the point that would open pillar P + 1 ends the cloud
            cutoff = torch.sort(first).values[P]
            pts, c, cell = pts[:cutoff], c[:cutoff], cell[:cutoff]
            order = order[:cutoff]
            uniq, inverse = torch.unique(cell, return_inverse=True)
        # rank of each point inside its pillar, in input order
        srt, perm = torch.sort(inverse, stable=True)
        starts = torch.searchsorted(srt, srt, right=False)
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(len(perm), device=dev) - starts
        keep = rank < N
        pts, c, pil = pts[keep], c[keep], inverse[keep]
        n_pil = len(uniq)
        count = torch.zeros(n_pil, device=dev).index_add_(
            0, pil, torch.ones(len(pil), device=dev))
        total = torch.zeros((n_pil, 3), device=dev).index_add_(0, pil,
                                                               pts[:, :3])
        mean = total / count[:, None]
        vx, vy = v["voxel_size"][:2]
        cx = c[:, 0].float() * vx + (vx / 2 + v["point_cloud_range"][0])
        cy = c[:, 1].float() * vy + (vy / 2 + v["point_cloud_range"][1])
        feats = torch.cat([pts, pts[:, :3] - mean[pil],
                           (pts[:, 0] - cx)[:, None],
                           (pts[:, 1] - cy)[:, None]], dim=1)
        kernel = self.p["pfn"]["dense"]["kernel"]
        x = torch.relu(self._bn(feats @ kernel, ("pfn", "bn")))
        zero = torch.relu(self._bn(torch.zeros(1, kernel.shape[1],
                                               device=dev), ("pfn", "bn")))
        feat = torch.full((n_pil, x.shape[1]), float("-inf"), device=dev)
        feat = feat.scatter_reduce(0, pil[:, None].expand_as(x), x, "amax")
        feat = torch.where((count < N)[:, None], torch.maximum(feat, zero),
                           feat)
        # the pillar's (y, x): every point of a pillar shares its cell
        py = torch.zeros(n_pil, dtype=torch.long, device=dev).scatter_(
            0, pil, c[:, 1])
        px = torch.zeros(n_pil, dtype=torch.long, device=dev).scatter_(
            0, pil, c[:, 0])
        canvas = torch.zeros((ny, nx, feat.shape[1]), device=dev)
        canvas.index_put_((py, px), feat, accumulate=True)
        occupied = torch.zeros((ny, nx), device=dev)
        occupied.index_put_((py, px), torch.ones(n_pil, device=dev),
                            accumulate=True)
        return canvas, occupied, int(len(pts))

    # -- RPN --------------------------------------------------------------
    def _conv(self, x, node, stride):
        if "depthwise" in node:
            dw = node["depthwise"]["kernel"].permute(3, 2, 0, 1)
            x = F.conv2d(x, dw, stride=stride, padding=1, groups=x.shape[1])
            return F.conv2d(x, node["pointwise"]["kernel"].permute(3, 2, 0, 1))
        return F.conv2d(x, node["kernel"].permute(3, 2, 0, 1), stride=stride,
                        padding=1)

    def heads(self, canvas: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, ny, nx, F] canvases -> head logits [B, ny*nx*per_loc, ...]."""
        r = self.m["rpn"]
        rp = self.p["rpn"]
        x = canvas.permute(0, 3, 1, 2)
        ups = []
        for i in range(3):
            blk = rp[f"block{i + 1}"]
            for j in range(r["layer_nums"][i] + 1):
                x = self._conv(x, blk[f"conv{j}"],
                               r["layer_strides"][i] if j == 0 else 1)
                x = torch.relu(self._bn(x, ("rpn", f"block{i + 1}", f"bn{j}"),
                                        channel_dim=1))
            k = rp[f"deconv{i + 1}"]["deconv"]["kernel"]
            s = r["upsample_strides"][i]
            # kernel == stride: each input cell spreads over an s x s tile
            # of the output, the kernel read back to front
            up = F.conv_transpose2d(x, k.flip(0, 1).permute(2, 3, 0, 1),
                                    stride=s)
            ups.append(torch.relu(self._bn(up, ("rpn", f"deconv{i + 1}", "bn"),
                                           channel_dim=1)))
        cat = torch.cat(ups, dim=1)
        b = cat.shape[0]
        out = {}
        for name, width in (("box", 7), ("cls", self.m["num_class"]),
                            ("dir", 2)):
            node = rp[f"conv_{name}" if name != "dir" else "conv_dir_cls"]
            if self._calibrated is not None:
                _standardise(node, cat, HEAD_SPREAD[name])
            y = F.conv2d(cat, node["kernel"].permute(3, 2, 0, 1),
                         node["bias"])
            out[name] = y.permute(0, 2, 3, 1).reshape(b, -1, width)
        return out

    # -- postprocess ------------------------------------------------------
    def anchor_mask(self, occupied: torch.Tensor) -> torch.Tensor:
        """[A] anchors whose BEV box holds more occupied pillars than the
        configuration's threshold."""
        x0, y0, x1, y1 = self.corners.unbind(1)
        sat = torch.cumsum(torch.cumsum(occupied, dim=0), dim=1)
        area = sat[y1, x1] - sat[y1, x0] - sat[y0, x1] + sat[y0, x0]
        return area > self.m["anchor_area_threshold"]

    def candidates(self, box, cls, dirl, occupied, flops) -> Candidates:
        """One cloud's head logits -> its top-K candidates and the served
        detections among them."""
        pp = self.m["postprocess"]
        amask = self.anchor_mask(occupied)
        scores = torch.sigmoid(cls.amax(dim=1))
        masked = torch.where(amask, scores, torch.tensor(float("-inf"),
                                                         device=box.device))
        if pp["nms_score_threshold"] > 0:
            masked = torch.where(masked >= pp["nms_score_threshold"], masked,
                                 torch.tensor(float("-inf"),
                                              device=box.device))
        k = pp["nms_pre_max_size"]
        srt, idx = torch.sort(masked, descending=True, stable=True)
        boundary = float(srt[k]) if len(srt) > k else float("-inf")
        top, idx = srt[:k], idx[:k]
        dec = _decode(box[idx], self.anchors[idx])
        d = dirl[idx]
        flip = (dec[:, 6] > 0) ^ (d.argmax(dim=1) > 0)
        rot = dec[:, 6]
        boxes = torch.cat([dec[:, :6], (rot + torch.where(
            flip, torch.tensor(math.pi, device=box.device),
            torch.tensor(0.0, device=box.device)))[:, None]], dim=1)
        standup = _standup(dec)
        top_np = top.cpu().numpy()
        valid = np.isfinite(top_np)
        su = standup.cpu().numpy()
        keep, pairs = greedy_nms(su, top_np, valid, pp["nms_iou_threshold"])
        keep = keep[:pp["nms_post_max_size"]]
        served = keep[top_np[keep] >= self.m["prediction_min_score"]]
        return Candidates(boxes.cpu().numpy(), top_np, valid, su,
                          (d[:, 0] - d[:, 1]).abs().cpu().numpy(),
                          rot.cpu().numpy(), boundary, served, pairs, flops)

    def run(self, clouds: List[np.ndarray], tf32: bool = False,
            block: int = 8) -> List[Candidates]:
        """Candidates of every cloud, the RPN over ``block`` clouds at a
        time."""
        out = []
        with torch.no_grad(), _tf32(tf32):
            for i in range(0, len(clouds), block):
                fronts = [self.canvas(c) for c in clouds[i:i + block]]
                h = self.heads(torch.stack([f[0] for f in fronts]))
                for j, (_, occ, kept) in enumerate(fronts):
                    out.append(self.candidates(h["box"][j], h["cls"][j],
                                               h["dir"][j], occ,
                                               self.flops(kept)))
        return out

    # -- seeded weights ---------------------------------------------------
    @staticmethod
    def layers(model: Dict):
        """The network's leaves in the checkpoint's (flax) layout:
        ("kernel", path, shape, fan-in), ("bn", path, width) and ("bias",
        path, width) of the heads."""
        r = model["rpn"]
        f = model["pfn"]["num_filters"]
        d = model["num_point_features"] + 5
        yield "kernel", ("pfn", "dense", "kernel"), (d, f), d
        yield "bn", ("pfn", "bn"), f
        cin = f
        for i in range(3):
            blk = ("rpn", f"block{i + 1}")
            cout = r["num_filters"][i]
            for j in range(r["layer_nums"][i] + 1):
                conv = blk + (f"conv{j}",)
                if r["use_separable_conv"]:
                    yield "kernel", conv + ("depthwise", "kernel"), \
                        (3, 3, 1, cin), 9
                    yield "kernel", conv + ("pointwise", "kernel"), \
                        (1, 1, cin, cout), cin
                else:
                    yield "kernel", conv + ("kernel",), (3, 3, cin, cout), \
                        9 * cin
                yield "bn", blk + (f"bn{j}",), cout
                cin = cout
            u, up = r["upsample_strides"][i], r["num_upsample_filters"][i]
            yield "kernel", ("rpn", f"deconv{i + 1}", "deconv", "kernel"), \
                (u, u, cout, up), cout
            yield "bn", ("rpn", f"deconv{i + 1}", "bn"), up
        per_loc = sum(len(g["rotations"]) * (len(g["sizes"]) // 3)
                      for g in model["anchor_generators"])
        width = sum(r["num_upsample_filters"])
        for name, n in (("conv_box", 7), ("conv_cls", model["num_class"]),
                        ("conv_dir_cls", 2)):
            yield "kernel", ("rpn", name, "kernel"), \
                (1, 1, width, per_loc * n), width
            yield "bias", ("rpn", name, "bias"), per_loc * n

    @classmethod
    def seeded_trees(cls, model: Dict, seed: int, device="cpu"):
        """(params, batch_stats) drawn from ``seed`` by a generator on
        ``device``, in two calls: every kernel from N(0, 1 / fan-in), every
        BatchNorm's scale from 1 + N(0, 0.1^2) and its bias from
        N(0, 0.1^2); the heads' biases 0, the running statistics 0 and 1
        (calibrated by :meth:`write_seeded`)."""
        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        leaves = list(cls.layers(model))
        kernels = [x for x in leaves if x[0] == "kernel"]
        bns = [x for x in leaves if x[0] == "bn"]
        sizes = [math.prod(shape) for _, _, shape, _ in kernels]
        widths = [w for _, _, w in bns]
        flat = torch.randn(sum(sizes), generator=gen, device=dev)
        bn_flat = torch.randn(2, sum(widths), generator=gen,
                              device=dev) * 0.1
        params: Dict = {}
        stats: Dict = {}
        for (_, path, shape, fan_in), part in zip(kernels,
                                                  flat.split(sizes)):
            _put(params, path, part.view(shape) / math.sqrt(fan_in))
        for (_, path, w), scale, bias in zip(bns, bn_flat[0].split(widths),
                                             bn_flat[1].split(widths)):
            _put(params, path + ("scale",), 1.0 + scale)
            _put(params, path + ("bias",), bias)
            _put(stats, path + ("mean",), torch.zeros(w, device=dev))
            _put(stats, path + ("var",), torch.ones(w, device=dev))
        for _, path, w in (x for x in leaves if x[0] == "bias"):
            _put(params, path, torch.zeros(w, device=dev))
        return params, stats

    def calibrate(self, clouds: List[np.ndarray]) -> None:
        """Sets every BatchNorm's running statistics from the first batch
        that reaches it (the front end's from the first cloud, the RPN's
        from the canvases of all ``clouds``), standardises each head's
        output channels on that batch (:data:`HEAD_SPREAD`), and offsets
        the class head so that, averaged over ``clouds``, the
        ``nms_post_max_size // 2`` best unmasked anchors of a cloud score at
        least ``prediction_min_score`` (greedy NMS keeps fewer)."""
        self._calibrated = set()
        try:
            with torch.no_grad(), _tf32(False):
                fronts = [self.canvas(c) for c in clouds]
                h = self.heads(torch.stack([f[0] for f in fronts]))
                best = torch.cat([
                    h["cls"][j].amax(dim=1)[self.anchor_mask(occ)]
                    for j, (_, occ, _) in enumerate(fronts)])
        finally:
            self._calibrated = None
        want = max(1, self.m["postprocess"]["nms_post_max_size"] // 2) \
            * len(clouds)
        if not len(best):
            raise ValueError("no anchor of the calibration clouds is "
                             "unmasked: the clouds miss the grid")
        nth = torch.sort(best, descending=True).values[
            min(want, len(best)) - 1]
        score = self.m["prediction_min_score"]
        node = self.p["rpn"]["conv_cls"]
        node["bias"] = node["bias"] + _coarse(
            math.log(score / (1.0 - score)) - nth)

    @classmethod
    def write_seeded(cls, model: Dict, seed: int, clouds: List[np.ndarray],
                     path: str, device="cpu") -> None:
        """Writes to ``path`` the checkpoint of ``model`` from ``seed``
        (:meth:`seeded_trees`), calibrated on ``clouds`` (:meth:`calibrate`),
        as ``{"state": {"params", "batch_stats"}}`` of float32 NumPy arrays:
        the layout :func:`load_checkpoint` and the program's
        ``weights.load_params`` read."""
        ref = cls(model, cls.seeded_trees(model, seed, device), device)
        ref.calibrate(clouds)

        def host(tree):
            return _map_tree(tree, lambda t: t.cpu().numpy())

        with open(path, "wb") as f:
            pickle.dump({"state": {"params": host(ref.p),
                                   "batch_stats": host(ref.s)}}, f,
                        protocol=4)


# Why seeded weights are calibrated: kernels drawn at random leave each
# layer's output at a scale set by the draw, and twenty layers compound it
# (seeded full-width weights gave boxes of 1e10 m). With every running
# statistic taken from the batch that reaches it, each layer hands the next
# values of order one, as training leaves them; the heads, standardised per
# output channel, keep box residuals small (boxes near their anchors, sizes
# within a factor exp(0.5) of theirs at three spreads) and direction logits
# of order one, and the class head's offset keeps the served detections of a
# cloud between none and NMS's cap. Statistics and scales are rounded to
# eight significant bits, so that the order in which a device sums them
# does not change the file.

# (mean, spread) of each head's output channels on the calibration batch
HEAD_SPREAD = {"box": (0.0, 0.1), "cls": (0.0, 1.0), "dir": (0.0, 1.0)}
COARSE_BITS = 8


def _coarse(x):
    """``x`` (a tensor or a float) rounded to :data:`COARSE_BITS`
    significant bits."""
    t = torch.as_tensor(x, dtype=torch.float32)
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2.0 ** COARSE_BITS)
                       / 2.0 ** COARSE_BITS, e.to(torch.float32))


def _standardise(node: Dict, x: torch.Tensor, target) -> None:
    """Rescales the 1x1 head ``node`` (flax kernel [1, 1, C, O], bias [O])
    so that its output channels over the batch ``x`` [B, C, H, W] have the
    ``target`` (mean, spread)."""
    y = F.conv2d(x, node["kernel"].permute(3, 2, 0, 1), node["bias"])
    mean = _coarse(y.mean(dim=(0, 2, 3)))
    std = y.std(dim=(0, 2, 3), unbiased=False)
    scale = _coarse(target[1] / torch.where(std > 0, std,
                                            torch.ones_like(std)))
    node["kernel"] = node["kernel"] * scale
    node["bias"] = (node["bias"] - mean) * scale + target[0]


def served(c: Candidates) -> Detections:
    """The detections a serving loop delivers for candidates ``c``."""
    return Detections(c.boxes[c.final], c.scores[c.final])


def _decode(enc: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """SECOND's residual box decode (z at the box bottom)."""
    xa, ya, za, wa, la, ha, ra = anchors.unbind(1)
    xt, yt, zt, wt, lt, ht, rt = enc.unbind(1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    hg = torch.exp(ht) * ha
    return torch.stack([xt * diag + xa, yt * diag + ya,
                        zt * ha + za - hg / 2, torch.exp(wt) * wa,
                        torch.exp(lt) * la, hg, rt + ra], dim=1)


def _standup(boxes: torch.Tensor) -> torch.Tensor:
    """[K, 7] boxes -> [K, 4] axis-aligned hull of their rotated BEV
    rectangles."""
    x, y, w, l, r = (boxes[:, 0], boxes[:, 1], boxes[:, 3], boxes[:, 4],
                     boxes[:, 6])
    ux = torch.tensor([-0.5, -0.5, 0.5, 0.5], device=boxes.device)
    uy = torch.tensor([-0.5, 0.5, 0.5, -0.5], device=boxes.device)
    px, py = w[:, None] * ux, l[:, None] * uy
    s, c = torch.sin(r)[:, None], torch.cos(r)[:, None]
    cx = px * c + py * s + x[:, None]
    cy = -px * s + py * c + y[:, None]
    return torch.stack([cx.amin(1), cy.amin(1), cx.amax(1), cy.amax(1)], 1)


def pixel_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of standup boxes [n, 4] x [m, 4] with the reference's +1 on
    every side length (float32)."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    w = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0, None)
    h = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0, None)
    inter = w * h
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def greedy_nms(standup: np.ndarray, scores: np.ndarray, valid: np.ndarray,
               threshold: float) -> Tuple[np.ndarray, int]:
    """Greedy NMS: boxes by descending score (equal scores: the later box
    first), each kept unless a kept box before it overlaps it by IoU above
    ``threshold``. Returns (kept indices in that order, the number of
    (box, kept box before it) pairs compared)."""
    order = np.argsort(np.where(valid, scores, -np.inf), kind="stable")[::-1]
    iou = pixel_iou(standup, standup)
    kept: List[int] = []
    pairs = 0
    for i in order:
        if not valid[i]:
            continue
        pairs += len(kept)
        if not kept or not (iou[i, kept] > np.float32(threshold)).any():
            kept.append(int(i))
    return np.asarray(kept, dtype=np.int64), pairs


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def nms_margin(c: Candidates, threshold: float) -> np.ndarray:
    """[K] for each candidate, how near its NMS fate came to turning: the
    least |IoU - threshold| against any other valid candidate, and the
    least score gap to a candidate that overlaps it beyond the
    threshold."""
    iou = pixel_iou(c.standup, c.standup)
    both = c.valid[:, None] & c.valid[None, :]
    np.fill_diagonal(both, False)
    near = np.where(both & (iou > 0), np.abs(iou - np.float32(threshold)),
                    np.inf)
    s = np.where(c.valid, c.scores, np.float32(0))
    gap = np.abs(s[:, None] - s[None, :])
    order = np.where(both & (iou > np.float32(threshold)), gap, np.inf)
    return np.minimum(near.min(axis=1, initial=np.inf),
                      order.min(axis=1, initial=np.inf))


def decision_margin(c: Candidates, model: Dict) -> np.ndarray:
    """[K] how near each candidate came to another fate: its score against
    the serving filter, the pre-NMS score threshold and the top-K boundary;
    its NMS decisions; its direction logits; the sign of its yaw (the flip
    rule)."""
    pp = model["postprocess"]
    s = c.scores
    m = np.abs(s - np.float32(model["prediction_min_score"]))
    if pp["nms_score_threshold"] > 0:
        m = np.minimum(m, np.abs(s - np.float32(pp["nms_score_threshold"])))
    if np.isfinite(c.boundary):
        m = np.minimum(m, np.abs(s - np.float32(c.boundary)))
    m = np.minimum(m, nms_margin(c, pp["nms_iou_threshold"]))
    m = np.minimum(m, c.dir_margin)
    m = np.minimum(m, np.abs(c.rot))
    return np.where(c.valid, m, np.inf)
