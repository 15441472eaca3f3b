"""Bucketed inference dispatch (pillars_tpu/infer.py).

The voxelizer's dominant cost, the sort of the points by cell
(ops/voxelize.py), scales with the PADDED width ``model.voxel.max_points``,
not with the cloud's real point count, and real sensors fill a fraction of
the worst case. ``BucketedInference`` keeps a small ladder of point-count
buckets and sends every cloud through the smallest bucket that holds it.

The JAX package needs the ladder because XLA compiles one graph per static
shape; here each rung's inference function captures one CUDA graph per
input shape on the card (pillars_torch/cuda_graph.py), and the ladder cuts
the sort and the per-point work to the rung's width.
:meth:`BucketedInference.warmup` captures every rung (the first call also
builds the port's kernels with nvcc and lets cuDNN pick its algorithms), so
that no frame pays for it. The interface is the JAX package's.

The weights are shared: no parameter depends on ``max_points``. All rungs
take the SAME state tensors (move them to the card once, with
:meth:`BucketedInference.state_to_device`), and share one cache of folded
RPN block weights, which is keyed on tensor identity, and on the card the
one static copy of the state that every rung's graphs read.

Semantics: a cloud with ``n <= bucket`` points voxelizes IDENTICALLY in
every bucket that holds it. Padding rows carry an out-of-range cell id and
sort to the tail however many there are, and the per-cell point cap and the
first-in-input-order rules see the same valid points in the same order. This
holds within one front end: a rung whose clamped ``max_voxels`` falls below
the grid's cell count runs the point-major voxelizer where a wider rung runs
the dense-cell one (the default d435i ladder has one rung of each), and the
two agree to rounding, not to the bit. Clouds larger than the top bucket are
truncated to it, as the fixed path truncates to ``max_points``.
"""

import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BucketedInference", "default_bucket_ladder", "parse_bucket_arg"]


def parse_bucket_arg(arg, max_points: int) -> Optional[Tuple[int, ...]]:
    """CLI bucket spec: None/'' -> None, 'auto' -> the default halving
    ladder from ``max_points``, 'a,b,c' -> explicit rungs.

    Validates up front: a malformed spec exits with a usage message instead
    of an int() traceback, and rungs above ``max_points`` are clamped with a
    warning (a rung wider than the model's point budget never helps)."""
    if not arg:
        return None
    if arg == "auto":
        return default_bucket_ladder(int(max_points))
    try:
        rungs = tuple(int(b) for b in str(arg).split(","))
    except ValueError:
        raise SystemExit(
            f"--buckets: expected 'auto' or comma-separated point counts "
            f"(e.g. '32768,65536,131072'), got {arg!r}")
    if not rungs or any(b <= 0 for b in rungs):
        raise SystemExit(
            f"--buckets: rungs must be positive integers, got {arg!r}")
    over = [b for b in rungs if b > int(max_points)]
    if over:
        sys.stderr.write(
            f"[buckets] rung(s) {over} exceed model.voxel.max_points="
            f"{int(max_points)}; clamping (a wider bucket than the model's "
            f"point budget never helps)\n")
        rungs = tuple(min(b, int(max_points)) for b in rungs)
    return tuple(sorted(set(rungs)))


def default_bucket_ladder(max_points: int, levels: int = 3,
                          min_bucket: int = 8192) -> Tuple[int, ...]:
    """Halving ladder topping out at ``max_points``: e.g. 131072 ->
    (32768, 65536, 131072). Never descends below ``min_bucket`` (tiny
    buckets save nothing: the network and the postprocess do not scale with
    the point budget)."""
    out = [int(max_points)]
    for _ in range(levels - 1):
        nxt = out[-1] // 2
        if nxt < min_bucket:
            break
        out.append(nxt)
    return tuple(sorted(out))


class BucketedInference:
    """Host-side bucket selection over one detector per rung.

    Usage::

        bi = BucketedInference(cfg)           # ladder from cfg, or buckets=
        state = bi.state_to_device(state)     # once
        bi.warmup(state)                      # optional: build and tune now
        preds = bi(state, points, num_valid, rect, trv2c)

    ``points`` is a host array or CPU tensor ``[B, N, D]`` padded at the
    tail; ``num_valid [B]`` gives the real counts and stays on the host, so
    that picking a rung costs no copy from the card. The batch goes to the
    smallest bucket that holds ``max(num_valid)``.
    """

    def __init__(self, config, buckets: Optional[Sequence[int]] = None,
                 anchor_area_threshold: Optional[float] = None, device=None):
        from pillars_torch import resolve_device
        from pillars_torch.models.detector import PillarsDetector

        base = int(config.model.voxel.max_points)
        if buckets is None:
            buckets = default_bucket_ladder(base)
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets:
            raise ValueError("buckets must be non-empty")
        if any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.buckets = buckets
        self.device = resolve_device(device)
        self._threshold = anchor_area_threshold
        self._config = config
        self._detector_cls = PillarsDetector
        self._fns: Dict[int, object] = {}
        # one detector per bucket: the rung's point and pillar budgets live
        # on its config
        self._dets: Dict[int, object] = {}

    # ------------------------------------------------------------------
    def select_bucket(self, n: int) -> int:
        """Smallest bucket >= n; the largest bucket when none fits
        (the cloud is then truncated, matching the fixed path)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _fn(self, bucket: int):
        fn = self._fns.get(bucket)
        if fn is None:
            cfg = self._config.override("model.voxel.max_points", bucket)
            # a bucket of n points can fill at most n pillars; clamping the
            # pillar budget keeps max_voxels <= max_points and is
            # numerically free
            if cfg.model.voxel.max_voxels > bucket:
                cfg = cfg.override("model.voxel.max_voxels", bucket)
            det = self._detector_cls(cfg, device=self.device)
            # the folded block weights and the graphs' copy of the state
            # depend on the state alone
            for other in self._dets.values():
                det.graph_state = other.graph_state
                if det.fast and other.fast:
                    det.folded_blocks = other.folded_blocks
            fn = det.make_inference_fn(self._threshold)
            self._dets[bucket] = det
            self._fns[bucket] = fn
        return fn

    def state_to_device(self, state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """``state`` on this dispatcher's device: the one copy that every
        rung is then called with."""
        return {k: v.to(self.device) for k, v in state.items()}

    # ------------------------------------------------------------------
    def warmup(self, variables, batch_size: int = 1,
               num_features: Optional[int] = None):
        """Run every rung once on an empty batch of ``batch_size`` and wait
        for it: on the card this captures each rung's graph at that batch
        size (streaming callers must not pay the kernels' build, cuDNN's
        algorithm search or a capture on the first large frame)."""
        d = (num_features if num_features is not None
             else self._config.model.num_point_features)
        eye = np.tile(np.eye(4, dtype=np.float32), (batch_size, 1, 1))
        num = np.zeros((batch_size,), np.int32)
        for b in self.buckets:
            pts = np.zeros((batch_size, b, d), np.float32)
            self._fn(b)(variables, pts, num, eye, eye)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def __call__(self, variables, points, num_valid, rect, trv2c):
        num = np.asarray(num_valid, np.int32)
        n = int(num.max()) if num.size else 0
        b = self.select_bucket(n)
        # a tensor stays a tensor: a slice of a pinned buffer is still
        # pinned, and its copy to the card does not block
        pts = points if isinstance(points, torch.Tensor) else np.asarray(
            points)
        if pts.shape[1] >= b:
            pts = pts[:, :b]
        elif isinstance(pts, torch.Tensor):
            pts = torch.nn.functional.pad(pts, (0, 0, 0, b - pts.shape[1]))
        else:
            pad = np.zeros(
                (pts.shape[0], b - pts.shape[1], pts.shape[2]), pts.dtype)
            pts = np.concatenate([pts, pad], axis=1)
        num = np.minimum(num, b)
        return self._fn(b)(variables, pts, num, rect, trv2c)
