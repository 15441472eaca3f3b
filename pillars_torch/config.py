"""Typed configuration tree for pillars_torch: a copy of
``pillars_tpu/config.py`` (NumPy only), kept separate so the port imports
nothing of the JAX package. ``Config.default()`` and ``from_yaml`` read the
same files and give the same values.

Replaces the reference's raw-YAML-dict indexing (reference train.py:133-134 and
string paths like ``config["model"]["second"]["voxel_generator"][...]``,
reference load_data.py:1952-1986) with a validated dataclass tree.

Every live key of the reference ``configs/train.yaml`` has a documented home
here; values default to the reference's shipped pedestrian config
(reference configs/train.yaml:108-211).

Supports:
- ``Config.default()`` — the reference pedestrian d435i config,
- ``Config.from_yaml(path)`` — loads either this framework's YAML layout or
  the reference's train.yaml layout (auto-detected),
- dotted-path CLI overrides: ``cfg.override("model.rpn.num_filters", [32,64,128])``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

try:  # YAML is optional; the default config needs no file.
    import yaml

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


def _round_half_even(x: float) -> int:
    """np.round semantics (banker's rounding), used by the reference for the
    grid size (reference load_data.py:2595-2596). Note: with the shipped
    config the z extent 6.0 / voxel_z 4.0 = 1.5 rounds to **2** z-layers."""
    return int(np.round(x))


@dataclass
class VoxelConfig:
    """reference configs/train.yaml:108-121 (voxel_generator)."""

    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        0.0, -2.56, -3.0, 6.40, 2.56, 3.0)
    voxel_size: Tuple[float, float, float] = (0.08, 0.08, 4.0)
    max_points_per_voxel: int = 50
    max_voxels: int = 12000
    # TPU addition: static padded size of the raw point dimension. Clouds are
    # padded/truncated to this many points before the jitted voxelizer.
    # Size it to your sensor: a d435i cloud after the reference's own 1::4
    # subsampling is <= 19200 points (+ sampled objects); the sort over this
    # axis is the voxelizer's dominant cost, so don't over-provision.
    # static padded cloud width. The d435i production cloud is a FIXED
    # 19200 points (640x480 depth subsampled 1::4, reference
    # realsense_make_dataset.py:395-412), so 19968 = 156 * 128 lanes is
    # the correct static width — the voxelizer's sort/scan passes scale
    # with this, and the previous 32768 headroom cost ~0.35 ms/cloud of
    # pure padding work at B=1 (width A/B 2026-08-21: 0.89 vs 1.25
    # ms/cloud e2e). Larger sensors set it per config (KITTI: 131072).
    max_points: int = 19968

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — reference load_data.py:2595-2596."""
        pcr = np.array(self.point_cloud_range)
        vs = np.array(self.voxel_size)
        gs = (pcr[3:] - pcr[:3]) / vs
        return tuple(int(v) for v in np.round(gs).astype(np.int64))

    @property
    def nx(self) -> int:
        return self.grid_size[0]

    @property
    def ny(self) -> int:
        return self.grid_size[1]

    @property
    def nz(self) -> int:
        return self.grid_size[2]


@dataclass
class AnchorConfig:
    """reference configs/train.yaml:183-196 (anchor_generator_stride)."""

    sizes: Tuple[float, float, float] = (0.6, 0.8, 1.73)  # w, l, h
    strides: Tuple[float, float, float] = (0.08, 0.08, 0.0)
    offsets: Tuple[float, float, float] = (0.08, -2.56, -1.465)
    rotations: Tuple[float, ...] = (0.0, 1.57)
    matched_threshold: float = 0.5
    unmatched_threshold: float = 0.35
    class_name: str = "Pedestrian"

    @property
    def num_per_loc(self) -> int:
        n_size = len(np.array(self.sizes).reshape(-1, 3))
        return n_size * len(self.rotations)


@dataclass
class TargetAssignerConfig:
    """reference configs/train.yaml:183-200. Multi-class models list one
    AnchorConfig per class in ``anchor_generators`` (interleaved per
    location like reference generate_anchors, load_data.py:1680);
    single-class models just use ``anchor``."""

    anchor: AnchorConfig = field(default_factory=AnchorConfig)
    anchor_generators: Tuple[AnchorConfig, ...] = ()
    sample_positive_fraction: Optional[float] = None
    rpn_batch_size: int = 512
    # TPU addition: static padded ground-truth box count per sample.
    max_gt_boxes: int = 24

    @property
    def generators(self) -> Tuple[AnchorConfig, ...]:
        return self.anchor_generators or (self.anchor,)


@dataclass
class PFNConfig:
    """reference configs/train.yaml:122-127 + model/pointpillars.py:65-225."""

    num_filters: int = 128
    with_distance: bool = False
    bn_eps: float = 1e-3  # reference model/pointpillars.py:109
    bn_momentum: float = 0.01  # keras momentum (decay of the moving average)
    # point-major PFN (bandwidth-optimal, numerically equivalent); the dense
    # [P, N, C] path remains available for cross-checking (models/pfn.py)
    pointwise: bool = True
    # dense-cell inference front end (ops/voxelize.py::voxelize_cells +
    # models/pfn.py::DenseCellPFN): pillar space == cell grid, one scatter
    # total. Auto-disabled when the grid has more cells than max_voxels.
    dense_cell: bool = True
    # SECOND's SimpleVoxel encoder: per-voxel mean of the raw point
    # features, no learned layer (second.pytorch voxel_encoder) — used in
    # front of the sparse middle extractor. Two supported paths: with
    # pointwise=true the pointwise voxelizer's scan-wise voxel_mean fast
    # path is used (detector.py); with pointwise=false the mean is taken
    # over the dense [P, N, D] pillar tensor.
    simple_mean: bool = False


@dataclass
class MiddleConfig:
    """SECOND-style 3D middle extractor. Off by default (PointPillars
    path); enable with a fine z voxel resolution. ``sparse: false`` runs
    dense conv3d (models/middle.py, d435i-scale grids); ``sparse: true``
    runs submanifold/strided sparse convs over the active voxel set
    (models/sparse_middle.py + ops/sparse_conv.py, full-KITTI grids)."""

    enabled: bool = False
    num_filters: Tuple[int, ...] = (16, 32)
    sparse: bool = False
    # sparse-path stage shape (one entry per num_filters stage):
    subm_per_stage: int = 2
    downsample_strides: Tuple[Tuple[int, int, int], ...] = ()
    downsample_kernels: Tuple[Tuple[int, int, int], ...] = ()
    # static active-voxel cap after each downsample (0 -> voxel.max_voxels)
    max_active: int = 0
    # NOTE: a fused VMEM-resident Pallas gather-conv was designed, built
    # and REMOVED 2026-08-18 — Mosaic cannot express a table row-gather
    # on this toolchain (gathers must be same-shape take-along-axis, and
    # tpu.dynamic_gather only sources ONE vreg along the gather axis).
    # The XLA fused gather in ops/sparse_conv.py::gather_conv is the
    # measured keeper; full ledger in docs/PERFORMANCE.md.


@dataclass
class RPNConfig:
    """reference configs/train.yaml:129-142 + model/voxelnet.py:517-717."""

    layer_nums: Tuple[int, int, int] = (3, 5, 5)
    layer_strides: Tuple[int, int, int] = (1, 2, 2)
    num_filters: Tuple[int, int, int] = (64, 128, 256)
    upsample_strides: Tuple[int, int, int] = (1, 2, 4)
    num_upsample_filters: Tuple[int, int, int] = (128, 128, 128)
    use_separable_conv: bool = True  # deliberate reference customization
    # rematerialize the conv blocks in backward (jax.checkpoint): trades
    # ~1.3x compute for O(block) activation memory — enables large-batch
    # training on big grids that otherwise exceed HBM (KITTI B=8 needs
    # 17.2G of 15.75G without it)
    remat: bool = False
    # with remat: store the block-boundary residuals (the ONLY activations
    # the backward keeps) in bfloat16 while all compute, params and grads
    # stay float32 — halves the stored-activation HBM traffic the KITTI
    # backward is bound on, at the cost of bf16 rounding at 7 boundary
    # tensors (VERDICT r3 #5 lever; measured in docs/PERFORMANCE.md)
    remat_bf16: bool = False
    # fuse each downsample block into one Pallas kernel on the inference
    # path (TPU backends; requires separable convs + pointwise PFN)
    use_pallas_blocks: bool = False
    # apply the 1x1 heads per up-branch and sum instead of materializing
    # the 384-channel concat (mathematically identical, same param tree;
    # the concat is pure HBM traffic and costs ~1 ms at KITTI scale —
    # scripts/probe_rpn_tail_variants.py)
    no_concat_heads: bool = True
    # focal-loss prior init for the cls head bias (RetinaNet sec. 4.1,
    # b = -log((1-pi)/pi)): background scores start at ~pi instead of
    # ~0.5, skipping the background sweep that keeps AP pinned at 0 for
    # tens of epochs at large anchor counts. None = reference behavior
    # (zero bias). Set to e.g. 0.01 for KITTI-scale anchor sets.
    cls_bias_prior: Optional[float] = None
    # lower the depthwise stage of each separable conv as k*k shifted
    # multiply-adds (models/layers.py::depthwise_shift_add) instead of a
    # grouped conv — same params/math, candidate fast path for the
    # grouped-conv forward/backward (scripts/probe_depthwise.py)
    depthwise_shift_add: bool = False
    bn_eps: float = 1e-3  # keras BatchNormalization default
    bn_momentum: float = 0.99


@dataclass
class LossConfig:
    """reference configs/train.yaml:151-171 + model/voxelnet.py:74-512."""

    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_sigma: float = 3.0
    code_weights: Tuple[float, ...] = (1.0,) * 7
    classification_weight: float = 1.0
    localization_weight: float = 1.5
    direction_weight: float = 0.5
    pos_class_weight: float = 1.0
    neg_class_weight: float = 1.0
    loss_norm_type: str = "NormByNumPositives"
    encode_rad_error_by_sin: bool = True


@dataclass
class PostprocessConfig:
    """reference configs/train.yaml:172-180 + model/voxelnet.py:1060-1390."""

    nms_pre_max_size: int = 100
    nms_post_max_size: int = 50
    nms_score_threshold: float = 0.0
    nms_iou_threshold: float = 0.5
    post_center_limit_range: Tuple[float, ...] = (0.0, -2.56, -3.0, 6.40, 2.56, 3.0)
    use_direction_classifier: bool = True
    # run the greedy NMS sweep as one Pallas kernel (TPU backends only;
    # falls back to the lax formulation elsewhere)
    use_pallas_nms: bool = True
    # optimization barrier between the RPN heads and the postprocess:
    # stops conv-output layouts leaking into the decode chain (saves
    # ~0.9 ms at KITTI scale, scripts/probe_fuse.py). None = auto
    # (enabled for large anchor sets, where relayout traffic dominates;
    # disabled for small ones, where fusion wins).
    layout_barrier: Optional[bool] = None


@dataclass
class ModelConfig:
    """reference configs/train.yaml:105-211 (model.second)."""

    num_class: int = 1
    class_names: Tuple[str, ...] = ("Pedestrian",)
    num_point_features: int = 3
    encode_background_as_zeros: bool = True
    use_sigmoid_score: bool = True
    box_code_size: int = 7
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    pfn: PFNConfig = field(default_factory=PFNConfig)
    middle: MiddleConfig = field(default_factory=MiddleConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    postprocess: PostprocessConfig = field(default_factory=PostprocessConfig)
    target: TargetAssignerConfig = field(default_factory=TargetAssignerConfig)

    @property
    def feature_map_size(self) -> Tuple[int, int, int]:
        """[1, ny, nx] — reference configs/train.yaml:60 / load_data.py:3023-3027.
        out_size_factor = layer_strides[0] // upsample_strides[0] (== 1 here).
        With the sparse middle extractor, the BEV canvas the RPN sees is
        additionally reduced by the middle stages' y/x strides."""
        out_size_factor = self.rpn.layer_strides[0] // self.rpn.upsample_strides[0]
        nx, ny, _ = self.voxel.grid_size
        if self.middle.enabled and self.middle.sparse:
            n = len(self.middle.num_filters)
            strides = self.middle.downsample_strides or tuple(
                (2, 1, 1) for _ in range(n))
            kernels = self.middle.downsample_kernels or tuple(
                (3, 3, 3) for _ in range(n))
            for (kz, ky, kx), (sz, sy, sx) in zip(kernels, strides):
                ny = (ny + 2 * ((ky - 1) // 2) - ky) // sy + 1
                nx = (nx + 2 * ((kx - 1) // 2) - kx) // sx + 1
        return (1, ny // out_size_factor, nx // out_size_factor)

    @property
    def num_anchors_per_loc(self) -> int:
        return sum(g.num_per_loc for g in self.target.generators)

    @property
    def num_anchors(self) -> int:
        _, ny, nx = self.feature_map_size
        return ny * nx * self.num_anchors_per_loc


@dataclass
class SamplerConfig:
    """GT-database sampler (reference configs/train.yaml:40-52, 1411-1467)."""

    info_path: Optional[str] = None
    sample_classes: Tuple[str, ...] = ("Pedestrian",)
    sample_max_nums: Tuple[int, ...] = (8,)
    max_point_collision: int = 500
    min_point_collision: int = 1
    noise_x_closer: Tuple[float, float] = (-0.8, 0.2)
    noise_x_farther: Tuple[float, float] = (-0.2, 1.5)
    noise_x_point: float = 2.5
    noise_y: Tuple[float, float] = (-1.25, 1.25)
    removed_difficulties: Tuple[int, ...] = (-1,)
    min_points_filter: Tuple[Tuple[str, int], ...] = ()


@dataclass
class AugmentConfig:
    """Per-object + global augmentation (reference configs/train.yaml:66-76)."""

    gt_rotation_noise: Tuple[float, float] = (-0.39269908169, 0.39269908169)
    gt_loc_noise_std: Tuple[float, float, float] = (0.15, 0.15, 0.05)
    global_rotation_noise: Tuple[float, float] = (-0.178539816, 0.178539816)
    global_scaling_noise: Tuple[float, float] = (0.95, 1.05)
    global_loc_noise_std: Tuple[float, float, float] = (0.1, 0.1, 0.2)
    global_random_rot_range: Tuple[float, float] = (0.0, 0.0)
    random_flip_probability: float = 0.5
    noise_num_try: int = 100
    enabled: bool = True  # bool_sampling / transfer-learning switch


@dataclass
class InputReaderConfig:
    """reference configs/train.yaml:33-103 (train/eval_input_reader)."""

    info_path: Optional[str] = None
    dataset_root: Optional[str] = None
    no_annos_info_path: Optional[str] = None
    no_annos_mode: bool = False
    desired_objects: Tuple[str, ...] = ("Pedestrian",)
    batch_size: int = 2
    anchor_area_threshold: float = 1.0
    shuffle: bool = True
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    prefetch_depth: int = 2
    num_workers: int = 2
    # bucketed static-shape eval dispatch (pillars_tpu/infer.py): spec like
    # "16k,32k,64k" — each batch is padded/sliced to the smallest rung that
    # holds its largest cloud, so the common case dispatches a small warmed
    # graph instead of the full max_points width. None = single full-width
    # graph. Used by the in-train Evaluator and `pillars-tpu evaluate`
    # (CLI --buckets overrides).
    buckets: Optional[str] = None
    # AdaBN-style BatchNorm recalibration before eval (train/bn_recal.py):
    # refresh running stats with K unaugmented-scene forward passes so the
    # eval normalization matches the eval distribution instead of the
    # augmented+sampler-pasted train distribution. 0 = off (reference
    # behavior). Only meaningful on eval_input.
    bn_recal_batches: int = 0


@dataclass
class OptimizerConfig:
    """AdamW + exponential decay (reference configs/train.yaml:202-211,
    train.py:223-246). ``decay_steps`` is divided by batch_size at use-site,
    exactly like reference train.py:230."""

    initial_learning_rate: float = 0.002
    decay_steps: int = 7000
    decay_factor: float = 0.8
    staircase: bool = False
    weight_decay: float = 1e-4
    adam_eps: float = 1e-8
    freeze_patterns: Tuple[str, ...] = ()  # optax-mask transfer-learning freeze


@dataclass
class TrainConfig:
    epochs_total: int = 260
    do_evaluate: bool = True
    load_weights: Optional[str] = None  # path to checkpoint for transfer learning
    load_optimizer: Optional[str] = None
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    log_every_steps: int = 10
    print_every_steps: int = 200
    seed: int = 0
    # stream train-time accuracy / precision-recall@thresholds from inside
    # the jitted step (train/metrics.py — the reference's libraries/
    # metrics.py equivalent, which its train loop never wired up)
    train_metrics: bool = False


@dataclass
class RuntimeConfig:
    """TPU-native additions: mesh / precision / profiling knobs."""

    data_axis: str = "data"
    num_devices: int = 0  # 0 = all visible
    # BEV-grid model parallelism (parallel/spatial.py): set to the mesh
    # axis name (e.g. "spatial") to shard the canvas + RPN along BEV y.
    # Only valid when running under a mesh defining that axis.
    spatial_axis: Optional[str] = None
    compute_dtype: str = "float32"  # "bfloat16" for the fast path
    measure_time: bool = False
    measure_time_extended: bool = False
    production_mode: bool = False
    prediction_min_score: float = 0.45
    # Extra XLA flags applied (appended to $XLA_FLAGS) by the CLI before the
    # backend initializes, so measured-best compiler knobs ship with the
    # config instead of shell incantations. Space-separated, e.g.
    # "--xla_tpu_enable_latency_hiding_scheduler=true". No effect if set
    # after the first jax computation.
    xla_flags: str = ""


@dataclass
class Config:
    model_id: str = "1"
    out_dir: str = "out"
    custom_dataset: bool = True
    model: ModelConfig = field(default_factory=ModelConfig)
    train_input: InputReaderConfig = field(default_factory=InputReaderConfig)
    eval_input: InputReaderConfig = field(
        default_factory=lambda: InputReaderConfig(batch_size=1))
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    # ------------------------------------------------------------------
    @classmethod
    def default(cls) -> "Config":
        return cls()

    # ------------------------------------------------------------------
    def override(self, path: str, value: Any) -> "Config":
        """Apply one dotted-path override, returning a new Config."""
        parts = path.split(".")
        def rec(obj, parts):
            if not hasattr(obj, parts[0]):
                raise KeyError(
                    f"unknown config key {parts[0]!r} on {type(obj).__name__}"
                    f" (while resolving {path!r})")
            if len(parts) == 1:
                cur = getattr(obj, parts[0])
                val = value
                if parts[0] == "anchor_generators" and isinstance(val, (list, tuple)):
                    val = tuple(
                        g if isinstance(g, AnchorConfig) else AnchorConfig(
                            **{k: tuple(v) if isinstance(v, list) else v
                               for k, v in g.items()})
                        for g in val)
                elif isinstance(cur, tuple) and isinstance(val, (list, tuple)):
                    val = tuple(tuple(v) if isinstance(v, list) else v
                                for v in val)
                elif isinstance(cur, bool) and isinstance(val, str):
                    # a string landing on a bool field is always a mistake
                    # (any non-empty string is truthy) — fail loudly
                    raise ValueError(
                        f"boolean config key {path!r} given string "
                        f"{val!r}; use true/false")
                return dataclasses.replace(obj, **{parts[0]: val})
            child = getattr(obj, parts[0])
            return dataclasses.replace(obj, **{parts[0]: rec(child, parts[1:])})
        return rec(self, parts)

    def overrides(self, kv: Sequence[str]) -> "Config":
        """Apply ``key.path=value`` strings (values parsed as python literals)."""
        import ast

        cfg = self
        for item in kv:
            key, _, raw = item.partition("=")
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                # YAML-style scalars: lowercase true/false/null would
                # otherwise fall through as TRUTHY strings and silently
                # enable boolean flags the user meant to disable
                low = raw.strip().lower()
                if low in ("true", "false"):
                    val = low == "true"
                elif low in ("none", "null"):
                    val = None
                else:
                    val = raw
            cfg = cfg.override(key.strip(), val)
        return cfg

    # ------------------------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        if not _HAVE_YAML:
            raise RuntimeError("pyyaml not available")
        with open(path) as f:
            raw = yaml.safe_load(f)
        if "model" in raw and isinstance(raw.get("model"), dict) and "second" in raw["model"]:
            return cls._from_reference_yaml(raw)
        return cls._from_native_dict(raw)

    @classmethod
    def _from_native_dict(cls, raw: dict) -> "Config":
        cfg = cls.default()
        flat: List[Tuple[str, Any]] = []

        def walk(prefix, d):
            for k, v in d.items():
                p = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    walk(p, v)
                else:
                    flat.append((p, v))

        walk("", raw)
        for k, v in flat:
            cfg = cfg.override(k, v)
        return cfg

    @classmethod
    def _from_reference_yaml(cls, raw: dict) -> "Config":
        """Import the reference configs/train.yaml layout."""
        cfg = cls.default()
        sec = raw["model"]["second"]
        vg = sec["voxel_generator"]
        cfg = cfg.override("model.voxel.point_cloud_range", vg["point_cloud_range"])
        cfg = cfg.override("model.voxel.voxel_size", vg["voxel_size"])
        cfg = cfg.override("model.voxel.max_points_per_voxel", vg["max_number_of_points_per_voxel"])
        cfg = cfg.override("model.voxel.max_voxels", vg["max_number_of_voxels"])
        cfg = cfg.override("model.num_class", sec["num_class"])
        cfg = cfg.override("model.pfn.num_filters", sec["voxel_feature_extractor"]["num_filters"])
        rpn = sec["rpn"]
        cfg = cfg.override("model.rpn.layer_nums", rpn["layer_nums"])
        cfg = cfg.override("model.rpn.layer_strides", rpn["layer_strides"])
        cfg = cfg.override("model.rpn.num_filters", rpn["num_filters"])
        cfg = cfg.override("model.rpn.upsample_strides", rpn["upsample_strides"])
        cfg = cfg.override("model.rpn.num_upsample_filters", rpn["num_upsample_filters"])
        loss = sec["loss"]
        focal = loss["classification_loss"]["weighted_sigmoid_focal"]
        cfg = cfg.override("model.loss.focal_alpha", focal["alpha"])
        cfg = cfg.override("model.loss.focal_gamma", focal["gamma"])
        sl1 = loss["localization_loss"]["weighted_smooth_l1"]
        cfg = cfg.override("model.loss.smooth_l1_sigma", sl1["sigma"])
        cfg = cfg.override("model.loss.code_weights", sl1["code_weight"])
        cfg = cfg.override("model.loss.classification_weight", loss["classification_weight"])
        cfg = cfg.override("model.loss.localization_weight", loss["localization_weight"])
        cfg = cfg.override("model.loss.direction_weight", sec["direction_loss_weight"])
        pp = cfg.model.postprocess
        cfg = cfg.override("model.postprocess.nms_pre_max_size", sec["nms_pre_max_size"])
        cfg = cfg.override("model.postprocess.nms_post_max_size", sec["nms_post_max_size"])
        cfg = cfg.override("model.postprocess.nms_score_threshold", sec["nms_score_threshold"])
        cfg = cfg.override("model.postprocess.nms_iou_threshold", sec["nms_iou_threshold"])
        cfg = cfg.override("model.postprocess.post_center_limit_range", sec["post_center_limit_range"])
        ag = sec["target_assigner"]["anchor_generators"]["anchor_generator_stride"]
        cfg = cfg.override("model.target.anchor.sizes", ag["sizes"])
        cfg = cfg.override("model.target.anchor.strides", ag["strides"])
        cfg = cfg.override("model.target.anchor.offsets", ag["offsets"])
        cfg = cfg.override("model.target.anchor.rotations", ag["rotations"])
        cfg = cfg.override("model.target.anchor.matched_threshold", ag["matched_threshold"])
        cfg = cfg.override("model.target.anchor.unmatched_threshold", ag["unmatched_threshold"])
        opt = raw["train_config"]["optimizer"]["adam_optimizer"]
        lr = opt["learning_rate"]["exponential_decay_learning_rate"]
        cfg = cfg.override("train.optimizer.initial_learning_rate", lr["initial_learning_rate"])
        cfg = cfg.override("train.optimizer.decay_steps", lr["decay_steps"])
        cfg = cfg.override("train.optimizer.decay_factor", lr["decay_factor"])
        cfg = cfg.override("train.optimizer.staircase", bool(lr["staircase"]))
        cfg = cfg.override("train.optimizer.weight_decay", opt["weight_decay"])
        cfg = cfg.override("train.epochs_total", raw["epochs_total"])

        for reader_key, attr in (("train_input_reader", "train_input"),
                                 ("eval_input_reader", "eval_input")):
            rd = raw.get(reader_key, {})
            if not rd:
                continue
            def _none(v):
                return None if v in ("None", None) else v
            cfg = cfg.override(f"{attr}.info_path", _none(rd.get("img_list_and_infos_path")))
            cfg = cfg.override(f"{attr}.dataset_root", _none(rd.get("dataset_root_path")))
            cfg = cfg.override(f"{attr}.no_annos_mode", bool(rd.get("no_annos_mode", False)))
            cfg = cfg.override(f"{attr}.no_annos_info_path", _none(rd.get("img_list_and_infos_path_no_annos")))
            cfg = cfg.override(f"{attr}.batch_size", rd.get("batch_size", 2))
            cfg = cfg.override(f"{attr}.anchor_area_threshold", rd.get("anchor_area_threshold", 1))
            cfg = cfg.override(f"{attr}.desired_objects", rd.get("desired_objects", ["Pedestrian"]))
        tr = raw.get("train_input_reader", {})
        if tr:
            s = cfg.train_input.sampler
            cfg = cfg.override("train_input.sampler.info_path", tr.get("sampler_info_path"))
            cfg = cfg.override("train_input.sampler.sample_classes", tr.get("sample_classes", ["Pedestrian"]))
            cfg = cfg.override("train_input.sampler.sample_max_nums", tr.get("sample_max_nums", [8]))
            cfg = cfg.override("train_input.sampler.max_point_collision", tr.get("sampler_max_point_collision", 500))
            cfg = cfg.override("train_input.sampler.min_point_collision", tr.get("sampler_min_point_collision", 1))
            if "groundtruth_rotation_uniform_noise" in tr:
                cfg = cfg.override("train_input.augment.gt_rotation_noise", tr["groundtruth_rotation_uniform_noise"])
                cfg = cfg.override("train_input.augment.gt_loc_noise_std", tr["groundtruth_localization_noise_std"])
                cfg = cfg.override("train_input.augment.global_rotation_noise", tr["global_rotation_uniform_noise"])
                cfg = cfg.override("train_input.augment.global_scaling_noise", tr["global_scaling_uniform_noise"])
                cfg = cfg.override("train_input.augment.global_loc_noise_std", tr["global_loc_noise_std"])
        return cfg

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        if not _HAVE_YAML:
            raise RuntimeError("pyyaml not available")
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
