"""Shared helpers of the tests that hold pillars_torch against pillars_tpu:
random flax variable trees made with NumPy, small model configs and clouds."""

import numpy as np

# end-to-end predictions, port vs JAX package on the CPU: valid and labels
# equal; scores and boxes on valid slots agree to f32 rounding accumulated
# through the network (the same convs summed in another order). Random-init
# encodings reach exp() of large values, so boxes of 1e5 m occur: BOX_RTOL.
SCORE_ATOL = 1e-5
BOX_ATOL = 1e-4
BOX_RTOL = 2e-5


def compare_predictions(want, got):
    """``want``: the JAX package's Predictions (NumPy leaves); ``got``: the
    port's (CPU tensors)."""
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy()[v],
                                  np.asarray(want.labels)[v])
    np.testing.assert_allclose(got.scores.numpy()[v],
                               np.asarray(want.scores)[v], atol=SCORE_ATOL)
    for name in ("boxes_lidar", "boxes_camera"):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   np.asarray(getattr(want, name))[v],
                                   rtol=BOX_RTOL, atol=BOX_ATOL,
                                   err_msg=name)


def randomize_variables(variables, seed):
    """A copy of a flax ``{"params", "batch_stats"}`` tree with random
    values from a NumPy seed: BN scales near 1, variances positive, so the
    eval-mode BN is far from the identity."""
    r = np.random.RandomState(seed)

    def walk(tree, coll):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, coll)
                continue
            shape = np.shape(v)
            if coll == "batch_stats" and k == "var":
                a = r.uniform(0.5, 2.0, shape)
            elif coll == "batch_stats":
                a = r.randn(*shape) * 0.1
            elif k == "scale":
                a = r.uniform(0.5, 1.5, shape)
            elif k == "bias":
                a = r.randn(*shape) * 0.1
            else:
                fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
                a = r.randn(*shape) * np.sqrt(2.0 / fan_in)
            out[k] = a.astype(np.float32)
        return out

    return {coll: walk(variables[coll], coll)
            for coll in ("params", "batch_stats")}


# a reduced d435i model: narrow RPN, short blocks, a small point pad
SMALL_OVERRIDES = (
    ("model.voxel.max_points", 2048),
    ("model.pfn.num_filters", 16),
    ("model.rpn.layer_nums", [1, 2, 2]),
    ("model.rpn.num_filters", [16, 32, 64]),
    ("model.rpn.num_upsample_filters", [32, 32, 32]),
)


def small_config(config_cls):
    cfg = config_cls.default()
    for key, value in SMALL_OVERRIDES:
        cfg = cfg.override(key, value)
    return cfg


# the point-major d435i path whose RPN blocks run fused
FAST_OVERRIDES = (
    ("model.pfn.dense_cell", False),
    ("model.rpn.use_pallas_blocks", True),
)


def fast_config(cfg):
    for key, value in FAST_OVERRIDES:
        cfg = cfg.override(key, value)
    return cfg


def crowded_clouds(seed, b, maxpts, n_valid):
    """Clouds over the d435i range and a little beyond (out-of-range points),
    with one dense clump per sample (> 50 points in a cell: the cap) and
    exact duplicates; zero padding after n_valid."""
    r = np.random.RandomState(seed)
    pts = np.zeros((b, maxpts, 3), np.float32)
    for i in range(b):
        n = n_valid[i]
        p = np.stack([r.uniform(-0.5, 7.0, n), r.uniform(-3.0, 3.0, n),
                      r.uniform(-3.5, 3.5, n)], 1)
        clump = min(120, n // 4)
        p[:clump] = [3.045, 0.005, 0.5] + r.uniform(0, 0.07, (clump, 3))
        p[clump:clump + 10] = p[clump + 10:clump + 20]
        pts[i, :n] = r.permutation(p)
    return pts


def d435i_clouds(seed, batch, maxpts, n):
    """Uniform d435i-range clouds of n points, zero-padded to maxpts."""
    r = np.random.RandomState(seed)
    pts = np.zeros((batch, maxpts, 3), np.float32)
    for b in range(batch):
        pts[b, :n, 0] = r.uniform(0.0, 6.4, n)
        pts[b, :n, 1] = r.uniform(-2.56, 2.56, n)
        pts[b, :n, 2] = r.uniform(-3.0, 3.0, n)
    return pts, np.full((batch,), n, np.int32)


def standup_box_sets(seed, b, k, n_dup=10):
    """[b, k, 4] metric standup boxes (so the +1-pixel IoU matters) with
    exact duplicates, [b, k] scores with ties (8 levels) and [b, k] valid
    (~20% invalid)."""
    r = np.random.RandomState(seed)
    centers = r.uniform(0, 6, (b, k, 2)).astype(np.float32)
    sizes = r.uniform(0.3, 1.0, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    for i in range(b):
        boxes[i, r.choice(k, n_dup)] = boxes[i, r.choice(k, n_dup)]
    valid = r.uniform(size=(b, k)) > 0.2
    scores = (r.randint(0, 8, (b, k)) / 8.0).astype(np.float32)
    return boxes, scores, valid


# the reduced training setup of the train-step tests: the narrow model, a
# small point pad and pillar budget, four gt slots, batch 2
TRAIN_OVERRIDES = SMALL_OVERRIDES + (
    ("model.voxel.max_voxels", 512),
    ("model.target.max_gt_boxes", 4),
    ("train_input.batch_size", 2),
)


def train_config(config_cls):
    cfg = config_cls.default()
    for key, value in TRAIN_OVERRIDES:
        cfg = cfg.override(key, value)
    return cfg


def train_batches(seed, n_batches, b=2, maxpts=2048, max_gt=4, n=1500):
    """Padded train batches: uniform d435i-range clouds plus, per sample,
    1-3 pedestrian-sized boxes filled with points (so anchors match), the
    last gt slot padding (dims 1, invalid)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        pts = np.zeros((b, maxpts, 3), np.float32)
        num = np.zeros((b,), np.int32)
        gt = np.zeros((b, max_gt, 7), np.float32)
        gt[..., 3:6] = 1.0
        valid = np.zeros((b, max_gt), bool)
        for i in range(b):
            k = r.randint(1, max_gt)
            boxes = np.stack([r.uniform(1.0, 5.5, k), r.uniform(-2.0, 2.0, k),
                              np.full(k, -1.5), r.uniform(0.5, 0.8, k),
                              r.uniform(0.6, 1.0, k), r.uniform(1.5, 1.9, k),
                              r.uniform(-np.pi, np.pi, k)], 1)
            gt[i, :k], valid[i, :k] = boxes, True
            parts = [np.stack([bx[0] + r.uniform(-bx[3] / 2, bx[3] / 2, 120),
                               bx[1] + r.uniform(-bx[4] / 2, bx[4] / 2, 120),
                               bx[2] + r.uniform(0, bx[5], 120)], 1)
                     for bx in boxes]
            parts.append(np.stack([r.uniform(0, 6.4, n),
                                   r.uniform(-2.56, 2.56, n),
                                   r.uniform(-3, 1, n)], 1))
            cloud = r.permutation(np.concatenate(parts))[:maxpts]
            pts[i, :len(cloud)], num[i] = cloud, len(cloud)
        out.append(dict(points=pts, num_points=num, gt_boxes=gt,
                        gt_classes=np.ones((b, max_gt), np.int32),
                        gt_valid=valid))
    return out


# ----------------------------------------------------------------------
# runtime.compute_dtype=bfloat16: the port against the JAX package, both in
# bfloat16. Both round at the same points and differ only where an f32
# accumulation in another order moves a value across a bfloat16 rounding
# boundary: rare, and never more than one step of bfloat16 at one rounding
# point. Where two or more rounding points follow each other, such flips
# propagate (and grow through a BN), so whole networks are held relative to
# the gap between the JAX package in bfloat16 and in float32.

# The JAX side compiles with XLA's excess precision off, so that XLA keeps
# every bfloat16 rounding the JAX package's code asks for. With it on (XLA's
# default) XLA on the CPU drops the rounding of a conv's or Dense's output
# where a BatchNorm upcasts it at once: a compiler choice that moves the JAX
# package's own bfloat16 result by as much as the whole bfloat16-float32 gap
# (a _Block: rms 1.03 x the gap).
XLA_STRICT = {"xla_allow_excess_precision": False}


def jit_strict(fn, **kwargs):
    """``jax.jit(fn)`` compiled with :data:`XLA_STRICT`."""
    import jax

    return jax.jit(fn, compiler_options=XLA_STRICT, **kwargs)


# module criterion (one rounding point at the output): every element within
# one bfloat16 step of JAX's, at most this share of elements differing at all
BF16_MAX_SHARE = 0.01
# head criterion: rms(port - jax_bf16) <= BF16_RMS_FACTOR * rms(jax_bf16 -
# jax_f32) per head, and max |port - jax_bf16| <= BF16_MAX_FACTOR * max
# |jax_bf16 - jax_f32|
BF16_RMS_FACTOR = 0.25
BF16_MAX_FACTOR = 1.0
# ... except through the whole network at full width and depth (16 conv
# layers, 32 rounding points before the heads), where rare flips spread
# through every later layer: two faithful variants of the port itself
# (oneDNN's bfloat16 convs on and off, the same rounding points, another
# accumulation order) differ by 0.44 x the gap on the dense cell's class
# head, the port and the JAX package by 0.51, while dropping the rounding
# of every conv output (XLA's default excess precision) moves the JAX
# package by 0.87-1.03 x the gap. Whole full-width networks: 0.7.
BF16_RMS_FACTOR_FULL = 0.7


def _dtype_name(a):
    if hasattr(a, "detach"):
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def _f64(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().double().numpy()
    return np.asarray(a).astype(np.float64)


def _bf16_order(a):
    """bfloat16 values as integers in value order: neighbours differ by 1
    (+0 and -0 are both 0)."""
    if hasattr(a, "detach"):
        bits = a.detach().cpu().contiguous().view(
            __import__("torch").int16).numpy()
    else:
        bits = np.asarray(a).view(np.int16)
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def bf16_steps(got, want):
    """|got - want| in steps of bfloat16 (tensors or arrays of bfloat16)."""
    return np.abs(_bf16_order(got) - _bf16_order(want))


def bf16_rounded_close(got, want, rtol, label=""):
    """Two bfloat16 roundings of float32 results that agree within ``rtol``
    of their max |value| (the same sums in another order): every element
    within one bfloat16 step, or, near 0 where one step is finer than that
    float32 tolerance, within ``rtol`` * max |want|. Returns (share of the
    elements that differ, max steps apart)."""
    steps = bf16_steps(got, want)
    g, w = _f64(got), _f64(want)
    scale = np.abs(w).max()
    assert scale > 0, label
    ok = (steps <= 1) | (np.abs(g - w) <= rtol * scale)
    share = float((steps > 0).mean())
    print(f"{label}: {share:.2e} of {steps.size} elements differ, at most "
          f"{steps.max()} bf16 steps, max |diff| {np.abs(g - w).max():.3e} "
          f"(max |want| {scale:.3e})")
    assert ok.all(), f"{label}: {int((~ok).sum())} elements too far apart"
    return share, int(steps.max())


def module_criterion(got, want, label=""):
    """One rounding point: ``got`` (the port, a tensor) and ``want`` (the
    JAX package, an array) of the same dtype, every element within one
    bfloat16 step, at most BF16_MAX_SHARE of them differing. Returns the
    share."""
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16", (
        label, _dtype_name(got), _dtype_name(want))
    assert tuple(got.shape) == tuple(np.shape(want)), label
    steps = bf16_steps(got, want)
    share = float((steps > 0).mean())
    print(f"{label}: {share:.5f} of {steps.size} elements differ, at most "
          f"{steps.max()} bf16 step")
    assert steps.max() <= 1, f"{label}: {steps.max()} bf16 steps apart"
    assert share <= BF16_MAX_SHARE, f"{label}: {share} of elements differ"
    return share


def head_ratio(got, want, want_f32):
    """rms(got - want) / rms(want - want_f32)."""
    g, w, f = _f64(got), _f64(want), _f64(want_f32)
    return np.sqrt(np.mean((g - w) ** 2)) / np.sqrt(np.mean((w - f) ** 2))


def head_criterion(got, want, want_f32, label="",
                   rms_factor=BF16_RMS_FACTOR, max_factor=BF16_MAX_FACTOR):
    """Two or more rounding points: ``got`` (the port) in ``want``'s dtype
    (the JAX package in bfloat16), its rms distance to ``want`` within
    ``rms_factor`` of the rms gap between ``want`` and ``want_f32`` (the
    JAX package in float32), its max distance within ``max_factor`` of the
    max gap. Returns (rms ratio, max |got - want|)."""
    assert _dtype_name(got) == _dtype_name(want), (
        label, _dtype_name(got), _dtype_name(want))
    g, w, f = _f64(got), _f64(want), _f64(want_f32)
    assert g.shape == w.shape == f.shape, label
    gap_rms = np.sqrt(np.mean((w - f) ** 2))
    gap_max = np.abs(w - f).max()
    rms = np.sqrt(np.mean((g - w) ** 2))
    err = np.abs(g - w).max()
    assert gap_rms > 0, f"{label}: bfloat16 and float32 agree exactly"
    ratio = rms / gap_rms
    print(f"{label}: rms diff {rms:.3e} = {ratio:.4f} x the bf16-f32 gap "
          f"{gap_rms:.3e}; max diff {err:.3e} (gap max {gap_max:.3e})")
    assert ratio <= rms_factor, f"{label}: rms ratio {ratio} > {rms_factor}"
    assert err <= max_factor * gap_max, f"{label}: max {err}"
    return ratio, err


def heads_criterion(got, want, want_f32, label="",
                    rms_factor=BF16_RMS_FACTOR, max_factor=BF16_MAX_FACTOR):
    """:func:`head_criterion` over every head of a dict."""
    assert set(got) == set(want) == set(want_f32)
    return {k: head_criterion(got[k], want[k], want_f32[k], f"{label} {k}",
                              rms_factor, max_factor)
            for k in sorted(want)}


# ----------------------------------------------------------------------
# runtime.compute_dtype=bfloat16 training (tests/test_torch_bf16_train.py),
# on reduced configs at B=2 with random weights; the measurements come from
# tools/torch_bf16_train_spread.py (A: the port, B: the port with oneDNN's
# bfloat16 convs off, J: the JAX package). Train-mode BNs normalise with
# the batch's own statistics, so a rare flipped rounding (f32 sums in
# another order) moves every later layer's statistics and spreads through
# the 3x3 convs: the same networks in eval mode agree to 1e-4 of the gap,
# in train mode the heads sit 0.31-0.47 of the JAX package's bf16-f32 gap
# from J and 0.21-0.41 from each other (A-B). The instruction set oneDNN
# runs at is another faithful variant (``--networks`` under
# ONEDNN_MAX_CPU_ISA=AVX512_CORE or AVX2): there SECOND's new statistics
# sit 1.24 x the gap from J and 1.21 x between A and B (0.94 and 0.58 at
# oneDNN's default on an AMX CPU), the heads 0.67 and 0.66; maxima up to
# 1.16 x the gap's max. A single train-mode BN agrees within the module
# criterion; the JAX package's rounds away from the exactly rounded result
# 2.8 times as often as the port's. The train-mode forward (heads and new
# statistics):
BF16_RMS_FACTOR_TRAIN = 1.5
BF16_MAX_FACTOR_TRAIN = 1.5
# Loss parts, of one step and of three AdamW steps (lr 2e-3: each step moves
# every parameter by about lr, so flips grow step by step). The gap of a
# scalar can be small by chance, so it is held relative to its value too:
# over three steps A-B reach 5.1 x the gap and 1.8e-3 relative, A-J 13 x
# the gap (1.6e-3 relative) and 8.1e-3 relative (the debug-only positive
# split, a small part, at 2.1 x the gap). Within the larger of:
BF16_LOSS_GAP_FACTOR = 3.0
BF16_LOSS_RTOL = 1e-2
# Gradient leaves, against the larger of the leaf's bf16-f32 gap and one
# bfloat16 step of its values (the JAX package rounds each bfloat16 leaf
# once before the cast to float32; a 4-element bias gradient sits 19 x its
# gap from J and 6 x from B, one bfloat16 step): rms within
# BF16_GRAD_FACTOR, max within BF16_GRAD_MAX_FACTOR. Parameters after k
# AdamW steps: against the larger of their gap and lr (rms) or 2 k lr
# (max), a step's size and every step reversed (three steps: A-J up to 18.7
# x the gap alone, 1.13 x this yardstick; A-B 2.4 and 0.38).
BF16_GRAD_FACTOR = 1.5
BF16_GRAD_MAX_FACTOR = 1.5


def loss_criterion(got, want, want_f32, label=""):
    """A float32 scalar of a bfloat16 network (a loss part): ``got`` (the
    port) within BF16_LOSS_GAP_FACTOR of |want - want_f32| (the JAX
    package in bfloat16 and in float32), or within BF16_LOSS_RTOL of
    |want|, whichever is larger. Returns |got - want| / the gap."""
    g, w, f = float(got), float(want), float(want_f32)
    gap = abs(w - f)
    err = abs(g - w)
    tol = max(BF16_LOSS_GAP_FACTOR * gap, BF16_LOSS_RTOL * abs(w))
    print(f"{label}: port {g:.7g}, jax bf16 {w:.7g}, f32 {f:.7g}: |diff| "
          f"{err:.3e} = {err / max(gap, 1e-30):.4f} x the gap, "
          f"{err / max(abs(w), 1e-30):.2e} relative")
    assert err <= tol, f"{label}: |{g} - {w}| > {tol}"
    return err / max(gap, 1e-30)


def bf16_step(a):
    """One bfloat16 step (unit in the last place) at each |value| of ``a``
    (0 at 0)."""
    a = np.abs(np.asarray(a, np.float64))
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)


def grad_ratios(got, want, want_f32, floor_rms=None, floor_max=None):
    """(rms |got - want| over the rms yardstick, max |got - want| over the
    max yardstick) of a float32 leaf of a bfloat16 network's training: the
    yardstick is the larger of the bf16-f32 gap (want - want_f32) and, for
    a gradient, one bfloat16 step of ``want`` or, for a parameter, the
    floors."""
    g, w, f = (np.asarray(a, np.float64) for a in (got, want, want_f32))
    assert g.shape == w.shape == f.shape
    rms = lambda a: float(np.sqrt(np.mean(a ** 2)))  # noqa: E731
    if floor_rms is None:
        step = bf16_step(w)
        floor_rms, floor_max = rms(step), float(step.max())
    y_rms = max(rms(w - f), floor_rms)
    y_max = max(float(np.abs(w - f).max()), floor_max)
    if y_rms == 0:  # a leaf that is 0 in every run (no gradient reaches it)
        return (0.0, 0.0) if not np.any(g) else (np.inf, np.inf)
    return rms(g - w) / y_rms, float(np.abs(g - w).max()) / y_max


def grad_criterion(got, want, want_f32, label="", floor_rms=None,
                   floor_max=None):
    """:func:`grad_ratios` within BF16_GRAD_FACTOR (rms) and
    BF16_GRAD_MAX_FACTOR (max). Returns the rms ratio."""
    ratio, max_ratio = grad_ratios(got, want, want_f32, floor_rms, floor_max)
    print(f"{label}: rms diff {ratio:.4f} x the yardstick, max diff "
          f"{max_ratio:.4f} x its max")
    assert ratio <= BF16_GRAD_FACTOR, f"{label}: rms ratio {ratio}"
    assert max_ratio <= BF16_GRAD_MAX_FACTOR, f"{label}: max {max_ratio}"
    return ratio


# predictions in bfloat16, matched as sets. bfloat16 heads make exact score
# ties and near-tied boxes that trade slots, so valid slots are not compared
# one by one: each JAX detection, in descending score order, takes the
# unmatched port detection of its label with the nearest centre. A logit of
# O(1-10) moves by a bfloat16 step of 2^-7-2^-4 where a rare flip reaches
# it; sigmoid's slope is at most 1/4: scores within BF16_SCORE_ATOL. A box
# regresses from bfloat16 deltas (8 significant bits): centres, sizes and
# rotations within BF16_BOX_ATOL + BF16_BOX_RTOL * |value|. A detection is
# borderline, and may go unmatched, where its score lies within
# BF16_SCORE_ATOL of nms_score_threshold, where its +1-pixel IoU with a
# higher kept box lies within BF16_IOU_TOL of nms_iou_threshold, or where
# the set that lacks it kept a box of its label over it (IoU above
# nms_iou_threshold - BF16_IOU_TOL) scoring at least its score -
# BF16_SCORE_ATOL: NMS's order among near-tied scores chose the other box
# of an overlapping pair (and what that box suppresses). The rotation is
# compared modulo pi (the direction flip's) only where the JAX box's own
# rotation lies within BF16_ROT_FLIP_TOL of a multiple of pi.
BF16_SCORE_ATOL = 2e-2
BF16_BOX_ATOL = 5e-2
BF16_BOX_RTOL = 2e-2
# ... except for random-init weights, whose boxes reach 1e5 m: a size is
# anchor * exp(delta) with a log-size delta of 5-12, where one bfloat16 step
# of the delta (2^-5 in [4, 8)) moves the size by 3.2%. Two faithful
# variants of the port (oneDNN's bfloat16 convs on and off, with oneDNN
# capped at AVX512_CORE) flip one such step on the reduced simple_voxel
# path and need 0.0305; the port against the JAX package the same
# (tools/torch_bf16_train_spread.py --inference).
BF16_BOX_RTOL_RANDOM_INIT = 4e-2
BF16_IOU_TOL = 2e-2
BF16_ROT_FLIP_TOL = 5e-2


def _standup_iou(boxes):
    """[n, 7] lidar boxes -> [n, n] +1-pixel IoU of their standup BEV boxes
    (the NMS's)."""
    import torch

    from pillars_torch.geometry import boxes as gb
    from pillars_torch.ops.nms import _pixel_iou_matrix

    b = torch.as_tensor(np.asarray(boxes, np.float32))[:, [0, 1, 3, 4, 6]]
    corners = gb.center_to_corner_box2d(b[:, :2], b[:, 2:4], b[:, 4])
    return _pixel_iou_matrix(gb.corner_to_standup(corners)).numpy()


def _borderline(boxes, scores, i, score_thr, iou_thr):
    """Why detection ``i`` of one sample's valid set (descending scores) is
    borderline, or None."""
    if abs(scores[i] - score_thr) <= BF16_SCORE_ATOL and score_thr > 0:
        return f"score {scores[i]:.4f} at the threshold {score_thr}"
    iou = _standup_iou(boxes)[i]
    higher = [j for j in range(len(scores)) if scores[j] >= scores[i]
              and j != i]
    if higher and abs(iou[higher].max() - iou_thr) <= BF16_IOU_TOL:
        return f"IoU {iou[higher].max():.4f} at the threshold {iou_thr}"
    return None


def _suppressed_by(other, box, score, lab, iou_thr):
    """Why a detection (``box``, ``score``, label ``lab``) that the set
    ``other`` lacks may be absent there: ``other`` kept a box of that label
    over it with a near or higher score. None otherwise."""
    same = np.flatnonzero((other["labels"] == lab)
                          & (other["scores"] >= score - BF16_SCORE_ATOL))
    if not len(same):
        return None
    iou = _standup_iou(np.concatenate(
        [np.asarray(box)[None], other["boxes_lidar"][same]]))[0, 1:]
    k = int(np.argmax(iou))
    if iou[k] > iou_thr - BF16_IOU_TOL:
        return (f"the other set kept a box of score "
                f"{other['scores'][same[k]]:.4f} over it (IoU {iou[k]:.4f})")
    return None


def compare_predictions_bf16(want, got, score_thr, iou_thr, label="",
                             box_rtol=BF16_BOX_RTOL):
    """``want``: the JAX package's Predictions (NumPy leaves) in bfloat16
    compute, ``got``: the port's. Matches each sample's valid detections
    as sets (see above), boxes within BF16_BOX_ATOL + ``box_rtol`` x
    |value|; prints every borderline exception and returns their count."""
    exceptions = 0
    wv = np.asarray(want.valid)
    gv = got.valid.numpy()
    assert wv.any(), label
    for s in range(wv.shape[0]):
        sets = []
        for p, v in ((want, wv[s]), (got, gv[s])):
            order = np.argsort(-np.asarray(p.scores[s])[v], kind="stable")
            sets.append({k: np.asarray(getattr(p, k)[s])[v][order]
                         for k in ("boxes_lidar", "boxes_camera", "scores",
                                   "labels")})
        w, g = sets
        free = np.ones(len(g["scores"]), bool)
        missed = []
        for i in range(len(w["scores"])):
            cand = np.flatnonzero(free & (g["labels"] == w["labels"][i]))
            if len(cand):
                d = np.linalg.norm(g["boxes_lidar"][cand, :3]
                                   - w["boxes_lidar"][i, :3], axis=1)
                j = cand[np.argmin(d)]
                box_w = w["boxes_lidar"][i]
                tol = BF16_BOX_ATOL + box_rtol * np.abs(box_w[:3])
                if np.all(np.abs(g["boxes_lidar"][j, :3] - box_w[:3]) <= tol):
                    free[j] = False
                    _same_detection(w, i, g, j, f"{label} sample {s}",
                                    box_rtol)
                    continue
            missed.append(i)
        for side, idx, p, other in (("JAX", missed, w, g),
                                    ("port", np.flatnonzero(free), g, w)):
            for i in idx:
                why = (_borderline(p["boxes_lidar"], p["scores"], i,
                                   score_thr, iou_thr)
                       or _suppressed_by(other, p["boxes_lidar"][i],
                                         p["scores"][i], p["labels"][i],
                                         iou_thr))
                assert why is not None, (
                    f"{label} sample {s}: {side} detection {i} (score "
                    f"{p['scores'][i]:.4f}, box {p['boxes_lidar'][i]}) "
                    f"has no counterpart")
                print(f"{label} sample {s}: {side} detection {i} unmatched, "
                      f"borderline: {why}")
                exceptions += 1
    return exceptions


def _same_detection(w, i, g, j, label, box_rtol):
    assert abs(g["scores"][j] - w["scores"][i]) <= BF16_SCORE_ATOL, (
        label, g["scores"][j], w["scores"][i])
    # the flip adds pi where the lidar rotation's sign disagrees with the
    # direction head: a boundary where that rotation is near 0 (mod pi)
    near_flip = abs(np.sin(w["boxes_lidar"][i][6])) <= BF16_ROT_FLIP_TOL
    for name in ("boxes_lidar", "boxes_camera"):
        bw, bg = w[name][i].astype(np.float64), g[name][j].astype(np.float64)
        rot_w, rot_g = bw[6], bg[6]
        tol = BF16_BOX_ATOL + box_rtol * np.abs(bw)
        assert np.all(np.abs(bg[:6] - bw[:6]) <= tol[:6]), (label, name, bg,
                                                            bw)
        period = np.pi if near_flip else 2 * np.pi
        d = (rot_g - rot_w + period / 2) % period - period / 2
        assert abs(d) <= BF16_BOX_ATOL + box_rtol * abs(rot_w), (
            label, name, rot_g, rot_w)
