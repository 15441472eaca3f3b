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
