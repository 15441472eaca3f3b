"""The port's host NMS variants (pillars_torch/ops/nms_variants.py) against
the JAX package's on the same inputs (tests/test_nms_variants.py's cases
and random box sets from a NumPy seed): the same kept indices, the same
rescored scores."""

import numpy as np
import pytest

from pillars_torch.ops import nms_variants as tnv
from pillars_tpu.ops import nms_variants as jnv


def _rotated_sets():
    """(rbboxes [N, 5], scores [N]) cases: near-duplicate rotated boxes,
    axis-aligned boxes, disjoint boxes, and random sets with ties."""
    dup = (np.array([[2.0, 0.0, 0.6, 0.8, 0.4], [2.02, 0.01, 0.6, 0.8, 0.42],
                     [5.0, 2.0, 0.6, 0.8, -1.0]], np.float32),
           np.array([0.9, 0.8, 0.7], np.float32))
    r = np.random.RandomState(0)
    n = 30
    aligned = (np.stack([r.uniform(0, 6, n), r.uniform(-2, 2, n),
                         r.uniform(0.5, 1.5, n), r.uniform(0.5, 1.5, n),
                         np.zeros(n)], axis=1).astype(np.float32),
               r.uniform(0, 1, n).astype(np.float32))
    disjoint = np.tile([2.0, 0.0, 0.6, 0.8, 0.0], (10, 1)).astype(np.float32)
    disjoint[:, 0] += np.arange(10) * 3
    out = [dup, aligned, (disjoint, np.linspace(1, 0.1, 10).astype(
        np.float32))]
    for seed in (1, 2):
        r = np.random.RandomState(seed)
        n = 60
        boxes = np.stack([r.uniform(0, 4, n), r.uniform(-2, 2, n),
                          r.uniform(0.4, 1.2, n), r.uniform(0.4, 1.2, n),
                          r.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)
        scores = (r.randint(0, 6, n) / 6.0).astype(np.float32)
        out.append((boxes, scores))
    return out


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("thr,pre,post", [(0.5, None, None), (0.3, None, None),
                                          (0.5, 6, 4), (0.1, 20, None)])
def test_rotated_nms_matches_jax(case, thr, pre, post):
    boxes, scores = _rotated_sets()[case]
    got = tnv.rotated_nms(boxes, scores, thr, pre, post)
    want = jnv.rotated_nms(boxes, scores, thr, pre, post)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_rotated_nms_cases():
    """tests/test_nms_variants.py's expectations, on the port."""
    (dup, dup_s), _, (disjoint, lin) = _rotated_sets()[:3]
    assert list(tnv.rotated_nms(dup, dup_s, iou_threshold=0.5)) == [0, 2]
    assert list(tnv.rotated_nms(disjoint, lin, 0.5, pre_max_size=6,
                                post_max_size=4)) == [0, 1, 2, 3]
    assert len(tnv.rotated_nms(np.zeros((0, 5), np.float32),
                               np.zeros((0,), np.float32))) == 0


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("seed", [0, 1])
def test_soft_nms_matches_jax(method, seed):
    r = np.random.RandomState(seed)
    n = 40
    lo = r.uniform(0, 4, (n, 2))
    boxes = np.concatenate([lo, lo + r.uniform(0.3, 1.5, (n, 2))], 1)
    boxes[5:10] = boxes[:5] + 0.05  # heavy overlaps
    scores = r.uniform(0, 1, n)
    got = tnv.soft_nms(boxes, scores, method=method)
    want = jnv.soft_nms(boxes, scores, method=method)
    np.testing.assert_array_equal(got, want)
    assert (got <= scores + 1e-12).all() and (got < scores).any()


def test_soft_nms_cases():
    boxes = np.array([[0, 0, 1, 1], [0.1, 0.1, 1.1, 1.1], [5, 5, 6, 6]],
                     np.float64)
    out = tnv.soft_nms(boxes, np.array([0.9, 0.8, 0.7]))
    assert out[0] == pytest.approx(0.9)
    assert out[1] < 0.8
    assert out[2] == pytest.approx(0.7, abs=1e-6)
    same = np.array([[0, 0, 1, 1], [0.0, 0.0, 1.0, 1.0]], np.float64)
    out = tnv.soft_nms(same, np.array([0.9, 0.8]), method="linear")
    assert out[1] == pytest.approx(0.0, abs=1e-9)
