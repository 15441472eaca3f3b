"""The serving slice on the card: the big-grid voxelizer against the port on
the CPU, bucketed dispatch bit-equal across rungs, and the multi-stream loop
serving bank frames through pinned staging at B=2.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_serving_cuda.py``
(``tests/conftest.py`` imports JAX; this file does not).
"""

import pathlib

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.ops.voxelize import make_point_voxelizer
from torch_parity import BOX_ATOL, BOX_RTOL, SCORE_ATOL, crowded_clouds

pytestmark = pytest.mark.cuda

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
MEAN_ATOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state_cpu():
    from pillars_torch.weights import from_jax_variables, load_params

    return from_jax_variables(*load_params(WEIGHTS), Config.default())


def scene_bank(count, seed=0):
    from pillars_torch.data.stream import synthetic_bank

    return synthetic_bank(count, seed)


@pytest.mark.parametrize("max_voxels", [2048, 9984])
def test_big_grid_voxelizer_card_equals_cpu(card, max_voxels):
    n = np.array([19200, 9000], np.int32)
    pts = crowded_clouds(8, 2, 19968, n)
    fn = make_point_voxelizer(Config.default().override(
        "model.voxel.max_voxels", max_voxels).model.voxel)
    want = fn(torch.from_numpy(pts), torch.from_numpy(n))
    got = fn(torch.from_numpy(pts).to(card), torch.from_numpy(n).to(card))
    for name, g, w in zip(want._fields, got, want):
        if name in ("point_mean", "voxel_mean"):
            assert torch.allclose(g.cpu(), w, atol=MEAN_ATOL, rtol=0), name
        else:
            assert torch.equal(g.cpu(), w), name


def test_bucketed_rungs_bit_equal_on_the_card(card, state_cpu):
    from pillars_torch.infer import BucketedInference

    cfg = Config.default().override("model.voxel.max_voxels", 2048)
    bi = BucketedInference(cfg, buckets=(4096, 8192, 19968))
    state = bi.state_to_device(state_cpu)
    frame = scene_bank(1, seed=2)[0][:4000]
    pts = np.zeros((1, 19968, 3), np.float32)
    pts[0, :len(frame)] = frame
    num = np.asarray([len(frame)], np.int32)
    eye = np.eye(4, dtype=np.float32)[None]
    outs = [bi._fn(b)(state, pts[:, :b], num, eye, eye) for b in bi.buckets]
    assert outs[0].valid.any()
    for out in outs[1:]:
        for name, x, y in zip(out._fields, out, outs[0]):
            assert torch.equal(x, y), name


def test_multi_stream_serves_bank_frames_at_b2(card, state_cpu):
    from pillars_torch.data.stream import bank_source, run_multi_stream
    from pillars_torch.models.detector import HostFetch, PillarsDetector

    cfg = Config.default()
    det = PillarsDetector(cfg)
    state = det.state_to_device(state_cpu)
    frames = scene_bank(4)
    fn = det.make_inference_fn()
    eye = np.eye(4, dtype=np.float32)[None]
    wanted = []
    for f in frames:
        pts = np.zeros((1, cfg.model.voxel.max_points, 3), np.float32)
        pts[0, :len(f)] = f
        p = HostFetch(fn(state, pts, np.asarray([len(f)], np.int32), eye,
                         eye)).result()
        keep = p.valid[0] & (p.scores[0] >= cfg.runtime.prediction_min_score)
        wanted.append((p.boxes_lidar[0][keep], p.scores[0][keep]))
    served = []
    stats = run_multi_stream(
        cfg, det, state, num_streams=2, hz=60.0, duration_s=1.0, window=4,
        on_detections=lambda i, b, s: served.append((b, s)),
        source_fn=lambda mb, i: bank_source(mb, 60.0, 1.0,
                                            frames[i:] + frames[:i]))
    assert stats["frames_processed"] == len(served) >= 2
    for boxes, scores in served:
        assert any(len(s) == len(scores)
                   and np.allclose(scores, s, atol=SCORE_ATOL, rtol=0)
                   and np.allclose(boxes, b, atol=BOX_ATOL, rtol=BOX_RTOL)
                   for b, s in wanted)
