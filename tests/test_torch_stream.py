"""The port's streaming loops (pillars_torch/data/stream.py) on the CPU: the
mailbox, ``run_stream`` and ``run_multi_stream`` with the trained d435i
checkpoint at full width on a reduced point pad, and the stale-slot rule
(``num_valid = 0``) against pillars_tpu on both front ends.

A served detection set must be the directly computed B=1 result of one of
the bank's frames (the mailbox drops frames, so which one is not known; a
corrupted staging buffer matches none): the same number of boxes, scores
within 1e-5, boxes within 1e-4 + 2e-5 relative.
"""

import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import jax

from pillars_torch.config import Config
from pillars_torch.data import stream
from pillars_torch.data.stream import (LatestFrameMailbox, bank_source,
                                       run_multi_stream, run_stream)
from pillars_torch.models.detector import HostFetch, PillarsDetector
from pillars_torch.weights import from_jax_variables, load_params
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.data import stream as jax_stream
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import (BOX_ATOL, BOX_RTOL, SCORE_ATOL, compare_predictions,
                          fast_config)

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")
MAXPTS = 4096
CFG = Config.default().override("model.voxel.max_points", MAXPTS)


@pytest.fixture(scope="module")
def state():
    return from_jax_variables(*load_params(WEIGHTS), CFG)


def scene_bank(n_frames, seed=0):
    """Scenes with pedestrians, thinned to the reduced point pad."""
    return stream.synthetic_bank(n_frames, seed, max_points=MAXPTS)


def direct_results(cfg, det, state, frames):
    """The B=1 detections of every frame, filtered as the loops filter."""
    fn = det.make_inference_fn(cfg.eval_input.anchor_area_threshold)
    eye = np.eye(4, dtype=np.float32)[None]
    out = []
    for frame in frames:
        pts = np.zeros((1, MAXPTS, 3), np.float32)
        pts[0, :len(frame)] = frame
        p = HostFetch(fn(state, pts, np.asarray([len(frame)], np.int32),
                         eye, eye)).result()
        keep = p.valid[0] & (p.scores[0] >= cfg.runtime.prediction_min_score)
        out.append((p.boxes_lidar[0][keep], p.scores[0][keep]))
    return out


def matches_one(boxes, scores, wanted):
    return any(
        len(s) == len(scores)
        and np.allclose(scores, s, atol=SCORE_ATOL, rtol=0)
        and np.allclose(boxes, b, atol=BOX_ATOL, rtol=BOX_RTOL)
        for b, s in wanted)


class TestMailbox:
    def test_newest_wins_and_skipped_count(self):
        mb = LatestFrameMailbox()
        for i in range(5):
            mb.publish(i)
        frame, skipped = mb.take(timeout=0)
        assert (frame, skipped) == (4, 4)
        assert mb.take(timeout=0) == (None, 0)  # nothing newer
        mb.publish(5)
        assert mb.take(timeout=0) == (5, 0)

    def test_close_wakes_a_waiting_take(self):
        mb = LatestFrameMailbox()
        threading.Timer(0.05, mb.close).start()
        t0 = time.perf_counter()
        assert mb.take(timeout=5.0) == (None, 0)
        assert time.perf_counter() - t0 < 2.0
        assert mb.closed

    def test_frame_published_before_close_is_still_taken(self):
        mb = LatestFrameMailbox()
        mb.publish("last")
        mb.close()
        assert mb.take(timeout=0) == ("last", 0)
        assert mb.take(timeout=0) == (None, 0)

    def test_timeout_zero_does_not_block(self):
        mb = LatestFrameMailbox()
        t0 = time.perf_counter()
        assert mb.take(timeout=0) == (None, 0)
        assert time.perf_counter() - t0 < 0.5

    def test_bank_source_cycles_and_closes(self):
        mb = LatestFrameMailbox()
        t = bank_source(mb, hz=200.0, duration_s=0.2, frames=["a", "b"])
        seen = set()
        while True:
            frame, _ = mb.take(timeout=2.0)
            if frame is None:
                break
            seen.add(frame)
        t.join(timeout=2.0)
        assert seen == {"a", "b"} and mb.closed


class TestLoops:
    def test_run_multi_stream_serves_bank_frames(self, state):
        det = PillarsDetector(CFG, device="cpu")
        frames = scene_bank(4)
        wanted = direct_results(CFG, det, state, frames)
        assert any(len(s) for _, s in wanted)
        served = []
        stats = run_multi_stream(
            CFG, det, state, num_streams=2, hz=30.0, duration_s=1.0,
            window=2,
            on_detections=lambda i, b, s: served.append((i, b, s)),
            source_fn=lambda mb, i: bank_source(mb, 30.0, 1.0,
                                                frames[i:] + frames[:i]))
        assert stats["frames_processed"] == len(served) >= 2
        assert {i for i, _, _ in served} == {0, 1}
        assert sum(stats["per_stream_processed"]) == stats["frames_processed"]
        for i, boxes, scores in served:
            assert matches_one(boxes, scores, wanted), (i, scores)

    def test_run_stream_detections_and_publisher(self, state, tmp_path):
        from pillars_torch.viz.publisher import make_publisher

        det = PillarsDetector(CFG, device="cpu")
        served = []
        pub = make_publisher("offline", out_dir=str(tmp_path))
        stats = run_stream(CFG, det, state, hz=30.0, duration_s=0.6,
                           window=2, publisher=pub,
                           on_detections=lambda b, s: served.append((b, s)))
        assert stats["frames_processed"] == len(served) >= 1
        for boxes, scores in served:
            assert boxes.shape == (len(scores), 7)
            assert np.isfinite(boxes).all()
        assert any(tmp_path.iterdir())  # the offline publisher recorded

    def test_unknown_source_raises(self, state):
        det = PillarsDetector(CFG, device="cpu")
        with pytest.raises(ValueError, match="unknown stream source"):
            run_stream(CFG, det, state, duration_s=0.1, source="nope")

    def test_result_dicts_have_the_jax_keys(self, state):
        """Same arguments, same result keys as the JAX package's loops."""
        import inspect

        det = PillarsDetector(CFG, device="cpu")
        single = run_stream(CFG, det, state, hz=30.0, duration_s=0.3)
        multi = run_multi_stream(CFG, det, state, num_streams=2, hz=30.0,
                                 duration_s=0.3)
        jcfg = JaxConfig.default().override("model.voxel.max_points", MAXPTS)
        jdet = JaxDetector(jcfg)
        params, stats = jax_load_params(WEIGHTS)
        variables = {"params": params, "batch_stats": stats}
        jsingle = jax_stream.run_stream(jcfg, jdet, variables, hz=30.0,
                                        duration_s=0.3)
        jmulti = jax_stream.run_multi_stream(jcfg, jdet, variables,
                                             num_streams=2, hz=30.0,
                                             duration_s=0.3)
        assert list(single) == list(jsingle)
        assert list(multi) == list(jmulti)
        for name in ("run_stream", "run_multi_stream", "synthetic_source",
                     "bank_source", "replay_source", "ros_source"):
            want = list(inspect.signature(getattr(jax_stream, name))
                        .parameters)
            got = list(inspect.signature(getattr(stream, name)).parameters)
            assert got == want, name


class TestStaleSlot:
    """A slot with num_valid = 0 rides along and gives no valid detection;
    the fresh slot is what it is alone."""

    @pytest.mark.parametrize("front_end", ["dense_cell", "point_major_fast",
                                           "point_major_big_grid"])
    def test_against_jax(self, front_end):
        tcfg, jcfg = CFG, JaxConfig.default().override(
            "model.voxel.max_points", MAXPTS)
        if front_end == "point_major_fast":
            tcfg, jcfg = fast_config(tcfg), fast_config(jcfg)
        elif front_end == "point_major_big_grid":
            tcfg = tcfg.override("model.voxel.max_voxels", 2048)
            jcfg = jcfg.override("model.voxel.max_voxels", 2048)
        det = PillarsDetector(tcfg, device="cpu")
        assert det.dense_cell == (front_end == "dense_cell")
        state = from_jax_variables(*load_params(WEIGHTS), tcfg)
        params, stats = jax_load_params(WEIGHTS)
        variables = {"params": params, "batch_stats": stats}

        frames = scene_bank(2, seed=4)
        pts = np.zeros((2, MAXPTS, 3), np.float32)
        for i, f in enumerate(frames):  # the stale slot holds old points
            pts[i, :len(f)] = f
        num = np.asarray([len(frames[0]), 0], np.int32)
        eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
            variables, pts, num, eye, eye))
        got = det.make_inference_fn()(state, pts, num, eye, eye)
        assert not np.asarray(want.valid)[1].any()
        assert not got.valid[1].any()
        compare_predictions(want, got)
        alone = det.make_inference_fn()(state, pts[:1], num[:1], eye[:1],
                                        eye[:1])
        assert torch.equal(alone.valid[0], got.valid[0])
        assert torch.allclose(alone.scores[0][alone.valid[0]],
                              got.scores[0][got.valid[0]], atol=SCORE_ATOL)
