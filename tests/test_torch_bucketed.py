"""Bucketed dispatch of the port (pillars_torch/infer.py): the counterpart of
every case of tests/test_bucketed.py, then the port against pillars_tpu per
rung, on the CPU.

Within the port a cloud gives the same BITS in every rung that holds it, as
long as the rungs run one front end (``small_config``: max_voxels 2048 keeps
every rung point-major). Port against JAX, and the default d435i ladder,
whose two rungs run different front ends: valid and labels equal, scores
within 1e-5, boxes within 1e-4 + 2e-5 relative
(``torch_parity.compare_predictions``).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax

from pillars_torch.config import Config
from pillars_torch.infer import (BucketedInference, default_bucket_ladder,
                                 parse_bucket_arg)
from pillars_torch.models.detector import PillarsDetector, Predictions
from pillars_torch.weights import from_jax_variables, load_params
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.infer import BucketedInference as JaxBucketedInference
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import compare_predictions

torch.set_num_threads(2)

WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")


def small_config(config_cls=Config):
    cfg = config_cls.default()
    cfg = cfg.override("model.voxel.max_voxels", 2048)
    cfg = cfg.override("model.voxel.max_points", 4096)
    return cfg


CFG = small_config()
EYE = np.eye(4, dtype=np.float32)[None]


@pytest.fixture(scope="module")
def jax_variables():
    # the trained checkpoint: random weights at full width and depth push
    # box regressions to 1e10 m, where no tolerance means anything
    params, stats = jax_load_params(WEIGHTS)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def state():
    return from_jax_variables(*load_params(WEIGHTS), CFG)


def make_cloud(rng, n, width):
    pts = np.zeros((1, width, 3), np.float32)
    pts[0, :n, 0] = rng.uniform(0.2, 6.2, n)
    pts[0, :n, 1] = rng.uniform(-2.4, 2.4, n)
    pts[0, :n, 2] = rng.uniform(-2.5, 0.5, n)
    return pts


def assert_bit_equal(a: Predictions, b: Predictions):
    for name, x, y in zip(Predictions._fields, a, b):
        assert torch.equal(x, y), name


class TestLadder:
    def test_default_ladder_halves_to_floor(self):
        assert default_bucket_ladder(131072) == (32768, 65536, 131072)
        assert default_bucket_ladder(4096) == (4096,)
        assert default_bucket_ladder(32768, levels=4, min_bucket=4096) == \
            (4096, 8192, 16384, 32768)
        assert default_bucket_ladder(19968) == (9984, 19968)

    def test_select_bucket(self):
        bi = BucketedInference(CFG, buckets=[1024, 2048, 4096], device="cpu")
        assert bi.select_bucket(0) == 1024
        assert bi.select_bucket(1024) == 1024
        assert bi.select_bucket(1025) == 2048
        assert bi.select_bucket(4096) == 4096
        # oversize clouds fall back to the top bucket (truncation,
        # matching the fixed path)
        assert bi.select_bucket(999999) == 4096

    def test_rejects_bad_buckets(self):
        with pytest.raises(ValueError):
            BucketedInference(CFG, buckets=[], device="cpu")
        with pytest.raises(ValueError):
            BucketedInference(CFG, buckets=[0, 1024], device="cpu")

    def test_parse_bucket_arg_validation(self):
        assert parse_bucket_arg("", 4096) is None
        assert parse_bucket_arg(None, 4096) is None
        assert parse_bucket_arg("auto", 131072) == (32768, 65536, 131072)
        assert parse_bucket_arg("4096,1024", 4096) == (1024, 4096)
        with pytest.raises(SystemExit):
            parse_bucket_arg("32k", 4096)
        with pytest.raises(SystemExit):
            parse_bucket_arg("-5,100", 4096)
        assert parse_bucket_arg("1024,999999", 4096) == (1024, 4096)

    def test_evaluator_pads_batch_up_to_wide_bucket(self):
        """A CLI bucket wider than the dataset's padded width must pad UP
        in _device_put so dispatch keys an exact (warmed) rung."""
        from pillars_torch.train.trainer import Evaluator

        ev = object.__new__(Evaluator)  # dataset-free: pin _device_put only
        ev._bucketed = BucketedInference(CFG, buckets=[4096], device="cpu")
        ev.device = torch.device("cpu")
        ev.cfg = CFG
        batch = {"points": np.zeros((2, 1000, 3), np.float32),
                 "num_points": np.array([500, 700], np.int32)}
        out = ev._device_put(batch)
        assert out["points"].shape[1] == 4096
        # and slicing down still works
        wide = {"points": np.zeros((2, 8192, 3), np.float32),
                "num_points": np.array([10, 10], np.int32)}
        out = ev._device_put(wide)
        assert out["points"].shape[1] == 4096

    def test_no_card_without_explicit_cpu_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            BucketedInference(CFG, buckets=[1024])


class TestEquality:
    """Same cloud, every rung: bit-equal predictions."""

    def test_bucket_invariance(self, state, rng):
        n = 700
        pts = make_cloud(rng, n, 4096)
        num = np.asarray([n], np.int32)
        bi = BucketedInference(CFG, buckets=[1024, 2048, 4096], device="cpu")
        outs = [bi._fn(b)(state, pts[:, :b], num, EYE, EYE)
                for b in bi.buckets]
        assert outs[-1].valid.any()
        for out in outs[:-1]:
            assert_bit_equal(outs[-1], out)

    def test_dispatch_matches_fixed_graph(self, state, rng):
        """__call__ (slice/pad + bucket pick) == the fixed worst-case
        width on the same cloud."""
        n = 700
        pts = make_cloud(rng, n, 4096)
        num = np.asarray([n], np.int32)
        det = PillarsDetector(CFG, device="cpu")
        fixed = det.make_inference_fn()(state, pts, num, EYE, EYE)

        bi = BucketedInference(CFG, buckets=[1024, 4096], device="cpu")
        assert bi.select_bucket(n) == 1024
        assert_bit_equal(fixed, bi(state, pts, num, EYE, EYE))

    def test_dispatch_pads_short_input(self, state, rng):
        """A tight [1, n, 3] input pads up to the bucket and matches the
        pre-padded call, as an array and as a tensor."""
        n = 50
        pts = make_cloud(rng, n, n)  # no padding at all
        num = np.asarray([n], np.int32)
        bi = BucketedInference(CFG, buckets=[1024, 4096], device="cpu")
        out_tight = bi(state, pts, num, EYE, EYE)
        padded = np.zeros((1, 4096, 3), np.float32)
        padded[:, :n] = pts
        out_padded = bi(state, padded, num, EYE, EYE)
        # same bucket (1024) both times -> bit-equal
        assert_bit_equal(out_tight, out_padded)
        assert_bit_equal(out_tight, bi(state, torch.from_numpy(pts), num,
                                       EYE, EYE))
        assert_bit_equal(out_tight, bi(state, torch.from_numpy(padded), num,
                                       EYE, EYE))

    def test_rungs_share_one_fold_of_the_block_weights(self, state, rng):
        cfg = CFG.override("model.pfn.dense_cell", False).override(
            "model.rpn.use_pallas_blocks", True)
        bi = BucketedInference(cfg, buckets=[1024, 4096], device="cpu")
        for n in (300, 2000):
            pts = make_cloud(rng, n, 4096)
            bi(state, pts, np.asarray([n], np.int32), EYE, EYE)
        d1, d2 = bi._dets[1024], bi._dets[4096]
        assert d1.fast and d1.folded_blocks is d2.folded_blocks
        assert d1.folded_blocks.folds == 1


class TestAgainstJax:
    @pytest.mark.parametrize("bucket", [1024, 2048, 4096])
    def test_rung_matches_jax_rung(self, jax_variables, state, bucket):
        n = 900
        pts = make_cloud(np.random.RandomState(bucket), n, bucket)
        num = np.asarray([n], np.int32)
        jbi = JaxBucketedInference(small_config(JaxConfig),
                                   buckets=[1024, 2048, 4096])
        want = jax.device_get(jbi._fn(bucket)(jax_variables, pts, num,
                                              EYE, EYE))
        bi = BucketedInference(CFG, buckets=[1024, 2048, 4096], device="cpu")
        compare_predictions(want, bi._fn(bucket)(state, pts, num, EYE, EYE))

    def test_default_d435i_ladder_across_both_front_ends(self, jax_variables,
                                                         state):
        """Full width, trained weights: the 9984 rung clamps max_voxels
        below the grid's 10240 cells and runs the point-major big-grid
        voxelizer, the 19968 rung the dense-cell front end. Each against
        the JAX package's same rung, and the two rungs against each
        other."""
        cfg, jcfg = Config.default(), JaxConfig.default()
        bi = BucketedInference(cfg, device="cpu")
        assert bi.buckets == (9984, 19968)
        jbi = JaxBucketedInference(jcfg)

        n = 9000
        pts = make_cloud(np.random.RandomState(5), n, 19968)
        num = np.asarray([n], np.int32)
        low = bi(state, pts, num, EYE, EYE)
        assert not bi._dets[9984].dense_cell
        want_low = jax.device_get(jbi(jax_variables, pts, num, EYE, EYE))
        compare_predictions(want_low, low)
        high = bi._fn(19968)(state, pts, num, EYE, EYE)
        assert bi._dets[19968].dense_cell
        want_high = jax.device_get(jbi._fn(19968)(jax_variables, pts,
                                                  num, EYE, EYE))
        compare_predictions(want_high, high)
        compare_predictions(Predictions(*(t.numpy() for t in high)), low)


class TestEvaluatorIntegration:
    def test_bucketed_eval_matches_fixed(self, tmp_path, state):
        """Evaluator(buckets=...) slices batches to the bucket before they
        go to the device and must produce the same annos as the fixed
        width."""
        from pillars_torch.data import synthetic
        from pillars_torch.train.trainer import Evaluator

        root = str(tmp_path / "synth")
        synthetic.generate_dataset(root, num_train=2, num_test=3, seed=5)
        cfg = CFG.override("eval_input.info_path",
                           f"{root}/kitti_infos_val.pkl")
        cfg = cfg.override("eval_input.dataset_root", root)
        cfg = cfg.override("eval_input.batch_size", 2)
        cfg = cfg.override("runtime.num_devices", 1)
        cfg = cfg.override("eval_input.num_workers", 0)
        det = PillarsDetector(cfg, device="cpu")

        dt_fixed, gt = Evaluator(cfg, det).run(state, progress=False)
        ev = Evaluator(cfg, det, buckets=[1024, 4096])
        dt_bucketed, _ = ev.run(state, progress=False)

        assert len(dt_fixed) == len(dt_bucketed) == len(gt) == 3
        assert any(len(a["name"]) for a in dt_fixed)
        for a, b in zip(dt_fixed, dt_bucketed):
            assert list(a["name"]) == list(b["name"])
            np.testing.assert_allclose(a["score"], b["score"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(a["location"], b["location"],
                                       rtol=1e-5, atol=1e-5)


class TestStreamIntegration:
    def test_run_stream_with_buckets(self, state):
        from pillars_torch.data.stream import run_stream
        det = PillarsDetector(CFG, device="cpu")
        stats = run_stream(CFG, det, state, hz=60.0, duration_s=0.5,
                           source="synthetic", window=2,
                           buckets=[1024, 4096])
        assert stats["frames_processed"] >= 1
