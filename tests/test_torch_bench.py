"""The port's headline benchmark (pillars_torch/bench.py) on the CPU: its
bank of clouds equals the JAX package's (``bench.py``) point for point, the
call it times gives ``make_inference_fn``'s detections (and, on the dense
cell, the JAX package's within ``torch_parity.compare_predictions``'
tolerances) on a narrow config, its measurement reports what it says, and
``pillars-torch bench --device cpu`` prints one JSON line with the JAX
benchmark's keys."""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
import jax

from pillars_torch import bench
from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.weights import from_jax_variables
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from torch_parity import (SMALL_OVERRIDES, compare_predictions,
                          randomize_variables)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KEYS = ("metric", "value", "unit", "vs_baseline", "mfu", "bound")


@pytest.mark.parametrize("batch,n_clouds,max_points", [
    (1, 3, None), (2, 2, None), (1, 2, 4096), (3, 1, 2048)])
def test_bank_equals_bench_py(batch, n_clouds, max_points):
    tcfg, jcfg = TorchConfig.default(), JaxConfig.default()
    if max_points is not None:
        tcfg = tcfg.override("model.voxel.max_points", max_points)
        jcfg = jcfg.override("model.voxel.max_points", max_points)
    got = bench._build_bank(tcfg, batch, n_clouds)
    want = jax_bench._build_bank(jcfg, batch, n_clouds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (n_clouds, batch, tcfg.model.voxel.max_points, 3)
    other = bench._build_bank(tcfg, batch, n_clouds, seed=1)[0]
    assert not np.array_equal(other, got[0])


def _narrow(cfg, path):
    for key, value in SMALL_OVERRIDES + bench.PATHS[path]:
        cfg = cfg.override(key, value)
    return cfg


@pytest.mark.parametrize("path", ["dense", "fast"])
def test_timed_call_gives_make_inference_fn_detections(path):
    tcfg = _narrow(bench.bench_config(path), path)
    jcfg = _narrow(JaxConfig.default(), path)
    variables = randomize_variables(
        jax.device_get(JaxDetector(jcfg).init(jax.random.PRNGKey(0))),
        seed=11)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    det = TorchDetector(tcfg, device="cpu")
    pts, num, eye = bench._build_bank(tcfg, 1, 3, seed=4)
    call = bench.timed_call(det, state, pts, num, eye)
    got = call(4)  # cloud 1 of the bank
    want = det.make_inference_fn()(state, *map(torch.from_numpy,
                                               (pts[1], num, eye, eye)))
    assert got.valid.any()
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    if path == "dense":
        compare_predictions(
            jax.device_get(JaxDetector(jcfg).make_inference_fn()(
                variables, pts[1], num, eye, eye)), got)


def test_measure_on_the_cpu():
    """The CPU's run of the measurement: no graph, no CUDA event, no kernel
    launch (the wrappers take their plain twins), one latency per call."""
    tcfg = _narrow(bench.bench_config("fast"), "fast")
    det = TorchDetector(tcfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(0), batch_size=1)
    pts, num, eye = bench._build_bank(tcfg, 2, 2)
    t = bench.measure(bench.timed_call(det, state, pts, num, eye),
                      torch.device("cpu"), 3)
    assert t["device_ms_per_batch"] is None and t["captured"] is False
    assert t["latency_samples"] == 3
    assert 0 < t["latency_ms_p50"] <= t["latency_ms_p99"]
    assert t["host_ms_per_batch"] > 0 and t["first_call_s"] > 0
    assert t["launches_per_call"] == {"nms_keep_mask.launches": 0.0,
                                      "fused_sep_block.launches": 0.0,
                                      "fused_sep_block.launches_bf16": 0.0,
                                      "bn_relu.launches": 0.0,
                                      "pfn_max.launches": 0.0}


def test_cli_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "pillars_torch.cli", "bench", "--device",
         "cpu", "--n-clouds", "2", "--iters", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    result = json.loads(lines[0])
    for key in KEYS:
        assert key in result, key
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert result["unit"] == "clouds/s"
    assert result["vs_baseline"] == round(result["value"] / 120.0, 3)
    assert result["metric"].startswith("pointclouds/sec/cpu (e2e batch=1, "
                                       "dense, float32")
    assert result["mfu"] is None and result["bound"] is None
    assert result["device"]["name"] == "cpu"
    detail = result["detail"]
    assert (detail["path"], detail["dtype"], detail["iters"]) == (
        "dense", "float32", 2)
    assert detail["model_tflops_per_cloud"] > 0
