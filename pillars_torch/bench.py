"""The port's headline benchmark: the batch-1 inference rate on one card,
the counterpart of the JAX package's ``bench.py`` (its measurement,
``bench.py:41-176``).

    pillars-torch bench [--path dense|fast] [--dtype float32|bfloat16]
        [--batch 1] [--n-clouds 16] [--iters 1000] [--seed 0] [--device cpu]

It times the whole per-cloud path (voxelize, PFN, canvas, RPN, decode, NMS)
of ``Config.default()`` (``--path dense``, the dense cell) or of the
point-major path whose RPN blocks run in the fused kernel (``--path fast``:
``model.pfn.dense_cell`` false, ``model.rpn.use_pallas_blocks`` true), with
the trained checkpoint ``benchmarks/hard_synth/weights_59.pkl``, on a bank
of d435i-like clouds made from ``--seed``: for seed 0 the JAX package's
bank.

What is timed is what ``PillarsDetector.make_inference_fn`` returns: on the
card one captured CUDA graph per input shape (cuda_graph.py), fed the bank's
clouds from device memory. The kernels are built first and the input shape
is called once (on the card its eager first call and its capture); the
seconds of both are reported. Then, cycling through the bank:

- ``--iters`` calls back to back between two CUDA events: device ms per
  batch, the basis of ``value`` (clouds/s);
- ``--iters`` calls, each waited for, on the host clock: the latency of one
  call, p50 and p99.

It prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``
(against the reference's 120 clouds/s on an RTX 3090), ``mfu`` (achieved
FLOP/s over the card's published peak for the compute dtype) and ``bound``
(``utils/roofline.py``), ``device`` (the card's name and power limit) and
``detail`` (the settings, the times above, the kernels' launches per timed
call, the analytic bound). With ``--device cpu`` (asked for; nothing falls
back to it) the same loops run on the CPU and its host clock, and ``mfu``
and ``bound`` are null. The relay machinery of the JAX package's benchmark
(fault retries, the compile cache, the subtracted sync round trip) has no
counterpart: CUDA events time the card itself.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from pillars_torch.utils import tracing
from pillars_torch.utils.profiling import back_to_back

BASELINE_FPS = 120.0
WEIGHTS = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
           / "hard_synth" / "weights_59.pkl")
PATHS = {"dense": (),
         "fast": (("model.pfn.dense_cell", False),
                  ("model.rpn.use_pallas_blocks", True))}


def bench_config(path: str = "dense", dtype: str = "float32"):
    """``Config.default()`` for ``path`` ("dense" or "fast") in ``dtype``."""
    from pillars_torch.config import Config

    cfg = Config.default()
    for key, value in PATHS[path]:
        cfg = cfg.override(key, value)
    return cfg.override("runtime.compute_dtype", dtype)


def _build_bank(cfg, batch: int, n_clouds: int, n: int = 19200,
                seed: int = 0):
    """Host-side bank of d435i-like clouds (640x480 depth subsampled 1::4
    -> ~19k in-range points), plus per-batch counts and identity calibs:
    (points [n_clouds, batch, max_points, 3], num [batch], eye [batch, 4,
    4]), as ``bench.py:41-56`` makes them (which always uses seed 0)."""
    maxpts = cfg.model.voxel.max_points
    n = min(n, maxpts)
    rng = np.random.RandomState(seed)
    pts = np.zeros((n_clouds, batch, maxpts, 3), np.float32)
    for c in range(n_clouds):
        for b in range(batch):
            pts[c, b, :n, 0] = rng.uniform(0.0, 6.4, n)
            pts[c, b, :n, 1] = rng.uniform(-2.56, 2.56, n)
            pts[c, b, :n, 2] = rng.uniform(-3.0, 3.0, n)
    num = np.full((batch,), n, np.int32)
    eye = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    return pts, num, eye


def timed_call(det, state, pts, num, eye):
    """``call(i)``: batch ``i`` (modulo the bank) through ``det``'s
    ``make_inference_fn`` (``call.fn``), the bank and its counts on the
    detector's device, the identity for both calibrations; returns the
    Predictions. The call the benchmark times."""
    dev = det.device
    bank = torch.from_numpy(pts).to(dev)
    num_d = torch.from_numpy(num).to(dev)
    eye_d = torch.from_numpy(eye).to(dev)
    fn = det.make_inference_fn()

    def call(i: int):
        return fn(state, bank[i % len(bank)], num_d, eye_d, eye_d)

    call.fn = fn
    return call


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters (``<wrapper>.launches`` and
    ``fused_sep_block.launches_bf16``, which the wrappers declare)."""
    return {k: v for k, v in tracing.counters().items() if ".launches" in k}


def measure(call, device: torch.device, iters: int) -> Dict[str, object]:
    """Times ``call`` (:func:`timed_call`) on ``device``: its first call,
    then ``iters`` calls back to back (CUDA events on the card, the host
    clock on the CPU) and ``iters`` calls each waited for (host clock);
    returns the times in ms per batch and the kernels' launches per
    back-to-back call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    call(0)
    sync()
    first_s = time.perf_counter() - t0
    call(1)  # one warm call
    sync()

    before = _launch_counts()
    device_ms, host_ms = back_to_back(call, iters, device)
    after = _launch_counts()

    latency = []
    for i in range(iters):
        t0 = time.perf_counter()
        call(i)
        sync()
        latency.append((time.perf_counter() - t0) * 1e3)
    return {
        "device_ms_per_batch": device_ms,
        "host_ms_per_batch": host_ms,
        "latency_ms_p50": float(np.percentile(latency, 50)),
        "latency_ms_p99": float(np.percentile(latency, 99)),
        "latency_samples": len(latency),
        "first_call_s": first_s,
        "captured": bool(getattr(call.fn, "graphs", None)),
        "launches_per_call": {k: (after[k] - before[k]) / iters
                              for k in after},
    }


def card_name_and_power(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name (``torch.cuda.get_device_name``) and power limit
    (``nvidia-smi``, None where it is missing), or the CPU's label."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index or 0
    out = {"name": torch.cuda.get_device_name(index), "power_limit": None}
    if shutil.which("nvidia-smi"):
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        out["power_limit"] = lines[min(index, len(lines) - 1)].strip()
    return out


def run(path: str = "dense", dtype: str = "float32", batch: int = 1,
        n_clouds: int = 16, iters: int = 1000, seed: int = 0,
        device=None) -> Dict[str, object]:
    """The benchmark's result (the JSON line) for these settings; ``device``
    None is the card, which must be there."""
    from pillars_torch import resolve_device
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.utils.roofline import roofline_report
    from pillars_torch.weights import from_jax_variables, load_params

    dev = resolve_device(device)
    build_s = None
    if dev.type == "cuda":
        from pillars_torch.ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0
    cfg = bench_config(path, dtype)
    det = PillarsDetector(cfg, device=dev)
    state = det.state_to_device(
        from_jax_variables(*load_params(str(WEIGHTS)), cfg))
    pts, num, eye = _build_bank(cfg, batch, n_clouds, seed=seed)
    t = measure(timed_call(det, state, pts, num, eye), dev, iters)

    on_card = dev.type == "cuda"
    ms = t["device_ms_per_batch"] if on_card else t["host_ms_per_batch"]
    fps = round(1000.0 * batch / ms, 2)  # the reported value
    card = card_name_and_power(dev)
    rep = roofline_report(cfg, ms, batch=batch, device_name=card["name"],
                          dtype_bytes=4 if dtype == "float32" else 2)
    per, clock = ("card", "device") if on_card else ("cpu", "cpu host clock")
    return {
        "metric": (f"pointclouds/sec/{per} (e2e batch={batch}, {path}, "
                   f"{dtype}, {clock} ms/cloud={ms / batch:.3f})"),
        "value": fps,
        "unit": "clouds/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "mfu": rep["flop_frac"],
        "bound": rep["bound"],
        "device": card,
        "detail": {
            "path": path, "dtype": dtype, "batch": batch,
            "n_clouds": n_clouds, "iters": iters, "seed": seed,
            "build_s": build_s, **t,
            "model_tflops_per_cloud": rep["flops"] / batch / 1e12,
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "hbm_frac": rep["hbm_frac"],
        },
    }


def add_arguments(p: argparse.ArgumentParser) -> None:
    """The options of ``pillars-torch bench``."""
    p.add_argument("--path", choices=sorted(PATHS), default="dense",
                   help="dense: Config.default() (the dense cell); fast: "
                        "point-major with the fused RPN block kernel")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="float32", help="runtime.compute_dtype")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--n-clouds", type=int, default=16,
                   help="batches in the bank the calls cycle through")
    p.add_argument("--iters", type=int, default=1000,
                   help="calls per timed loop")
    p.add_argument("--seed", type=int, default=0,
                   help="NumPy seed of the bank (0: the JAX package's)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (cuda), which must "
                        "be there. 'cpu' must be asked for")


def main(args: argparse.Namespace) -> Dict[str, object]:
    """``pillars-torch bench``: prints the result as one JSON line."""
    result = run(args.path, args.dtype, args.batch, args.n_clouds,
                 args.iters, args.seed, args.device)
    print(json.dumps(result))
    return result
