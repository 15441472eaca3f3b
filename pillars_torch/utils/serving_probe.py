"""What sets the serving rate: ``run_multi_stream`` on the card, saturated.

    python -m pillars_torch.utils.serving_probe [--seconds 2] [--out FILE]

Full-width d435i detector, trained checkpoint, a bank of 8 synthetic scenes
published round-robin. Needs a card; every number names it. Prints:

- saturated throughput (each stream publishes at 1000 Hz, more than one
  dispatch thread serves: a captured B=1 dispatch takes about 1.3 ms of
  the card) for 1, 4 and 8 streams, twice each, so that the spread between
  two runs of one kind shows;
- the device's busy and idle share of such a run at 1 and 4 streams
  (torch.profiler: kernel time summed over the run's wall time), with its
  CUDA graph launches and kernel launches per dispatch (a dispatch replays
  one captured graph, and each replay adds one to the NMS kernel's count);
- at 30 Hz and 4 streams, the latency the loop reports with an in-flight
  window of 1, 2 and 8: a result is handed on when the window is full, so
  the window, not the card, sets that latency below saturation.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

# per stream: above what one dispatch thread serves at any N
SATURATING_HZ = 1000.0


def main():
    from pillars_torch.config import Config
    from pillars_torch.data.stream import (bank_source, run_multi_stream,
                                           synthetic_bank)
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    root = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=str(
        root / "benchmarks" / "hard_synth" / "weights_59.pkl"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()

    cfg = Config.default()
    det = PillarsDetector(cfg)
    state = det.state_to_device(
        from_jax_variables(*load_params(args.weights), cfg))
    bank = synthetic_bank(8, seed=3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)

    def serve(n, hz, window=8):
        return run_multi_stream(
            cfg, det, state, num_streams=n, hz=hz, duration_s=args.seconds,
            window=window,
            source_fn=lambda mb, i: bank_source(mb, hz, args.seconds,
                                                bank[i:] + bank[:i]))

    result = {"card": card, "seconds": args.seconds, "saturated": [],
              "busy": [], "window": []}
    for n in (1, 4, 8):
        for _ in range(2):
            s = serve(n, SATURATING_HZ)
            result["saturated"].append({"streams": n, **s})
            print(f"saturated N={n}: {s['aggregate_hz']:8.2f} clouds/s, "
                  f"{s['per_stream_hz']:7.2f} per stream, p50 "
                  f"{s['latency_p50_ms']:.1f} ms, p99 "
                  f"{s['latency_p99_ms']:.1f} ms, skipped "
                  f"{s['frames_skipped']}")

    from torch.profiler import ProfilerActivity, profile

    from pillars_torch.ops import nms_cuda

    for n in (1, 4):
        before = nms_cuda.nms_keep_mask.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s = serve(n, SATURATING_HZ)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the warm-up call that captures runs eagerly and counts too
        dispatches = nms_cuda.nms_keep_mask.launches - before
        events = prof.key_averages()
        cuda = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        device_s = sum(e.self_device_time_total for e in cuda) / 1e6
        if not device_s > 0:
            raise RuntimeError("torch.profiler traced no CUDA kernel")
        graphs = sum(e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith("cudaGraphLaunch"))
        # this wall time spans the loop's warm-up call too
        busy = device_s / max(wall, 1e-9)
        result["busy"].append({
            "streams": n, "device_s": device_s, "wall_s": wall,
            "busy_share": busy, "idle_share": 1.0 - busy,
            "dispatches": dispatches,
            "graph_launches_per_dispatch": graphs / dispatches,
            "kernel_launches_per_dispatch": sum(
                e.count for e in cuda) / dispatches, **s})
        print(f"profiled N={n}: device busy {device_s:.4f} s of "
              f"{wall:.4f} s, idle share {1.0 - busy:.3f}; "
              f"{s['aggregate_hz']:.2f} clouds/s under the profiler; "
              f"{dispatches} dispatches, "
              f"{graphs / dispatches:.3f} graph launches and "
              f"{sum(e.count for e in cuda) / dispatches:.1f} kernel launches "
              f"per dispatch")

    for window in (1, 2, 8):
        s = serve(4, 30.0, window=window)
        result["window"].append({"window": window, **s})
        print(f"30 Hz N=4 window={window}: {s['aggregate_hz']:.2f} clouds/s, "
              f"p50 {s['latency_p50_ms']:.1f} ms, p99 "
              f"{s['latency_p99_ms']:.1f} ms, skipped {s['frames_skipped']}")

    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
