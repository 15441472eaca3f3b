"""Timing: the host-side stage timer with the reference's stage names, a
Chrome trace of a block (``profiler_trace``), and on the card CUDA-event
timers, per-stage breakdowns of the d435i inference paths (each stage a
captured graph of its own, timed in device ms), the train step's launches
and device ms by stage (``train_stage_breakdown``) and a torch.profiler
pass for the device's busy share.

    python -m pillars_torch.utils.profiling [--path dense|fast] [--iters 50]
                                            [--out FILE]

runs ``PillarsDetector`` with the trained checkpoint on d435i-sized clouds
(19200 points, NumPy seed 0) at B=1: ``--path dense`` (the default) the
dense-cell path of ``Config.default()``, ``--path fast`` the point-major path
whose RPN blocks run fused (``model.pfn.dense_cell`` false,
``model.rpn.use_pallas_blocks`` true). It prints, in ms per cloud: each stage
alone (captured, replayed back to back), the whole path as
``make_inference_fn`` gives it (a captured CUDA graph; three times, for the
spread) and run eagerly, the device time per cloud summed over its kernels,
the idle share, the graph and kernel launches per cloud and the longest
kernels. Needs a card; the numbers name it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

# reference SURVEY 5.1: rolling last-10-sample windows (train.py:629-861)
STAGES = ("t_full_sample", "t_preprocess", "t_network", "t_predict",
          "t_anno", "t_rviz")


class StageTimer:
    """Rolling-window wall-clock stage timer (window=10 like the reference;
    pillars_tpu/utils/profiling.py::StageTimer). Host time: a stage that
    only enqueues work on the card reads as the time to enqueue it. Each
    stage is also a span of its name (utils/tracing.py), enabled or not."""

    def __init__(self, enabled: bool = True, window: int = 10,
                 sync: bool = False):
        self.enabled = enabled
        self.window = window
        self.sync = sync
        self._hist: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    @contextlib.contextmanager
    def stage(self, name: str):
        from pillars_torch.utils import tracing

        with tracing.span(name):
            if not self.enabled:
                yield
                return
            t0 = time.perf_counter()
            yield
            self._hist[name].append((time.perf_counter() - t0) * 1e3)

    def add(self, name: str, ms: float):
        if self.enabled:
            self._hist[name].append(ms)

    def averages(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._hist.items() if v}

    def report(self) -> str:
        msg = ", ".join(f"{k}: {v:.2f}" for k, v in self.averages().items())
        print(msg)
        return msg


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Trace the block under ``torch.profiler`` (the CPU, and the card's
    kernels where there is one) and write it to ``log_dir`` as a Chrome
    trace, ``trace.json`` (chrome://tracing, Perfetto); the counterpart of
    the JAX package's ``jax.profiler`` trace. Tracing is on inside the
    block, so the program's spans are ranges of the trace. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from pillars_torch.utils import tracing

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with tracing.tracing_on(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Warm mean ms per call of ``fn`` between two CUDA events. When the
    host issues work slower than the card runs it, this is the issue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _tensors(out) -> List[torch.Tensor]:
    """The tensors of an output: a tensor, a sequence or a dict of them, or
    of such."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    return [t for o in out for t in _tensors(o)]


def captured_ms(fn: Callable[[], object], iters: int) -> float:
    """Device ms per call of ``fn`` (no arguments; it reads what it closes
    over), captured as one CUDA graph whose back-to-back replays are timed
    with CUDA events: the stage's own time, whatever the host's rate."""
    from pillars_torch.cuda_graph import CapturedCall, replay_ms

    call = CapturedCall(lambda: _tensors(fn()), torch.device("cuda"))
    call()
    call()
    return replay_ms(call, iters)


def profile_stages(det, state, points, num_valid, rect, trv2c,
                   iters: int) -> Dict[str, float]:
    """ms per call of each stage of the dense-cell path, each captured
    alone on inputs made by the stage before it (device ms, replays timed
    with CUDA events), and of the whole path (``t_full_*``: the captured
    function, replay and the staging of its inputs and the copy of its
    outputs, at the host's call rate; ``t_full_eager``: the eager one)."""
    thr = det.config.eval_input.anchor_area_threshold
    net = det.dense_network
    net.load_state_dict(state)
    b = points.shape[0]
    nx, ny, nz = det.mcfg.voxel.grid_size
    n_cells = nx * ny * nz
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731

    def front(cv):
        offset = torch.arange(b, dtype=torch.int32,
                              device=points.device)[:, None] * n_cells
        feats, npts = net.pfn(flat(cv.points), flat(cv.cell),
                              flat(cv.cell + offset), flat(cv.kept),
                              flat(cv.count), flat(cv.mean), b * n_cells)
        return feats.reshape(b, nz, ny, nx, -1).sum(dim=1), npts

    fn = det.make_inference_fn()
    with torch.inference_mode():
        cv = net.cell_voxelize(points, num_valid)
        canvas, _ = front(cv)
        preds_full, amask = det._forward_dense(state, points, num_valid, thr)
        return {
            "t_voxelize": captured_ms(
                lambda: net.cell_voxelize(points, num_valid), iters),
            "t_pfn_canvas": captured_ms(lambda: front(cv), iters),
            "t_rpn": captured_ms(lambda: net.rpn(canvas), iters),
            "t_forward_dense": captured_ms(
                lambda: det._forward_dense(state, points, num_valid, thr),
                iters),
            "t_postprocess": captured_ms(
                lambda: det.postprocess(preds_full, amask, rect, trv2c),
                iters),
            **{f"t_full_{i}": cuda_ms(lambda: fn(state, points, num_valid,
                                                 rect, trv2c), iters)
               for i in range(3)},
            "t_full_eager": cuda_ms(lambda: fn.eager(
                state, points, num_valid, rect, trv2c), iters),
        }


def profile_fast_stages(det, state, points, num_valid, rect, trv2c,
                        iters: int) -> Dict[str, float]:
    """ms per call of each stage of the point-major fast path (voxelize,
    PFN + canvas, the three fused blocks, the RPN tail, postprocess), each
    captured alone on inputs made by the stage before it, and of the whole
    path (as :func:`profile_stages`)."""
    from pillars_torch.models.detector import _front_state, _sub_state
    from pillars_torch.ops.rpn_blocks import fused_rpn_blocks

    thr = det.config.eval_input.anchor_area_threshold
    tail_state = _sub_state(state, det.rpn_tail, "rpn.")

    def front(v):
        return torch.func.functional_call(det.network, _front_state(state),
                                          (v,), {"canvas_only": True})

    def tail(blocks):
        return torch.func.functional_call(det.rpn_tail, tail_state,
                                          tuple(blocks))

    fn = det.make_inference_fn()
    with torch.inference_mode():
        v = det.voxelize_batch(points, num_valid)
        canvas = front(v)
        blocks = fused_rpn_blocks(canvas, state, det.mcfg.rpn,
                                  det.folded_blocks)
        preds = tail(blocks)
        amask = det.anchors_mask_batch(v.coords, v.pillar_mask, thr)
        return {
            "t_voxelize": captured_ms(
                lambda: det.voxelize_batch(points, num_valid), iters),
            "t_anchors_mask": captured_ms(
                lambda: det.anchors_mask_batch(v.coords, v.pillar_mask, thr),
                iters),
            "t_pfn_canvas": captured_ms(lambda: front(v), iters),
            "t_rpn_blocks": captured_ms(
                lambda: fused_rpn_blocks(canvas, state, det.mcfg.rpn,
                                         det.folded_blocks), iters),
            "t_rpn_tail": captured_ms(lambda: tail(blocks), iters),
            "t_forward_fast": captured_ms(
                lambda: det._forward_fast(state, v), iters),
            "t_postprocess": captured_ms(
                lambda: det.postprocess(preds, amask, rect, trv2c), iters),
            **{f"t_full_{i}": cuda_ms(lambda: fn(state, points, num_valid,
                                                 rect, trv2c), iters)
               for i in range(3)},
            "t_full_eager": cuda_ms(lambda: fn.eager(
                state, points, num_valid, rect, trv2c), iters),
        }


def device_busy(fn: Callable[[], object], iters: int,
                must_have: str = "", group=None):
    """(host wall ms per call, device ms per call summed over kernels,
    kernels by device time [(name, calls per call, device ms per call)],
    CUDA graph launches per call) from torch.profiler over ``iters`` warm
    calls. The kernels of a replayed graph count one by one, as the eager
    path's do. A trace now and then
    comes back without kernels and is taken again; raises when three in a
    row hold no CUDA kernel, or none whose name contains ``must_have``, so
    that a time that was not measured is never reported as 0. ``group``: a
    process group whose ranks all profile calls of ``fn`` that hold
    collectives; they take a trace again only together, so every rank
    makes the same calls."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        # a record_function range also shows on the device, spanning the
        # kernels it launched and the gaps between them: not a kernel
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        found = any(must_have in e.key and e.self_device_time_total > 0
                    for e in kernels)
        if group is not None:
            flag = torch.tensor([int(found)], device="cuda")
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
            found = bool(flag.item())
        if found:
            break
    else:
        raise RuntimeError(
            f"torch.profiler traced no CUDA kernel"
            f"{' named *' + must_have + '*' if must_have else ''} in three "
            f"passes of {iters} calls ({len(kernels)} kernels in the last)")
    device = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    rows = [(e.key, e.count / iters, e.self_device_time_total / 1e3 / iters)
            for e in kernels]
    graphs = sum(e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.key.startswith("cudaGraphLaunch")) / iters
    return wall, device, rows, graphs


def stage_sum(det, state, points, num_valid, rect, trv2c, iters: int
              ) -> Dict[str, object]:
    """``PillarsDetector.profile_stages`` against the whole: each stage's
    device ms (its own graph), their sum, the three stages in one graph
    (``whole``), and a boundary's cost (``boundary``: the replay of a graph
    of one small kernel, the launch each extra graph adds). On the card the
    sum should lie within ``whole`` plus the two extra boundaries, to the
    run's noise."""
    from pillars_torch.cuda_graph import CapturedCall, replay_ms

    calls = det.profiled_stages(state, points, num_valid, rect, trv2c)
    stages = {k: replay_ms(c, iters) for k, c in calls.items()
              if k != "t_whole"}
    one = torch.zeros((), device=det.device)
    tiny = CapturedCall(lambda: [one + 1], det.device)
    tiny()
    tiny()
    return {"stages": stages, "sum": sum(stages.values()),
            "whole": replay_ms(calls["t_whole"], iters),
            "boundary": replay_ms(tiny, iters)}


def range_breakdown(prof, names: Sequence[str], iters: int
                    ) -> Dict[str, Tuple[float, float]]:
    """{range name: (device events per call, device ms per call)} from a
    torch.profiler run over ``iters`` calls whose host code opened the
    ``record_function`` ranges ``names``, and ``"other"`` for the rest.
    Each device event (kernel, copy, set) is attributed to the range whose
    host interval holds the call that launched it, on any thread (a
    backward's launches come from autograd's thread inside the range that
    called it). Raises when no device event is found."""
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                   if e.device_type() == cpu and e.name() in names)
    # the launching call of each device event: the runtime API call with its
    # correlation id, else the operator it is linked to
    runtime, ops = {}, {}
    for e in events:
        if e.device_type() != cpu:
            continue
        table = runtime if e.name().startswith("cu") else ops
        table[e.correlation_id()] = e.start_ns()
    out = {n: [0, 0.0] for n in (*names, "other")}
    found = 0
    for e in events:
        if e.device_type() != cuda or e.name() in names:
            continue  # the device-side copies of the ranges themselves
        found += 1
        t = runtime.get(e.correlation_id(), ops.get(e.linked_correlation_id()))
        name = "other"
        if t is not None:
            for start, end, n in spans:
                if start <= t <= end:
                    name = n
        out[name][0] += 1
        out[name][1] += e.duration_ns() / 1e6
    if not found:
        raise RuntimeError("torch.profiler traced no device event")
    return {k: (c / iters, ms / iters) for k, (c, ms) in out.items()}


def train_stage_breakdown(step, state, batch, iters: int
                          ) -> Dict[str, Tuple[float, float]]:
    """Device events and device ms per step of each stage of the EAGER
    train step ``step`` (train/loop.py ``TRAIN_STAGES``: voxelize, anchors
    mask, assign_targets, forward, loss, backward, adamw; "other" for the
    rest), over ``iters`` warm steps threaded from ``state`` under
    torch.profiler (:func:`range_breakdown`), tracing on so that the
    body's spans open their ranges."""
    from torch.profiler import ProfilerActivity, profile

    from pillars_torch.train.loop import TRAIN_STAGES
    from pillars_torch.utils import tracing

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with tracing.tracing_on(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    return range_breakdown(prof, TRAIN_STAGES, iters)


def main():
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    root = pathlib.Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default=str(
        root / "benchmarks" / "hard_synth" / "weights_59.pkl"))
    ap.add_argument("--path", choices=("dense", "fast"), default="dense",
                    help="dense-cell path, or point-major with fused blocks")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()

    cfg = Config.default()
    if args.path == "fast":
        cfg = (cfg.override("model.pfn.dense_cell", False)
               .override("model.rpn.use_pallas_blocks", True))
    det = PillarsDetector(cfg)
    state = det.state_to_device(
        from_jax_variables(*load_params(args.weights), cfg))
    rng = np.random.RandomState(0)
    n, maxpts = 19200, cfg.model.voxel.max_points
    pts = np.zeros((1, maxpts, 3), np.float32)
    pts[0, :n] = np.stack([rng.uniform(0.0, 6.4, n),
                           rng.uniform(-2.56, 2.56, n),
                           rng.uniform(-3.0, 3.0, n)], 1)
    points = torch.from_numpy(pts).cuda()
    num = torch.tensor([n], dtype=torch.int32, device="cuda")
    eye = torch.eye(4, device="cuda")[None]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    stages = (profile_fast_stages if args.path == "fast" else profile_stages)(
        det, state, points, num, eye, eye, args.iters)
    fn = det.make_inference_fn()
    wall, device, rows, graphs = device_busy(
        lambda: fn(state, points, num, eye, eye), args.iters,
        "nms_keep_mask_kernel")
    # idle share against the event time of the whole path without the
    # profiler, whose own overhead slows the host
    full = sorted(v for k, v in stages.items() if k.startswith("t_full"))
    idle = 1.0 - device / full[len(full) // 2]
    result = {"card": card, "path": args.path, "batch": 1,
              "iters": args.iters,
              "stages_ms": stages, "profiled_wall_ms": wall,
              "device_ms": device, "idle_share": idle,
              "graph_launches": graphs,
              "kernels": [{"name": k, "per_cloud": c, "ms": t}
                          for k, c, t in rows]}
    print(card)
    for k, v in stages.items():
        print(f"{k:>16}: {v:.4f} ms")
    print(f"whole path: device {device:.4f} ms/cloud summed over kernels, "
          f"idle share {idle:.3f} of the median t_full; host wall "
          f"{wall:.4f} ms/cloud under the profiler")
    print(f"{graphs:g} graph launches and {sum(c for _, c, _ in rows):g} "
          f"kernel launches per cloud; the 12 longest, and the port's own:")
    for i, (k, c, t) in enumerate(rows):
        if i < 12 or "nms_keep_mask" in k or "rpn_sep_" in k:
            print(f"  {t * 1e3:9.2f} us  x{c:g}  {k[:90]}")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
