"""Timing: the host-side stage timer with the reference's stage names, a
Chrome trace of a block (``profiler_trace``), and on the card the one
back-to-back CUDA-event loop (``back_to_back``) and the timers built on it,
the train step's launches and device ms by stage
(``train_stage_breakdown``) and a torch.profiler pass for the device's busy
share (``device_busy``).

The device time of each stage of a served cloud, on any path, comes from
the graph's device marks (utils/tracing.py: ``pillars-torch stream --trace
FILE``); the JAX package's three stages, each captured alone, from
``PillarsDetector.profile_stages``.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def back_to_back(fn: Callable[[int], object], iters: int,
                 device: torch.device) -> Tuple[Optional[float], float]:
    """``fn(i)`` for ``i`` in ``range(iters)``, back to back, on ``device``:
    (ms per call between two CUDA events around the calls, None off the
    card; host ms per call from the first call until the card has run the
    last). When the host issues work slower than the card runs it, the
    event time is the issue rate."""
    on_card = device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    if on_card:
        start.record()
    for i in range(iters):
        fn(i)
    if on_card:
        end.record()
        torch.cuda.synchronize(device)
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    return (start.elapsed_time(end) / iters if on_card else None), host_ms


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Warm mean ms per call of ``fn`` on the card, called once and then
    ``iters`` times back to back (:func:`back_to_back`)."""
    fn()
    torch.cuda.synchronize()
    return back_to_back(lambda _: fn(), iters, torch.device("cuda"))[0]


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
