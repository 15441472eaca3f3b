"""The traced window: torch.profiler over the measured window only, reduced
to what the per-layer metrics read.

The profiler is started and stopped by the thread that serves (the serving
loops call the benchmark's callbacks there), and a ``record_function``
range named :data:`WINDOW` marks the window on the profiler's clock. From
the trace:

- ``busy_s``: the union of the device's operations (kernels, copies, sets)
  inside the window;
- ``device_s`` and ``kernels``: the summed time and the count of those
  operations (copies and sets are not kernels);
- per name: time and count (``nms`` and ``nccl`` among them);
- the idle gaps between device operations, each labelled by the
  innermost host operation that was running at its middle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

WINDOW = "port_bench.window"


class Trace:
    """Profiles one window when ``enabled``; otherwise only times it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._range = None
        self.summary: Optional[Dict] = None

    def start(self) -> float:
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self._range = torch.autograd.profiler.record_function(WINDOW)
            self._range.__enter__()
        return time.perf_counter()

    def stop(self) -> float:
        t = time.perf_counter()
        if self.enabled and self.prof is not None:
            import torch

            self._range.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()
            self.summary = summarize(_events(self.prof))
            self.prof = None
        return t


def _events(prof) -> List:
    """(name, is_device, start_ns, end_ns, thread) of every event."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == cuda:
            continue
        start = e.start_ns()
        out.append((e.name(), e.device_type() == cuda, start,
                    start + e.duration_ns(), e.start_thread_id()))
    return out


def _copy_or_set(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def summarize(events: List, top: int = 10) -> Dict:
    """The window's numbers from ``events`` (see :func:`_events`)."""
    window = [e for e in events if e[0] == WINDOW and not e[1]]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window[0][2], window[0][3]
    dev = []
    for name, is_dev, s, e, _ in events:
        if is_dev and e > w0 and s < w1:
            dev.append((name, max(s, w0), min(e, w1)))
    dev.sort(key=lambda x: x[1])
    busy, gaps = 0, []
    cur_s = cur_e = None
    for _, s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    by_name: Dict[str, List] = {}
    for name, s, e in dev:
        row = by_name.setdefault(name, [0, 0])
        row[0] += e - s
        row[1] += 1
    host = sorted((e for e in events if not e[1] and e[0] != WINDOW),
                  key=lambda x: x[2])
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [[_label(host, (a + b) // 2), (b - a) / 1e9] for a, b in gaps[:top]]
    ops = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)

    def total(pred):
        rows = [v for k, v in by_name.items() if pred(k)]
        return sum(r[0] for r in rows) / 1e9, sum(r[1] for r in rows)

    nms_s, nms_n = total(lambda k: "nms_keep_mask" in k)
    nccl_s, nccl_n = total(lambda k: "nccl" in k.lower())
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "device_s": sum(v[0] for v in by_name.values()) / 1e9,
        "kernels": sum(v[1] for k, v in by_name.items()
                       if not _copy_or_set(k)),
        "nms_s": nms_s, "nms_launches": nms_n,
        "nccl_s": nccl_s, "nccl_kernels": nccl_n,
        "device_ops": [[k[:200], v[0] / 1e9] for k, v in ops[:top]],
        "idle_gaps": idle,
    }


def _label(host: List, t: int) -> str:
    """The innermost host operation running at ``t`` (its thread)."""
    best = None
    for name, _, s, e, tid in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name, tid)
    if best is None:
        return "host: no traced operation"
    return f"{best[2][:160]} (thread {best[3]})"
