"""The window every serving loop shares: a number of warm-up deliveries (set-up),
then ``seconds`` of measurement, opened and closed by the thread that
delivers.

A traced run (``--trace 1``) measures two parts of the traffic's
``trace_seconds`` each, one after the other: first a timed part with the
profiler off, then the traced part. The profiler slows the host's side of
every call, so what the host's clock reads (latencies, clouds per second)
comes from the timed part, and what only the trace holds (device time,
kernels, the NMS kernel's time) from the traced part. The card's time of
each replay of the captured graph (``port_bench/graph_clock.py``) is read
in the timed part.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from port_bench.graph_clock import GraphClock
from port_bench.trace import Trace


def nms_launches() -> int:
    from pillars_torch.ops import nms_cuda

    return int(nms_cuda.nms_keep_mask.launches)


class Part:
    """The deliveries and dispatches of one stretch of the window."""

    def __init__(self, t_start: float, seconds: float):
        self.t_start = t_start
        self.t_end = t_start + seconds
        self.latencies: List[float] = []
        self.frames: List[int] = []    # bank index of each delivery
        self.times: List[float] = []   # arrival of each delivery
        self.batches: List[tuple] = []  # bank indices of each dispatch
        self.fresh = 0                 # clouds dispatched
        self.nms = [nms_launches(), None]

    def take(self, idx: int, t: float, t_sent: Optional[float]) -> None:
        if t_sent is None or t_sent >= self.t_start:
            if t_sent is not None:
                self.latencies.append((t - t_sent) * 1e3)
            self.frames.append(idx)
            self.times.append(t)

    def end(self) -> None:
        self.nms[1] = nms_launches()

    def dispatch_batches(self) -> List[tuple]:
        """The dispatches, or one per delivery where the loop reports
        none (batch 1)."""
        return self.batches or [(i,) for i in self.frames]


class Window:
    """``delivered(...)`` for each delivery, in delivery order; False once
    the window has closed."""

    def __init__(self, cell, warmup: int):
        self.t_process = cell.t_process
        self.traced = bool(cell.trace)
        self.seconds = cell.seconds
        if self.traced:
            self.seconds = min(self.seconds,
                               float(cell.traffic["trace_seconds"]))
        self.trace = Trace(self.traced)
        self.clock = GraphClock()
        self.warm_left = int(warmup)
        self.phase = "warm"
        self.timed: Optional[Part] = None
        self.profiled: Optional[Part] = None
        self.setup_s = None
        if self.warm_left <= 0:
            self.open()

    def open(self) -> None:
        t = time.perf_counter()
        self.setup_s = t - self.t_process
        self.timed = Part(t, self.seconds)
        self.phase = "timed"
        self.clock.start()

    def _start_trace(self) -> None:
        self.timed.end()
        self.clock.stop()
        self.phase = "traced"
        self.profiled = Part(self.trace.start(), self.seconds)

    def close(self) -> None:
        if self.phase == "traced":
            self.trace.stop()
            self.profiled.end()
        else:
            self.timed.end()
            self.clock.stop()
        self.phase = "closed"

    def delivered(self, idx: int, t_sent: Optional[float]) -> bool:
        t = time.perf_counter()
        if self.phase == "warm":
            self.warm_left -= 1
            if self.warm_left <= 0:
                self.open()
        elif self.phase in ("timed", "traced"):
            part = self.timed if self.phase == "timed" else self.profiled
            if t <= part.t_end:
                part.take(idx, t, t_sent)
            elif self.phase == "timed" and self.traced:
                self._start_trace()
            else:
                self.close()
        return self.phase != "closed"

    def dispatched(self, indices: tuple) -> None:
        """A dispatch of the clouds ``indices`` (for the traffic whose
        loop sees its dispatches)."""
        part = {"timed": self.timed, "traced": self.profiled}.get(self.phase)
        if part is not None:
            part.fresh += len(indices)
            part.batches.append(indices)

    def per_second(self) -> List[int]:
        """Clouds delivered in each second of the timed part."""
        counts = [0] * max(1, int(round(self.seconds)))
        for t in self.timed.times:
            counts[min(int(t - self.timed.t_start), len(counts) - 1)] += 1
        return counts

    def record(self, in_flight: int = 0, **extra) -> Dict:
        """What the metrics read. ``in_flight``: clouds whose device work
        lies inside the traced part beyond those delivered in it (a closed
        loop's next cloud is dispatched before the trace stops)."""
        if self.phase != "closed":
            raise RuntimeError("the run ended before its window closed")
        timed, prof = self.timed, self.profiled
        out = dict(setup_s=self.setup_s,
                   window_s=timed.t_end - timed.t_start,
                   latencies_ms=timed.latencies, clouds=len(timed.frames),
                   frames=timed.frames, batches=timed.dispatch_batches(),
                   fresh=timed.fresh, dispatches=timed.nms[1] - timed.nms[0],
                   trace=self.trace.summary, per_second=self.per_second(),
                   replay_ms=self.clock.ms_per_replay(),
                   replays=self.clock.replays,
                   traced_clouds=0, traced_batches=[], traced_per_s=None)
        if prof is not None:
            out.update(traced_clouds=len(prof.frames) + int(in_flight),
                       traced_batches=prof.dispatch_batches(),
                       traced_per_s=len(prof.frames) / (prof.t_end
                                                        - prof.t_start))
        out.update(extra)
        return out
