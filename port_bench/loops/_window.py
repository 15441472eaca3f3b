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

The program's span totals and counters (``pillars_torch.utils.tracing``)
are read at each part's edges; the record holds what each part added
(``parts``). Where the harness turned the program's tracing on
(``harness.takes_marks``; the graph is then captured at set-up with its
device marks), a third part of the same length follows the traced part,
the marked part: tracing on, the profiler off. Only there are spans
recorded and the marks read: the spans would slow the host in the first two
parts, and under the profiler the marks read the profiler's own delay at
each replay's start. The marks' event nodes replay in every part.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from port_bench.graph_clock import GraphClock
from port_bench.trace import Trace


def edge() -> Dict:
    """The program's span totals and counters as they stand."""
    from pillars_torch.utils import tracing

    return {"spans": tracing.snapshot(), "counters": tracing.counters()}


def _tracing(on: bool) -> None:
    from pillars_torch.utils import tracing

    (tracing.enable if on else tracing.disable)()


def added(a: Dict, b: Dict) -> Dict:
    """What a part between the edges ``a`` and ``b`` added: per span name
    its ``count`` and ``ns``, and each counter that moved."""
    spans = {}
    for name, row in b["spans"].items():
        before = a["spans"].get(name, {"count": 0, "ns": 0})
        n = row["count"] - before["count"]
        if n > 0:
            spans[name] = {"count": n, "ns": row["ns"] - before["ns"]}
    counters = {k: v - a["counters"].get(k, 0)
                for k, v in b["counters"].items()
                if v != a["counters"].get(k, 0)}
    return {"spans": spans, "counters": counters}


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
        self.edges = [edge(), None]

    def take(self, idx: int, t: float, t_sent: Optional[float]) -> None:
        if t_sent is None or t_sent >= self.t_start:
            if t_sent is not None:
                self.latencies.append((t - t_sent) * 1e3)
            self.frames.append(idx)
            self.times.append(t)

    def end(self) -> None:
        self.edges[1] = edge()

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
        self.marks = bool(cell.marks)
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
        self.marked: Optional[Part] = None
        self.setup_s = None
        if self.warm_left <= 0:
            self.open()

    def open(self) -> None:
        t = time.perf_counter()
        self.setup_s = t - self.t_process
        if self.marks:
            _tracing(False)
        self.timed = Part(t, self.seconds)
        self.phase = "timed"
        self.clock.start()

    def _start_trace(self) -> None:
        self.timed.end()
        self.clock.stop()
        self.phase = "traced"
        self.profiled = Part(self.trace.start(), self.seconds)

    def _start_marks(self) -> None:
        self.trace.stop()
        self.profiled.end()
        self.phase = "marked"
        _tracing(True)
        self.marked = Part(time.perf_counter(), self.seconds)

    def close(self) -> None:
        if self.phase == "marked":
            self.marked.end()
            _tracing(False)
        elif self.phase == "traced":
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
        elif self.phase in ("timed", "traced", "marked"):
            part = self._part()
            if t <= part.t_end:
                part.take(idx, t, t_sent)
            elif self.phase == "timed" and self.traced:
                self._start_trace()
            elif self.phase == "traced" and self.marks:
                self._start_marks()
            else:
                self.close()
        return self.phase != "closed"

    def dispatched(self, indices: tuple) -> None:
        """A dispatch of the clouds ``indices`` (for the traffic whose
        loop sees its dispatches)."""
        part = self._part()
        if part is not None:
            part.fresh += len(indices)
            part.batches.append(indices)

    def _part(self) -> Optional[Part]:
        return {"timed": self.timed, "traced": self.profiled,
                "marked": self.marked}.get(self.phase)

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
        parts = {"timed": dict(added(*timed.edges), clouds=len(timed.frames))}
        # one NMS launch a dispatch
        dispatches = parts["timed"]["counters"].get("nms_keep_mask.launches",
                                                    0)
        out = dict(setup_s=self.setup_s,
                   window_s=timed.t_end - timed.t_start,
                   latencies_ms=timed.latencies, clouds=len(timed.frames),
                   frames=timed.frames, batches=timed.dispatch_batches(),
                   fresh=timed.fresh, dispatches=dispatches,
                   trace=self.trace.summary, per_second=self.per_second(),
                   replay_ms=self.clock.ms_per_replay(),
                   replays=self.clock.replays,
                   traced_clouds=0, traced_batches=[], traced_per_s=None,
                   parts=parts)
        if prof is not None:
            out.update(traced_clouds=len(prof.frames) + int(in_flight),
                       traced_batches=prof.dispatch_batches(),
                       traced_per_s=len(prof.frames) / (prof.t_end
                                                        - prof.t_start))
            parts["traced"] = dict(added(*prof.edges),
                                   clouds=len(prof.frames))
        if self.marked is not None:
            parts["marked"] = dict(added(*self.marked.edges),
                                   clouds=len(self.marked.frames))
        out.update(extra)
        return out
