"""Spans and counters of the port: where the host's time of each dispatch
goes, the card's time of each inference stage inside a captured graph, and
counts of what the serving loops and the graphs did.

- **Switch.** :func:`enable` / :func:`disable` / :func:`enabled`, process
  wide, off by default. Off, :func:`span` returns one shared no-op context
  (no clock read, no allocation, no lock), and the graphs are captured
  without device marks.
- **Spans.** ``with span(name, rid=None, args=None):`` records its name, its
  start and end (``time.perf_counter_ns``), its parent (the innermost open
  span of the same thread), its thread, and a request id: the dispatch's
  sequence number, given at the serving loop's spans and inherited by the
  spans opened inside them, so every span of one cloud or batch shares it.
  :func:`interval` records a span whose two ends were stamped on different
  threads (a hand-off). Spans add to per-name totals (:func:`snapshot`,
  :func:`reset`) and to a ring of the last :data:`RING` spans, which
  :func:`dump` writes as a Chrome trace (chrome://tracing, Perfetto).
  While torch.profiler records, each span also opens a ``record_function``
  range of its name, so that a trace names the host's stretches (and the
  device's idle gaps under them) after the program's spans.
- **Python's collector.** While tracing is on, every collection is a span,
  ``python.gc``, with its generation.
- **Device marks.** A graph captured while tracing is on (the inference
  graphs, ``cuda_graph.CapturedInference``) records a timing CUDA event as
  an external node at each stage boundary of the inference body
  (:func:`mark`: ``start``, then ``voxelize``, ``pfn``, ``rpn``, ``post``,
  each closing the stage of its name). Each replay re-records them, so a
  replay's marks are read (:class:`DeviceMarks`) by the dispatching thread
  just before it launches that graph's next replay, if the last mark has
  completed by then (a query, never a wait), into the totals
  ``device.<stage>`` and ``device.replay`` (their sum: first mark to
  last); a replay
  whose marks have not completed is skipped. Every :data:`SAMPLE_EVERY`-th
  replay of a graph waits for the one before it, so that a loop that keeps
  the card busy still gets a steady sample. The counters
  ``device.sampled_replays``, ``device.sampled_clouds`` (the batch size of
  each sampled replay) and ``device.skipped_replays`` say what the totals
  cover.
- **Counters.** :func:`count` adds to a named integer, always (one writing
  thread per counter); :func:`counters` returns them all. A kernel wrapper
  (``ops/*_cuda.py``) counts its launches as ``<wrapper>.launches`` and
  declares that counter at 0 when it is imported. A launch inside a captured
  graph runs at each replay, not in Python, so a capture collects what its
  body counted (:func:`capturing_counts`) and every replay adds it again.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

RING = 65536
SAMPLE_EVERY = 64

_on = False
_lock = threading.RLock()  # a collection may start while a span records
_local = threading.local()
_totals: Dict[str, List[int]] = {}   # name -> [count, total ns, max ns]
_ring: collections.deque = collections.deque(maxlen=RING)
_counts: Dict[str, int] = {}
_moved: Dict[int, Dict[str, int]] = {}  # by thread, what its capture counted
_marks: Optional[List[Tuple[str, torch.cuda.Event]]] = None


def enable() -> None:
    """Turns spans and device marks on, process-wide."""
    global _on
    if not _on:
        gc.callbacks.append(_on_gc)
        _on = True


def disable() -> None:
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def tracing_on():
    """Tracing on inside the block, as it was after."""
    was = _on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "rid", "args", "parent", "t0", "_range")

    def __init__(self, name: str, rid, args):
        self.name = name
        self.rid = rid
        self.args = args
        self._range = None

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer is not None else None
        if self.rid is None and outer is not None:
            self.rid = outer.rid
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _stack().pop()
        _record(self.name, self.t0, t1, self.rid, self.parent, self.args)
        return False


def span(name: str, rid: Optional[int] = None, args: Optional[Dict] = None):
    """A context that records one span of ``name`` while tracing is on
    (module docstring); ``rid`` None takes the enclosing span's."""
    if not _on:
        return NOOP
    return _Span(name, rid, args)


def current_rid() -> Optional[int]:
    """The request id of this thread's innermost open span (None when
    tracing is off or no span is open)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].rid if stack else None


def interval(name: str, t0_ns: int, t1_ns: int, rid: Optional[int] = None,
             args: Optional[Dict] = None) -> None:
    """Records a span of ``name`` from ``t0_ns`` to ``t1_ns``
    (``perf_counter_ns``, possibly stamped on two threads); its parent is
    this thread's innermost open span."""
    if not _on:
        return
    stack = _stack()
    outer = stack[-1] if stack else None
    if rid is None and outer is not None:
        rid = outer.rid
    _record(name, t0_ns, t1_ns, rid,
            outer.name if outer is not None else None, args)


def _record(name, t0, t1, rid, parent, args) -> None:
    with _lock:
        _add_total(name, t1 - t0)
        _ring.append((name, t0, t1, threading.get_ident(), rid, parent,
                      args))


def _add_total(name: str, ns: int) -> None:
    with _lock:
        row = _totals.get(name)
        if row is None:
            _totals[name] = [1, ns, ns]
        else:
            row[0] += 1
            row[1] += ns
            row[2] = max(row[2], ns)


def _on_gc(phase: str, info: Dict) -> None:
    """``gc.callbacks`` entry: a collection is the span ``python.gc``, and
    under torch.profiler a range of that name (so that a device gap under a
    collection is named after it)."""
    if phase == "start":
        _local.gc_range = None
        if torch.autograd._profiler_enabled():
            rng = torch.profiler.record_function("python.gc")
            rng.__enter__()
            _local.gc_range = rng
        _local.gc_t0 = time.perf_counter_ns()
        return
    t0 = getattr(_local, "gc_t0", None)
    if t0 is None:
        return
    t1 = time.perf_counter_ns()
    _local.gc_t0 = None
    rng = getattr(_local, "gc_range", None)
    if rng is not None:
        _local.gc_range = None
        rng.__exit__(None, None, None)
    interval("python.gc", t0, t1, args={"generation": info["generation"]})


def snapshot() -> Dict[str, Dict[str, int]]:
    """Per name: ``count``, ``ns`` (the sum) and ``max_ns`` of the spans
    recorded since the last :func:`reset`."""
    with _lock:
        return {k: {"count": v[0], "ns": v[1], "max_ns": v[2]}
                for k, v in _totals.items()}


def reset() -> None:
    """Clears the totals and the ring (not the counters)."""
    with _lock:
        _totals.clear()
        _ring.clear()


def spans() -> List[Tuple]:
    """The ring: (name, start ns, end ns, thread, request id, parent, args)
    of the last :data:`RING` spans, in the order they ended."""
    with _lock:
        return list(_ring)


def dump(path: str) -> int:
    """Writes the ring as Chrome-trace JSON (times in microseconds of
    ``perf_counter``; the counters under ``otherData``); returns the number
    of spans written."""
    rows = spans()
    pid = os.getpid()
    events = []
    for name, t0, t1, tid, rid, parent, args in rows:
        a = {"rid": rid, "parent": parent}
        if args:
            a.update(args)
        events.append({"name": name, "ph": "X", "ts": t0 / 1e3,
                       "dur": (t1 - t0) / 1e3, "pid": pid, "tid": tid,
                       "args": a})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": counters()}}, f)
    return len(events)


# ---------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` (always on; ``n`` = 0 declares
    it)."""
    _counts[name] = _counts.get(name, 0) + n
    if _moved:
        moved = _moved.get(threading.get_ident())
        if moved is not None:
            moved[name] = moved.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter."""
    return dict(_counts)


@contextlib.contextmanager
def capturing_counts():
    """Collects what :func:`count` adds on this thread inside the block (a
    graph's capture) and takes it off the counters again at its end, since a
    capture runs nothing; yields the ``{name: n}`` that each replay of the
    graph adds back. Counts of other threads stay as they are."""
    tid = threading.get_ident()
    moved: Dict[str, int] = {}
    _moved[tid] = moved
    try:
        yield moved
    finally:
        del _moved[tid]
        for name, n in moved.items():
            _counts[name] -= n


# ------------------------------------------------------------ device marks
def mark(name: str) -> None:
    """A stage boundary of the inference body: inside a capture that takes
    marks (:func:`capturing_marks`), a timing CUDA event recorded as an
    external node of the graph; nothing otherwise."""
    if _marks is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        _marks.append((name, ev))


@contextlib.contextmanager
def capturing_marks():
    """Collects the :func:`mark` calls of a capture while tracing is on;
    yields the list (empty when tracing is off)."""
    global _marks
    found: List[Tuple[str, torch.cuda.Event]] = []
    if not _on:
        yield found
        return
    _marks = found
    try:
        yield found
    finally:
        _marks = None


class DeviceMarks:
    """The marks of one graph (``names[i]`` closes at ``events[i]``; the
    first opens the replay), read between its replays (module
    docstring). ``clouds``: the graph's batch size."""

    def __init__(self, marks: Sequence[Tuple[str, torch.cuda.Event]],
                 clouds: int):
        self.names = [n for n, _ in marks]
        self.events = [e for _, e in marks]
        self.clouds = int(clouds)
        self.replays = 0
        self._pending = False

    def before_replay(self) -> None:
        if not self._pending:
            return
        self._pending = False
        if not _on:
            return
        last = self.events[-1]
        if self.replays % SAMPLE_EVERY == 0:
            last.synchronize()
        if not last.query():
            count("device.skipped_replays")
            return
        ev = self.events
        replay = 0
        for name, a, b in zip(self.names[1:], ev, ev[1:]):
            ns = int(a.elapsed_time(b) * 1e6)
            _add_total(f"device.{name}", ns)
            replay += ns
        _add_total("device.replay", replay)
        count("device.sampled_replays")
        count("device.sampled_clouds", self.clouds)

    def after_replay(self) -> None:
        self._pending = True
        self.replays += 1
