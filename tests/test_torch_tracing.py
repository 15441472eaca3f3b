"""The port's spans and counters (pillars_torch/utils/tracing.py): the
switch, the serving loops' spans and counters on the CPU, the profiler's
ranges, the Chrome trace, Python's collector, the device marks' reading
rule, the span readings of ``tools/trace_cell.py``; and on the card
(``cuda``), a graph captured with its device marks against one captured
without them.

On a machine with a card and no JAX run ``python -m pytest --noconftest
tests/test_torch_tracing.py`` (this file imports no JAX).
"""

import gc
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.data.stream import (LatestFrameMailbox, run_multi_stream,
                                       run_stream, synthetic_bank)
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.utils import tracing
from pillars_torch.utils.profiling import StageTimer

ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")
MAXPTS = 4096
CFG = Config.default().override("model.voxel.max_points", MAXPTS)
SERVING = ("stream.take", "stream.dispatch", "stream.stage", "fetch.enqueue",
           "stream.submit", "fetch.wait", "stream.result_wait",
           "stream.handoff", "stream.consume")


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def state():
    from pillars_torch.weights import from_jax_variables, load_params

    return from_jax_variables(*load_params(WEIGHTS), CFG)


@pytest.fixture(scope="module")
def bank():
    return synthetic_bank(4, seed=3, max_points=MAXPTS)


def _publisher(bank, frames):
    """``source_fn(mailbox)``: publishes ``frames`` clouds of the bank, each
    once the one before was taken, then closes."""
    def source_fn(mailbox):
        def run():
            for i in range(frames):
                mailbox.publish(bank[i % len(bank)])
                t_end = time.perf_counter() + 5.0
                while mailbox._taken_seq < mailbox._seq and \
                        time.perf_counter() < t_end:
                    time.sleep(0.001)
            mailbox.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t
    return source_fn


def _traced(fn):
    """(result, span ring, counters added) of ``fn()`` with tracing on."""
    before = tracing.counters()
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    after = tracing.counters()
    added = {k: v - before.get(k, 0) for k, v in after.items()}
    return out, tracing.spans(), added


@pytest.fixture(scope="module")
def single(state, bank):
    tracing.reset()
    det = PillarsDetector(CFG, device="cpu")
    out = _traced(lambda: run_stream(CFG, det, state, window=2,
                                     source_fn=_publisher(bank, 6)))
    tracing.reset()
    return out


@pytest.fixture(scope="module")
def multi(state, bank):
    tracing.reset()
    det = PillarsDetector(CFG, device="cpu")

    def source_fn(mailbox, i):
        _publisher(bank[i:] + bank[:i], 4)(mailbox)

    out = _traced(lambda: run_multi_stream(CFG, det, state, num_streams=2,
                                           window=2, source_fn=source_fn))
    tracing.reset()
    return out


def _by_name(ring):
    out = {}
    for row in ring:
        out.setdefault(row[0], []).append(row)
    return out


def test_off_span_is_the_shared_noop_and_records_nothing(state, bank):
    assert not tracing.enabled()
    assert tracing.span("stream.take") is tracing.NOOP
    assert tracing.span("x", rid=3, args={"a": 1}) is tracing.NOOP
    with tracing.span("x"):
        tracing.interval("y", 0, 1)
    assert tracing.current_rid() is None
    det = PillarsDetector(CFG, device="cpu")
    res = run_stream(CFG, det, state, window=1, source_fn=_publisher(bank, 2))
    assert res["frames_processed"] == 2
    assert tracing.snapshot() == {} and tracing.spans() == []


@pytest.mark.parametrize("loop", ["single", "multi"])
def test_serving_spans_once_per_dispatch(loop, request):
    res, ring, added = request.getfixturevalue(loop)
    spans = _by_name(ring)
    n = added["stream.dispatches"]
    assert n >= 1
    for name in SERVING + ("stream.loop",):
        # the last turn's take finds the mailboxes closed
        want = n + 1 if name in ("stream.take", "stream.loop") else n
        assert len(spans.get(name, ())) == want, name
    # one dispatch's spans share its request id, on both threads
    for rid in range(n):
        names = {r[0] for r in ring if r[4] == rid}
        assert set(SERVING) <= names, (rid, names)
    assert all(r[2] >= r[1] for r in spans["stream.handoff"])
    # the dispatching thread's spans lie inside the loop's turns, but for
    # the consumes of the last dispatches in flight (window 2), which the
    # loop drains after its last turn
    main = spans["stream.dispatch"][0][3]
    turns = spans["stream.loop"]
    outside = {}
    for r in ring:
        if r[3] == main and r[0] not in ("stream.loop", "stream.handoff",
                                         "python.gc"):
            if not any(t[1] <= r[1] and r[2] <= t[2] for t in turns):
                outside[r[0]] = outside.get(r[0], 0) + 1
    assert outside == {"stream.result_wait": 1, "stream.consume": 1}
    # the children of a dispatch sum to no more than it
    for d in spans["stream.dispatch"]:
        kids = [r for r in ring if r[5] == "stream.dispatch" and r[4] == d[4]
                and r[3] == d[3]]
        # (a collection may fall anywhere)
        assert {r[0] for r in kids} - {"python.gc"} == {
            "stream.stage", "fetch.enqueue", "stream.submit"}
        assert sum(r[2] - r[1] for r in kids) <= d[2] - d[1]
    # fetch.wait runs on a worker thread, under its dispatch's request id
    assert all(r[3] != main for r in spans["fetch.wait"])


@pytest.mark.parametrize("loop", ["single", "multi"])
def test_counters_equal_what_the_loops_return(loop, request):
    res, ring, added = request.getfixturevalue(loop)
    assert added["stream.fresh_slots"] == res["frames_processed"]
    assert added["stream.frames_skipped"] == res["frames_skipped"]
    assert added["stream.dispatches"] == len(_by_name(ring)[
        "stream.dispatch"])
    if loop == "single":
        assert added["stream.dispatches"] == res["frames_processed"]
    else:
        assert res["frames_processed"] / 2 <= added["stream.dispatches"] \
            <= res["frames_processed"]
    # the CPU runs the eager function: no graph replays
    assert added.get("graph.replays", 0) == 0


def test_latency_runs_from_publication(state, bank):
    """A frame that waits in the mailbox counts the wait: the second frame
    is published 60 ms before the loop is free to take it."""
    det = PillarsDetector(CFG, device="cpu")
    box = {}

    def source_fn(mailbox):
        box["mb"] = mailbox
        mailbox.publish(bank[0])

    def on_detections(boxes, scores):
        mb = box["mb"]
        if mb._seq == 1:
            mb.publish(bank[1])
            time.sleep(0.06)
        else:
            mb.close()

    res = run_stream(CFG, det, state, window=1, source_fn=source_fn,
                     on_detections=on_detections)
    assert res["frames_processed"] == 2
    assert res["latency_p99_ms"] >= 60.0


def test_mailbox_stamps_each_publication():
    mb = LatestFrameMailbox()
    t0 = time.perf_counter()
    mb.publish("a")
    t1 = time.perf_counter()
    time.sleep(0.01)
    frame, skipped = mb.take(timeout=0)
    assert frame == "a" and skipped == 0
    assert t0 <= mb.published_at <= t1


def test_spans_are_profiler_ranges_while_it_records():
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("outer.window"):
            with tracing.span("stream.take", rid=0):
                with tracing.span("stream.stage"):
                    torch.zeros(4).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "stream.take" in events and "stream.stage" in events
    w = events["outer.window"]
    for name in ("stream.take", "stream.stage"):
        e = events[name]
        assert w.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= w.start_ns() + \
            w.duration_ns()
    # without the profiler, no range is opened
    with tracing.span("later") as s:
        assert s._range is None


def test_profiler_trace_holds_the_train_stages_spans(tmp_path):
    """``profiler_trace`` turns tracing on inside its block, so the train
    body's stage spans (``TRAIN_STAGES``) are ranges of its trace, as their
    ``record_function`` ranges were; tracing is off again after it."""
    from pillars_torch.train.loop import TRAIN_STAGES
    from pillars_torch.utils.profiling import profiler_trace

    with profiler_trace(str(tmp_path / "trace")):
        for name in TRAIN_STAGES:
            with tracing.span(name):
                torch.ones(8) * 2
    assert not tracing.enabled()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert set(TRAIN_STAGES) <= names


def test_dump_writes_chrome_trace_json(tmp_path):
    tracing.enable()
    with tracing.span("graph.call", rid=7, args={"b": 1}):
        with tracing.span("graph.replay"):
            pass
    tracing.interval("stream.handoff", 100, 250, rid=7)
    tracing.count("stream.dispatches")
    path = tmp_path / "t.json"
    assert tracing.dump(str(path)) == 3
    doc = json.loads(path.read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert set(ev) == {"graph.call", "graph.replay", "stream.handoff"}
    for e in ev.values():
        assert e["ph"] == "X" and e["dur"] >= 0
        assert isinstance(e["ts"], float) and isinstance(e["tid"], int)
        assert e["args"]["rid"] == 7
    assert ev["graph.replay"]["args"]["parent"] == "graph.call"
    assert ev["graph.call"]["args"]["b"] == 1
    assert ev["stream.handoff"]["dur"] == pytest.approx(0.15)
    assert doc["otherData"]["counters"]["stream.dispatches"] >= 1
    assert "nms_keep_mask.launches" in doc["otherData"]["counters"]


def test_python_gc_is_a_span_while_tracing_is_on():
    gc.collect()
    assert "python.gc" not in tracing.snapshot()
    tracing.enable()
    with tracing.span("outer", rid=5):
        gc.collect()
    rows = [r for r in tracing.spans() if r[0] == "python.gc"]
    assert rows and rows[-1][6] == {"generation": 2}
    assert rows[-1][5] == "outer" and rows[-1][4] == 5
    tracing.disable()
    n = tracing.snapshot()["python.gc"]["count"]
    gc.collect()
    assert tracing.snapshot()["python.gc"]["count"] == n


def test_totals_snapshot_and_reset():
    tracing.enable()
    tracing.interval("a", 0, 10)
    tracing.interval("a", 0, 30)
    assert tracing.snapshot()["a"] == {"count": 2, "ns": 40, "max_ns": 30}
    tracing.reset()
    assert tracing.snapshot() == {} and tracing.spans() == []


def test_stage_timer_stages_are_spans():
    tracing.enable()
    timer = StageTimer(window=2)
    off = StageTimer(enabled=False)
    with timer.stage("t_voxel_features"):
        pass
    with off.stage("t_nms_func"):
        pass
    snap = tracing.snapshot()
    assert snap["t_voxel_features"]["count"] == 1
    assert snap["t_nms_func"]["count"] == 1
    assert list(timer.averages()) == ["t_voxel_features"]
    assert off.averages() == {}


def test_marks_only_inside_a_traced_capture():
    tracing.mark("start")  # nothing to collect: no event made
    with tracing.capturing_marks() as marks:
        tracing.mark("start")
    assert list(marks) == []
    tracing.enable()
    with tracing.capturing_marks() as marks:
        pass
    assert marks == [] and tracing._marks is None


class _FakeEvent:
    def __init__(self, t):
        self.t = t
        self.done = True
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_marks_read_a_finished_replay_and_skip_a_running_one():
    tracing.enable()
    events = [_FakeEvent(t) for t in (0.0, 0.1, 0.4, 1.0, 1.2)]
    dm = tracing.DeviceMarks(list(zip(
        ("start", "voxelize", "pfn", "rpn", "post"), events)), clouds=2)
    before = tracing.counters()
    dm.before_replay()          # nothing launched yet
    dm.after_replay()           # replay 1
    events[-1].done = False
    dm.before_replay()          # replay 1 still running: skipped, no wait
    assert events[-1].waited == 0
    dm.after_replay()           # replay 2
    events[-1].done = True
    dm.before_replay()          # replay 2 done: read
    snap = tracing.snapshot()
    assert snap["device.voxelize"]["ns"] == pytest.approx(1e5, abs=1)
    assert snap["device.pfn"]["ns"] == pytest.approx(3e5, abs=1)
    assert snap["device.rpn"]["ns"] == pytest.approx(6e5, abs=1)
    assert snap["device.post"]["ns"] == pytest.approx(2e5, abs=1)
    assert snap["device.replay"]["ns"] == pytest.approx(1.2e6, abs=1)
    after = tracing.counters()
    added = {k: v - before.get(k, 0) for k, v in after.items()}
    assert added["device.sampled_replays"] == 1
    assert added["device.sampled_clouds"] == 2
    assert added["device.skipped_replays"] == 1
    # every SAMPLE_EVERY-th replay waits for the one before it
    for _ in range(tracing.SAMPLE_EVERY - 2):
        dm.after_replay()
        dm.before_replay()
    assert dm.replays == tracing.SAMPLE_EVERY
    dm.after_replay()
    events[-1].done = False
    dm.before_replay()
    assert events[-1].waited == 1


def _trace_cell():
    spec = importlib.util.spec_from_file_location(
        "trace_cell", ROOT / "tools" / "trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_cell_readings_on_spans_and_without_them():
    tc = _trace_cell()
    zero = {"spans": {}, "counters": {}}

    def part(a, b, clouds):  # as the benchmark's window records a part
        return dict(tc.added(a, b), clouds=clouds)

    # a program without tracing: nothing to read
    empty = part(zero, zero, 10)
    assert all(v is None for v in tc.readings(empty, empty).values())

    def edge(mult):
        s = {f"device.{st}": {"count": 4 * mult, "ns": 8 * ns * mult,
                              "max_ns": ns}
             for st, ns in zip(tc.STAGES, (1e5, 2e5, 6e5, 3e5))}
        s.update({
            "graph.call": {"count": 10 * mult, "ns": 10 * 5e4 * mult},
            "fetch.enqueue": {"count": 10 * mult, "ns": 10 * 2e4 * mult},
            "stream.take": {"count": 10 * mult, "ns": 10 * 1e4 * mult},
            "stream.stage": {"count": 10 * mult, "ns": 10 * 3e4 * mult},
            "graph.capture": {"count": 1, "ns": 2e9},
            "build.extensions": {"count": 2, "ns": 5e8}})
        return {"spans": s, "counters": {"device.sampled_clouds": 8 * mult}}

    setup = part(zero, edge(1), 1)
    timed = part(edge(1), edge(2), 10)
    assert "graph.capture" not in timed["spans"]
    r = tc.readings(timed, setup)
    assert r["voxelize_ms_per_cloud"] == pytest.approx(0.1)
    assert r["pfn_ms_per_cloud"] == pytest.approx(0.2)
    assert r["rpn_ms_per_cloud"] == pytest.approx(0.6)
    assert r["post_ms_per_cloud"] == pytest.approx(0.3)
    assert r["stages_ms_per_cloud"] == pytest.approx(1.2)
    assert r["dispatch_ms_per_cloud"] == pytest.approx(0.07)
    assert r["stage_ms_per_cloud"] == pytest.approx(0.04)
    assert r["capture_s"] == pytest.approx(2.0)
    assert r["build_s"] == pytest.approx(0.5)


def test_stream_cli_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "stream.trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pillars_torch.cli", "stream", "--device",
         "cpu", "--duration", "0.6", "--hz", "20", "--window", "2",
         "--set", f"model.voxel.max_points={MAXPTS}", "--trace", str(path)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    n = stats["counters"]["stream.dispatches"]
    assert n == stats["frames_processed"] >= 1
    assert stats["spans"]["stream.dispatch"]["count"] == n
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert set(SERVING) <= names


# ------------------------------------------------------------------ card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


PATHS = {
    "dense": {},
    "point_major": {"model.pfn.dense_cell": False},
    "fast": {"model.pfn.dense_cell": False,
             "model.rpn.use_pallas_blocks": True},
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_marked_graph_equals_unmarked_and_its_stages_sum_to_the_replay(
        card, path):
    """Outputs bit-equal to a graph captured with tracing off; the four
    stages of each sampled replay sum to within 3% of the replay's span by
    events recorded around ``CUDAGraph.replay``; the children of
    ``graph.call`` sum to no more than it."""
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = Config.default()
    for k, v in PATHS[path].items():
        cfg = cfg.override(k, v)
    state = from_jax_variables(*load_params(WEIGHTS), cfg)
    clouds = synthetic_bank(6, seed=11)
    maxpts = cfg.model.voxel.max_points
    eye = np.eye(4, dtype=np.float32)[None]

    def inputs(c):
        pts = np.zeros((1, maxpts, 3), np.float32)
        pts[0, :len(c)] = c
        return pts, np.asarray([len(c)], np.int32)

    det_off = PillarsDetector(cfg, device="cuda")
    s_off = det_off.state_to_device(state)
    fn_off = det_off.make_inference_fn()
    fn_off(s_off, *inputs(clouds[0]), eye, eye)
    tracing.enable()
    det_on = PillarsDetector(cfg, device="cuda")
    s_on = det_on.state_to_device(state)
    fn_on = det_on.make_inference_fn()
    fn_on(s_on, *inputs(clouds[0]), eye, eye)   # captures with marks
    (g_on,), (g_off,) = fn_on.graphs.values(), fn_off.graphs.values()
    assert g_off.marks is None
    assert g_on.marks.names == ["start", "voxelize", "pfn", "rpn", "post"]

    spans_ms = []
    cls = torch.cuda.CUDAGraph
    orig = cls.replay

    def timed_replay(graph):
        # the card busy first (about 2 ms, longer than the host takes to
        # launch), so that the launch has arrived when the first event
        # runs: the events then span the replay alone
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        orig(graph)
        b.record()
        spans_ms.append((a, b))

    tracing.reset()
    cls.replay = timed_replay
    try:
        for i in range(30):
            c = inputs(clouds[i % len(clouds)])
            got = fn_on(s_on, *c, eye, eye)
            want = fn_off(s_off, *c, eye, eye)
            torch.cuda.synchronize()
            for name, g, w in zip(got._fields, got, want):
                assert torch.equal(g, w), (path, i, name)
        fn_on(s_on, *inputs(clouds[0]), eye, eye)  # reads the last one
    finally:
        cls.replay = orig
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    n = snap["device.replay"]["count"]
    assert n >= 25
    stages = sum(snap[f"device.{s}"]["ns"] for s in
                 ("voxelize", "pfn", "rpn", "post")) / 1e6 / n
    assert stages == pytest.approx(snap["device.replay"]["ns"] / 1e6 / n,
                                   rel=1e-3)
    outer = [a.elapsed_time(b) for a, b in spans_ms[::2]][:n]
    assert stages == pytest.approx(float(np.mean(outer)), rel=0.03), (
        stages, float(np.mean(outer)))
    ring = tracing.spans()
    for call in (r for r in ring if r[0] == "graph.call"):
        kids = [r for r in ring if r[5] == "graph.call" and r[3] == call[3]
                and call[1] <= r[1] and r[2] <= call[2]]
        assert {r[0] for r in kids} >= {"graph.state_load", "graph.replay",
                                        "graph.stage_inputs", "graph.outputs"}
        assert sum(r[2] - r[1] for r in kids) <= call[2] - call[1]
