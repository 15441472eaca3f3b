"""Every traffic mix end to end at a tiny size through the program on the
CPU, judged against the reference; and runs with the timed path broken
underneath, which must come out not correct.

The harness's look for a card is skipped (``run_cell(device="cpu")``); the
rest of a run is what the card runs: set-up, the serving loop, the judgement,
the metrics.
"""

import numpy as np
import pytest
import torch

from port_bench import harness

# bank, warm-up and rate cut to what the CPU serves in a few seconds
TINY = {
    "d435i_sensor1": ({"bank": 6, "warmup": 3}, 1.5),
    "d435i_sensors8": ({"bank": 8, "warmup": 8, "hz_per_stream": 40.0}, 2.0),
    "kitti3_sensor1": ({"bank": 2, "warmup": 1}, 4.0),
}
SEED = 2**31 + 3


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(wl, trace=False):
    over, seconds = TINY[wl]
    return harness.run_cell(wl, SEED, seconds, trace, device="cpu",
                            traffic_overrides=over)


@pytest.mark.parametrize("wl", sorted(TINY))
def test_mix_runs_end_to_end_and_is_correct(wl):
    out = _run(wl)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["detail"]["distinct"] >= 1
    assert out["checks"]["detection_gap"]["value"] < 1e-5
    assert list(out)[-1] == "checks"
    wanted = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), wl, False)}
    # the graph's replay time is read by CUDA events: the card's only
    assert set(out["metrics"]) == wanted - {"replay_ms"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["detail"]["spans"] == {}  # tracing stays off
    assert isinstance(out["detail"]["counters"], dict)


def test_a_traced_run_times_and_traces_two_parts():
    """``--trace 1``: a timed part with the profiler off, then the traced
    part; the host's clock reads the first (the CPU has no device
    operations, so the trace's own metrics read nothing here). In a cell
    that reads the program's spans a marked part follows, the only one with
    tracing on."""
    from port_bench.loops import _window

    records = []
    record = _window.Window.record

    def keep(self, *a, **kw):
        records.append(record(self, *a, **kw))
        return records[-1]

    over, _ = TINY["d435i_sensor1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_window.Window, "record", keep)
        out = harness.run_cell("d435i_sensor1", SEED, 1.5, True,
                               device="cpu",
                               traffic_overrides=dict(over, trace_seconds=1.0))
    assert out["correct"], out["checks"]
    assert out["detail"]["window_clouds"] > 0
    assert out["detail"]["traced_per_s"] > 0
    assert out["device"]["window_s"] > 0.9
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the program's spans of the marked part, on for this run only
    spans, counters = out["detail"]["spans"], out["detail"]["counters"]
    assert spans["stream.dispatch"]["count"] == counters["stream.dispatches"]
    assert spans["stream.dispatch"]["ms_per_cloud"] > 0
    parts = records[-1]["parts"]
    assert list(parts) == ["timed", "traced", "marked"]
    assert parts["marked"]["clouds"] > 0
    # and off in the others: at most a span open at a toggle closes
    for name in ("timed", "traced"):
        assert parts[name]["counters"]["stream.dispatches"] > 2
        assert parts[name]["spans"].get(
            "stream.dispatch", {"count": 0})["count"] <= 1
    from pillars_torch.utils import tracing

    assert not tracing.enabled()


def test_tracing_follows_the_cells_metrics():
    """A ``--trace 1`` run turns the program's tracing on only in a cell
    that reports a metric read from the program's spans."""
    bench = harness.benchmark()
    for wl in bench["workloads"]:
        reads_spans = any(m["source"] == "program_span" for m in
                          harness.cell_metrics(bench, wl["name"], True))
        assert harness.takes_marks(bench, wl["name"], True) == reads_spans
        assert not harness.takes_marks(bench, wl["name"], False)
    assert harness.takes_marks(bench, "d435i_sensor1", True)
    assert not harness.takes_marks(bench, "d435i_sensors8", True)


def _shifted(postprocess):
    """An answer altered where it is produced: every box 0.3 m along x."""
    def wrapped(self, *args, **kwargs):
        out = postprocess(self, *args, **kwargs)
        boxes = out.boxes_lidar.clone()
        boxes[..., 0] += 0.3
        return out._replace(boxes_lidar=boxes)
    return wrapped


def _half_batch(postprocess):
    """Half of the batch left out: the second half's detections dropped."""
    def wrapped(self, *args, **kwargs):
        out = postprocess(self, *args, **kwargs)
        valid = out.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return out._replace(valid=valid)
    return wrapped


@pytest.mark.parametrize("wl,fault", [
    ("d435i_sensor1", _shifted), ("d435i_sensors8", _shifted),
    ("d435i_sensors8", _half_batch), ("kitti3_sensor1", _shifted)])
def test_a_broken_timed_path_is_not_correct(monkeypatch, wl, fault):
    from pillars_torch.models.detector import PillarsDetector

    monkeypatch.setattr(PillarsDetector, "postprocess",
                        fault(PillarsDetector.postprocess))
    out = _run(wl)
    assert not out["correct"], out["checks"]
    assert out["checks"]["detection_gap"]["value"] > \
        out["checks"]["detection_gap"]["limit"]


def test_decision_margin_excuses_a_near_tie_only():
    """A detection that the reference served and the program did not is
    excused only as far as the reference's own decision was close."""
    from port_bench.reference.compare import delivery_gap
    from port_bench.reference.pointpillars import Candidates

    boxes = np.array([[1, 0, -1, .6, .8, 1.7, .2], [4, 1, -1, .6, .8, 1.7, .3]],
                     np.float32)
    standup = np.array([[.7, -.4, 1.3, .4], [3.7, .6, 4.3, 1.4]], np.float32)
    model = {"postprocess": {"nms_score_threshold": 0.0,
                             "nms_iou_threshold": 0.5},
             "prediction_min_score": 0.45}

    def cands(scores):
        return Candidates(boxes, np.asarray(scores, np.float32),
                          np.array([True, True]), standup,
                          np.array([3.0, 3.0], np.float32),
                          np.array([.2, .3], np.float32), float("-inf"),
                          np.array([0, 1]), 0, 100)

    # the second box scores just above the serving threshold
    c = cands([0.9, 0.45001])
    g = delivery_gap(boxes[:1], np.float32([0.9]), c, model)
    assert g.unpaired == 1 and g.gap < 2e-5
    c = cands([0.9, 0.8])
    assert delivery_gap(boxes[:1], np.float32([0.9]), c, model).gap > 0.2
    shifted = boxes.copy()
    shifted[:, 0] += 0.3
    assert delivery_gap(shifted, np.float32([0.9, 0.8]), c, model).gap > 0.2
    assert delivery_gap(boxes, np.float32([0.9, 0.8]), c, model).gap == 0.0
