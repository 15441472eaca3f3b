"""The metric readers on records made up for the purpose: the operation
count the MFU metrics take from the reference, and the stages of the
captured graph read from the program's device marks."""

import numpy as np
import pytest

from port_bench import cost, harness
from port_bench.metrics import _common

MODEL = harness.config_file("kitti_3class")["model"]
KEPT = [14021, 15500, 9988]


def _cands():
    from port_bench.reference.pointpillars import Candidates

    e = np.zeros(0, np.float32)
    return [Candidates(e, e, e.astype(bool), e, e, e, float("-inf"),
                       e.astype(np.int64), 0, cost.model_flops(MODEL, k))
            for k in KEPT]


def _record():
    return {"model": MODEL, "cands": _cands(), "frames": [0, 1, 2, 2, 0],
            "window_s": 0.083, "replay_ms": 13.96,
            "device": {"kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_mfu_reads_the_reference_count_as_the_model_count_did():
    """The values the metrics gave when they counted with
    ``cost.model_flops`` themselves, bit for bit."""
    rec = _record()
    peak = cost.peaks(rec["device"]["kind"]).f32_flops
    kept = [KEPT[i] for i in rec["frames"]]
    before = sum(cost.model_flops(MODEL, k) for k in kept)
    assert _common.mfu(rec) == 100.0 * before / rec["window_s"] / peak
    per = sum(cost.model_flops(MODEL, k) for k in kept) / len(kept)
    assert _common.mfu_replay(rec) == \
        100.0 * per / (rec["replay_ms"] * 1e-3) / peak
    for name in ("mfu.latency", "mfu.serve"):
        assert harness.metric_reader(name)(rec) == _common.mfu(rec)
    assert harness.metric_reader("mfu.replay")(rec) == _common.mfu_replay(rec)


def test_the_reference_counts_the_points_its_pfn_kept():
    from port_bench.gen.bank import make_bank
    from port_bench.reference.pointpillars import Reference

    config = harness.config_file("pedestrian_d435i")
    ref = Reference(config["model"], str(harness.ROOT / config["weights"]))
    cloud = make_bank("hard", 1, 3)[0]
    (c,) = ref.run([cloud])
    kept = ref.canvas(cloud)[2]
    assert 0 < kept <= len(cloud)
    assert c.flops == cost.model_flops(config["model"], kept)


STAGES = ("voxelize", "pfn", "rpn", "post")


def _marked(ns, sampled):
    spans = {f"device.{s}": {"count": 3, "ns": n} for s, n in zip(STAGES, ns)}
    spans["stream.stage"] = {"count": 40, "ns": 3_200_000}
    return {"parts": {"marked": {"spans": spans, "clouds": 40, "counters": {
        "device.sampled_clouds": sampled, "device.sampled_replays": 3}}}}


@pytest.mark.parametrize("suffix", ["replay", "latency"])
def test_stage_readers(suffix):
    """They read the marked part, and nothing else."""
    readers = [harness.metric_reader(f"{s}_ms_per_cloud.{suffix}")
               for s in STAGES]
    untraced = {"parts": {"timed": {"spans": {}, "counters": {
        "nms_keep_mask.launches": 40}}}}
    marked = _marked([1, 2, 3, 4], 24)["parts"]["marked"]
    elsewhere = [{"parts": {"timed": marked}},
                 {"parts": {"timed": marked, "traced": marked}}]
    for rec in ({}, untraced, *elsewhere, _marked([1, 2, 3, 4], 0)):
        assert [r(rec) for r in readers] == [None] * 4
    rec = _marked([1_200_000, 2_400_000, 9_000_000, 600_000], 24)
    assert [r(rec) for r in readers] == pytest.approx(
        [0.05, 0.1, 0.375, 0.025], rel=1e-12)


def test_part_spans_per_cloud():
    part = _marked([1_200_000, 0, 0, 0], 24)["parts"]["marked"]
    out = _common.part_spans(part, clouds=40)
    assert out["device.voxelize"] == pytest.approx(
        {"count": 3, "ms": 1.2, "ms_per_cloud": 0.05}, rel=1e-12)
    assert out["stream.stage"]["ms_per_cloud"] == pytest.approx(0.08)
