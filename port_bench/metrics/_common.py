"""What the metric readers share. A reader takes the run's record (the
loop's counts, the trace summary of a traced window, the reference's
candidates, the device) and returns its value, or None where the run holds
nothing for it to read; a share of a peak or a roofline is never 0 for
want of a reading."""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

from port_bench import cost


def latency_p95_ms(rec: Dict) -> Optional[float]:
    lat = rec["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None


def clouds_per_s(rec: Dict) -> Optional[float]:
    return rec["clouds"] / rec["window_s"] if rec["clouds"] else None


def setup_s(rec: Dict) -> Optional[float]:
    return rec["setup_s"]


def replay_ms(rec: Dict) -> Optional[float]:
    """The card's mean time per replay of the captured graph over the timed
    part (CUDA events; one replay serves one dispatch)."""
    return rec.get("replay_ms")


def _traced(rec: Dict) -> Optional[Dict]:
    t = rec.get("trace")
    if t is None or not rec.get("traced_clouds") or t["device_s"] <= 0:
        return None
    return t


def device_ms_per_cloud(rec: Dict) -> Optional[float]:
    t = _traced(rec)
    return None if t is None else t["device_s"] * 1e3 / rec["traced_clouds"]


def kernels_per_cloud(rec: Dict) -> Optional[float]:
    t = _traced(rec)
    return None if t is None else t["kernels"] / rec["traced_clouds"]


def host_ms_per_cloud(rec: Dict) -> Optional[float]:
    """The timed part's mean latency less the traced part's device time
    per cloud."""
    dev = device_ms_per_cloud(rec)
    if dev is None or not rec["latencies_ms"]:
        return None
    return float(np.mean(rec["latencies_ms"])) - dev


def device_idle_frac(rec: Dict) -> Optional[float]:
    """1 - the device's busy time per cloud (the traced part: the union of
    its operations over the clouds it served) times the clouds per second
    of the timed part, which ran with the profiler off: the share of the
    untraced loop's time in which the device had nothing to run."""
    t = _traced(rec)
    if t is None or not rec["clouds"]:
        return None
    return 1.0 - (t["busy_s"] / rec["traced_clouds"]) * (
        rec["clouds"] / rec["window_s"])


def clouds_per_dispatch(rec: Dict) -> Optional[float]:
    return rec["fresh"] / rec["dispatches"] if rec["dispatches"] else None


def _peak(rec: Dict):
    return cost.peaks(rec["device"]["kind"])


def nms_roofline(rec: Dict) -> Optional[float]:
    """% of the NMS kernel's roofline: the least time of the traced part's
    launches on the reference's boxes over the kernel's traced time, both
    per launch."""
    t, peak = _traced(rec), _peak(rec)
    if t is None or peak is None or not t["nms_launches"] \
            or not rec["traced_batches"]:
        return None
    cands = rec["cands"]
    k = rec["model"]["postprocess"]["nms_pre_max_size"]
    launches = []
    for batch in rec["traced_batches"]:
        clouds = [(cands[i].nms_pairs, int(cands[i].valid.sum()), k)
                  for i in batch]
        clouds += [(0, 0, k)] * (rec["slots"] - len(batch))
        launches.append(clouds)
    least = cost.nms_least_s(launches, peak) / len(launches)
    return 100.0 * least / (t["nms_s"] / t["nms_launches"])


def mfu_replay(rec: Dict) -> Optional[float]:
    """% of the card's float32 peak over the card's time: the model's
    operations per cloud of the timed part (the reference's count of each
    cloud's forward pass) over its mean replay time (batch 1: one replay a
    cloud)."""
    peak = _peak(rec)
    if peak is None or not rec["frames"] or not rec.get("replay_ms"):
        return None
    cands = rec["cands"]
    flops = sum(cands[i].flops for i in rec["frames"]) / len(rec["frames"])
    return 100.0 * flops / (rec["replay_ms"] * 1e-3) / peak.f32_flops


def mfu(rec: Dict) -> Optional[float]:
    """% of the cards' float32 peak: the model's operations for the clouds
    delivered in the timed part (the reference's count of each cloud's
    forward pass) over its length."""
    peak = _peak(rec)
    if peak is None or not rec["frames"]:
        return None
    cands = rec["cands"]
    flops = sum(cands[i].flops for i in rec["frames"])
    return 100.0 * flops / rec["window_s"] / (
        peak.f32_flops * rec["device"]["count"])


# ---------------------------------------------------------------- spans
def part_spans(part: Dict, clouds: int) -> Dict:
    """A part's spans (``record["parts"][...]``) per name: ``count``,
    ``ms`` and ``ms_per_cloud``, over the ``clouds`` delivered in the part,
    and for the device marks (``device.*``) over the clouds of the replays
    they sampled."""
    sampled = part["counters"].get("device.sampled_clouds", 0)
    out = {}
    for name, row in part["spans"].items():
        per = sampled if name.startswith("device.") else clouds
        out[name] = {"count": row["count"], "ms": row["ns"] / 1e6,
                     "ms_per_cloud": row["ns"] / 1e6 / per if per else None}
    return out


def stage_ms_per_cloud(rec: Dict, stage: str) -> Optional[float]:
    """The card's time per cloud of one stage of the captured inference
    graph in the marked part (``loops/_window.py``; profiler off): the
    device mark ``device.<stage>`` summed over the replays it sampled, over
    their clouds (``device.sampled_clouds``); None where the run took no
    marks (no marked part, no captured graph)."""
    part = (rec.get("parts") or {}).get("marked")
    if part is None:
        return None
    span = part["spans"].get(f"device.{stage}")
    clouds = part["counters"].get("device.sampled_clouds", 0)
    if span is None or not clouds:
        return None
    return span["ns"] / 1e6 / clouds


voxelize_ms_per_cloud = functools.partial(stage_ms_per_cloud, stage="voxelize")
pfn_ms_per_cloud = functools.partial(stage_ms_per_cloud, stage="pfn")
rpn_ms_per_cloud = functools.partial(stage_ms_per_cloud, stage="rpn")
post_ms_per_cloud = functools.partial(stage_ms_per_cloud, stage="post")
