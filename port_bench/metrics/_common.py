"""What the metric readers share. A reader takes the run's record (the
loop's counts, the trace summary of a traced window, the reference's
candidates, the device) and returns its value, or None where the run holds
nothing for it to read; a share of a peak or a roofline is never 0 for
want of a reading."""

from __future__ import annotations

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
    operations per cloud of the timed part over its mean replay time (batch
    1: one replay a cloud)."""
    peak = _peak(rec)
    if peak is None or not rec["frames"] or not rec.get("replay_ms"):
        return None
    cands = rec["cands"]
    flops = sum(cost.model_flops(rec["model"], cands[i].kept_points)
                for i in rec["frames"]) / len(rec["frames"])
    return 100.0 * flops / (rec["replay_ms"] * 1e-3) / peak.f32_flops


def mfu(rec: Dict) -> Optional[float]:
    """% of the cards' float32 peak: the model's operations for the clouds
    delivered in the timed part over its length."""
    peak = _peak(rec)
    if peak is None or not rec["frames"]:
        return None
    cands = rec["cands"]
    flops = sum(cost.model_flops(rec["model"], cands[i].kept_points)
                for i in rec["frames"])
    return 100.0 * flops / rec["window_s"] / (
        peak.f32_flops * rec["device"]["count"])
