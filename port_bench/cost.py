"""Operations, bytes and peaks: the yardstick of the roofline and MFU
metrics, frozen here so that the program cannot redefine what it is
measured against.

Counts follow the model's definition at the configuration's shapes (one
multiply-add = 2 operations), as ``pillars_torch/utils/roofline.py`` counted
them when this benchmark was written. The NMS count is taken from the
reference's own boxes, so it reads the same work whatever implements the
kernel: greedy NMS compares each valid box with the boxes kept before it,
15 float32 operations a pair, 5 a box; it reads each box (4 floats) and its
validity byte and writes one keep byte.
"""

from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional


class Peaks(NamedTuple):
    """NVIDIA's published dense peaks of one card (data sheet, at the full
    power limit): float32 on the CUDA cores, FLOP/s; HBM bytes/s."""

    name: str
    f32_flops: float
    hbm_bytes: float


# name substring (lower case) -> peaks; the PCIe part first, since the SXM
# part's name ("NVIDIA H100 80GB HBM3") carries no form factor
PEAKS = (Peaks("h100 pcie", 51e12, 2.0e12), Peaks("h100", 67e12, 3.35e12))


def peaks(device_name: str) -> Optional[Peaks]:
    name = device_name.lower()
    for p in PEAKS:
        if p.name in name:
            return p
    return None


def nms_ops_bytes(pairs: int, n_valid: int, k: int):
    """(operations, bytes) of one cloud's greedy NMS over ``k`` slots."""
    return 15.0 * pairs + 5.0 * n_valid, float(k * (16 + 1 + 1))


def nms_least_s(launches: Iterable[Iterable], peak: Peaks) -> float:
    """The least time of the NMS launches given as lists of per-cloud
    (pairs, valid, k): per launch the larger of its operations over the
    float32 peak and its bytes over the bandwidth, summed."""
    total = 0.0
    for clouds in launches:
        ops = byts = 0.0
        for pairs, n_valid, k in clouds:
            o, b = nms_ops_bytes(pairs, n_valid, k)
            ops += o
            byts += b
        total += max(ops / peak.f32_flops, byts / peak.hbm_bytes)
    return total


def rpn_flops(model: Dict) -> float:
    """Operations of the RPN's blocks, transposed convs and heads for one
    cloud (independent of the cloud)."""
    r = model["rpn"]
    nx, ny, _ = model["voxel"]["grid_size"]
    sep = r["use_separable_conv"]
    flops = 0.0
    cin, h, w = model["pfn"]["num_filters"], ny, nx
    for i in range(3):
        cout, s = r["num_filters"][i], r["layer_strides"][i]
        h, w = h // s, w // s
        for _ in range(r["layer_nums"][i] + 1):
            per = 9 * cin + cin * cout if sep else 9 * cin * cout
            flops += 2.0 * h * w * per
            cin = cout
    stride = 1
    for i in range(3):
        stride *= r["layer_strides"][i]
        u = r["upsample_strides"][i]
        flops += (2.0 * (ny // stride) * (nx // stride) * u * u
                  * r["num_filters"][i] * r["num_upsample_filters"][i])
    per_loc = sum(len(g["rotations"]) * (len(g["sizes"]) // 3)
                  for g in model["anchor_generators"])
    out_ch = per_loc * (7 + model["num_class"] + 2)
    flops += 2.0 * ny * nx * sum(r["num_upsample_filters"]) * out_ch
    return flops


def model_flops(model: Dict, kept_points: int) -> float:
    """Operations of one cloud's forward: the PFN's Linear over the points
    it keeps, and the RPN."""
    d_in = model["num_point_features"] + 5
    return 2.0 * kept_points * d_in * model["pfn"]["num_filters"] \
        + rpn_flops(model)
