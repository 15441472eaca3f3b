"""Analytic FLOP and byte counts per stage, and a measured time placed on
the card's roofline (pillars_tpu/utils/roofline.py, with the H100's peaks).

The counts are the JAX package's: one multiply-add = 2 FLOPs over the PFN
matmul, the middle, the conv stack and the heads, where every FLOP of this
model family lives; bytes per stage are activation in + activation out +
weights at the given dtype width, a LOWER bound (fusion can only cut the
traffic below the per-layer sum; re-reads raise it). Elementwise work (BN,
ReLU, sigmoid, box decode) counts in bytes, not FLOPs. The voxelizer's and
the sparse middle's counts are models, not measurements (their
docstrings).

:func:`roofline_report` divides them by NVIDIA's published peaks of the
card (:data:`PEAKS`; data-sheet figures, not measurements): the float32
peak outside the tensor cores for a float32 path (the port turns TF32 off,
``models/detector.py``), the dense bfloat16 tensor-core peak for a
bfloat16 one, and the HBM bandwidth. Its ``bound_ms`` is the least time the
card could take for the counted work: the larger of FLOPs over the peak
and bytes over the bandwidth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

from pillars_torch.config import Config


@dataclasses.dataclass
class StageCost:
    """FLOPs (multiply-adds x2) + HBM bytes (lower bound) for one stage."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "StageCost") -> "StageCost":
        return StageCost(self.flops + other.flops, self.bytes + other.bytes)


class Peaks(NamedTuple):
    """NVIDIA's published dense peaks of one card (its data sheet, at the
    card's full power limit), not measurements."""

    name: str
    f32_flops: float   # FP32 on the CUDA cores, FLOP/s
    tf32_flops: float  # TF32 tensor cores, FLOP/s
    bf16_flops: float  # BF16 tensor cores, FLOP/s
    hbm_bytes: float   # device memory bandwidth, bytes/s


# name substring (lower case) -> peaks; the PCIe part before the SXM part,
# whose name ("NVIDIA H100 80GB HBM3") carries no form factor
PEAKS = (
    Peaks("h100 pcie", 51e12, 378e12, 756e12, 2.0e12),
    Peaks("h100", 67e12, 495e12, 989e12, 3.35e12),
)


def device_peaks(device_name: Optional[str] = None) -> Optional[Peaks]:
    """The published peaks of the card named ``device_name`` (default:
    ``torch.cuda.get_device_name(0)``), or None for a card not in
    :data:`PEAKS`."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name(0)
    name = device_name.lower()
    for peaks in PEAKS:
        if peaks.name in name:
            return peaks
    return None


# ---------------------------------------------------------------------------
# analytic stage costs
# ---------------------------------------------------------------------------

def pfn_cost(cfg: Config, batch: int = 1, dtype_bytes: int = 4) -> StageCost:
    """The PFN Dense matmul (reference model/pointpillars.py:65-225).

    Row count depends on the formulation: the point-major / dense-cell
    paths run the matmul over every RAW point (max_points), the dense
    [P, N, D] path over max_voxels * max_points_per_voxel padded rows.
    """
    m = cfg.model
    in_feats = m.num_point_features + 5 + (1 if m.pfn.with_distance else 0)
    f = m.pfn.num_filters
    if m.pfn.simple_mean:  # SECOND SimpleVoxel: per-voxel mean, no matmul
        rows = batch * m.voxel.max_points
        return StageCost(0.0, rows * in_feats * dtype_bytes * 2)
    if m.pfn.pointwise or m.pfn.dense_cell:
        rows = batch * m.voxel.max_points
    else:
        rows = batch * m.voxel.max_voxels * m.voxel.max_points_per_voxel
    flops = 2.0 * rows * in_feats * f
    byts = (rows * (in_feats + f) + in_feats * f) * dtype_bytes
    return StageCost(flops, byts)


def voxelize_cost(cfg: Config, batch: int = 1,
                  dtype_bytes: int = 4) -> StageCost:
    """Sort-based voxelizer: no FLOPs counted, memory movement only. Rough
    traffic model: ~3 full passes over (points + packed sort keys); its
    ``bytes`` are indicative only."""
    m = batch * cfg.model.voxel.max_points
    d = cfg.model.num_point_features
    return StageCost(0.0, 3.0 * m * (d * dtype_bytes + 8))


def scatter_cost(cfg: Config, batch: int = 1,
                 dtype_bytes: int = 4) -> StageCost:
    """Pillar->canvas scatter (+ z-layer ADD): read P*F, write ny*nx*F."""
    m = cfg.model
    nx, ny, _ = m.voxel.grid_size
    f = m.pfn.num_filters
    p = (nx * ny * m.voxel.grid_size[2] if m.pfn.dense_cell
         else m.voxel.max_voxels)
    return StageCost(0.0,
                     batch * (p * f + nx * ny * f) * dtype_bytes)


def middle_cost(cfg: Config, batch: int = 1,
                dtype_bytes: int = 4) -> StageCost:
    """SECOND-style sparse/dense middle extractor (models/sparse_middle.py).

    Sparse path: a submanifold 3D conv costs ~2 * V * K_act * Cin * Cout
    MACs where K_act is the average number of ACTIVE taps; LiDAR occupancy
    is surface-like, so K_act ~ 9 of 27 is the documented estimate (the
    rulebook length is data-dependent — this is deliberately a model, not
    a measurement). V is the static active-voxel cap per stage. Bytes add
    the per-tap gather traffic."""
    m = cfg.model.middle
    if not m.enabled:
        return StageCost()
    v = m.max_active or cfg.model.voxel.max_voxels
    k_act = 9.0  # documented estimate of active taps out of 27
    flops = 0.0
    byts = 0.0
    c_in = (cfg.model.num_point_features if cfg.model.pfn.simple_mean
            else cfg.model.pfn.num_filters)
    for c_out in m.num_filters:
        layers = (m.subm_per_stage + 1) if m.sparse else 1  # + downsample
        for _ in range(layers):
            flops += 2.0 * batch * v * k_act * c_in * c_out
            byts += batch * v * (k_act * c_in + c_out) * dtype_bytes
            c_in = c_out
    return StageCost(flops, byts)


def rpn_cost(cfg: Config, batch: int = 1,
             dtype_bytes: int = 4) -> Dict[str, StageCost]:
    """Conv stack + deconv branches + 1x1 heads (reference
    model/voxelnet.py:517-717), on the config's BEV feature map."""
    m = cfg.model
    r = m.rpn
    # blocks/deconvs resolve from the CANVAS (grid) — feature_map_size is
    # already divided by out_size_factor = layer_strides[0]/upsample_strides[0],
    # so starting there would double-count the first stride and under-count
    # block FLOPs ~4x whenever out_size_factor != 1. Heads run
    # at feature_map_size (the deconv-concat output resolution).
    nxc, nyc, _ = m.voxel.grid_size
    h0, w0 = nyc, nxc
    _, ny_f, nx_f = m.feature_map_size  # [1, ny, nx] at out_size_factor
    hf, wf = ny_f, nx_f

    def conv2d(h, w, cin, cout, k=3, separable=r.use_separable_conv):
        if separable:
            flops = 2.0 * h * w * (k * k * cin + cin * cout)
            wbytes = (k * k * cin + cin * cout) * dtype_bytes
        else:
            flops = 2.0 * h * w * k * k * cin * cout
            wbytes = k * k * cin * cout * dtype_bytes
        return flops, wbytes

    blocks = StageCost()
    c_in = m.pfn.num_filters  # canvas channels (z layers scatter-ADD)
    h, w = h0, w0
    for i in range(3):
        c_out = r.num_filters[i]
        s = r.layer_strides[i]
        h, w = h // s, w // s
        for li in range(r.layer_nums[i] + 1):  # strided conv0 + n same
            fl, wb = conv2d(h, w, c_in, c_out)
            act = (h * s * w * s * c_in if li == 0 else h * w * c_in)
            blocks += StageCost(batch * fl,
                                batch * (act + h * w * c_out) * dtype_bytes
                                + wb)
            c_in = c_out

    deconvs = StageCost()
    for i in range(3):
        c_i = r.num_filters[i]
        u = r.upsample_strides[i]
        f_up = r.num_upsample_filters[i]
        hi = h0 // _prod(r.layer_strides[: i + 1])
        wi = w0 // _prod(r.layer_strides[: i + 1])
        # ConvTranspose kernel == stride: each input pixel expands into a
        # disjoint u x u tile -> 2 * Hi * Wi * u^2 * Ci * Fup exactly
        fl = 2.0 * hi * wi * u * u * c_i * f_up
        deconvs += StageCost(
            batch * fl,
            batch * (hi * wi * c_i + hi * u * wi * u * f_up) * dtype_bytes
            + u * u * c_i * f_up * dtype_bytes)

    n_anchor = m.num_anchors_per_loc
    out_ch = n_anchor * m.box_code_size
    out_ch += n_anchor * (m.num_class if m.encode_background_as_zeros
                          else m.num_class + 1)
    if m.postprocess.use_direction_classifier:
        out_ch += n_anchor * 2
    f_total = sum(r.num_upsample_filters)  # split heads == concat, same MACs
    heads = StageCost(
        batch * 2.0 * hf * wf * f_total * out_ch,
        batch * (hf * wf * (f_total + out_ch)) * dtype_bytes
        + f_total * out_ch * dtype_bytes)
    return {"rpn_blocks": blocks, "rpn_deconvs": deconvs, "heads": heads}


def postprocess_cost(cfg: Config, batch: int = 1,
                     dtype_bytes: int = 4) -> StageCost:
    """Decode + top-k + NMS: negligible MACs; traffic ~ a few passes over
    the anchor-shaped score/box tensors."""
    m = cfg.model
    _, ny, nx = m.feature_map_size
    n_anchors = ny * nx * m.num_anchors_per_loc
    per = m.box_code_size + m.num_class + 2 + 1
    return StageCost(0.0, batch * 3.0 * n_anchors * per * dtype_bytes)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def detector_cost(cfg: Config, batch: int = 1,
                  dtype_bytes: int = 4) -> Dict[str, StageCost]:
    """Per-stage inference cost for one batch; key "total" sums them."""
    stages: Dict[str, StageCost] = {
        "voxelize": voxelize_cost(cfg, batch, dtype_bytes),
        "pfn": pfn_cost(cfg, batch, dtype_bytes),
        "scatter": scatter_cost(cfg, batch, dtype_bytes),
    }
    if cfg.model.middle.enabled:
        stages["middle"] = middle_cost(cfg, batch, dtype_bytes)
    stages.update(rpn_cost(cfg, batch, dtype_bytes))
    stages["postprocess"] = postprocess_cost(cfg, batch, dtype_bytes)
    total = StageCost()
    for c in stages.values():
        total += c
    stages["total"] = total
    return stages


# ---------------------------------------------------------------------------
# roofline placement
# ---------------------------------------------------------------------------

def roofline_report(cfg: Config, ms_per_batch: float, batch: int = 1,
                    device_name: Optional[str] = None,
                    dtype_bytes: int = 4) -> Dict[str, object]:
    """Place a measured time per batch on the card's roofline.

    Returns the FLOP and byte totals and stages, the achieved rates, and,
    for a card in :data:`PEAKS` (``device_name``; default the card's own
    name), ``flop_frac`` and ``hbm_frac`` (achieved over peak, the FLOP peak
    float32's for ``dtype_bytes`` 4 and bfloat16's for 2), ``bound_ms``
    (the least time for the counted work), ``bound_by`` ("bytes" or
    "operations", whichever sets ``bound_ms``) and ``bound`` (``compute`` /
    ``hbm`` when that resource is at least a third busy, else ``latency``:
    the time goes to launches and dependencies)."""
    stages = detector_cost(cfg, batch, dtype_bytes)
    total = stages["total"]
    secs = ms_per_batch / 1e3
    achieved_flops = total.flops / secs
    achieved_bw = total.bytes / secs
    out: Dict[str, object] = {
        "flops": total.flops,
        "bytes": total.bytes,
        "flops_per_byte": total.flops / max(total.bytes, 1.0),
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbps": achieved_bw / 1e9,
        "stages": {k: dataclasses.asdict(v) for k, v in stages.items()
                   if k != "total"},
        "card": None, "peak_flops": None, "peak_bytes_per_s": None,
        "flop_frac": None, "hbm_frac": None, "bound_ms": None,
        "bound_by": None, "bound": None,
    }
    peaks = device_peaks(device_name)
    if peaks is None:
        return out
    peak_flops = peaks.f32_flops if dtype_bytes == 4 else peaks.bf16_flops
    flop_frac = achieved_flops / peak_flops
    hbm = achieved_bw / peaks.hbm_bytes
    ops_ms = total.flops / peak_flops * 1e3
    bytes_ms = total.bytes / peaks.hbm_bytes * 1e3
    if flop_frac >= 1 / 3:
        bound = "compute"
    elif hbm >= 1 / 3:
        bound = "hbm"
    else:
        bound = "latency"
    out.update(card=peaks.name, peak_flops=peak_flops,
               peak_bytes_per_s=peaks.hbm_bytes, flop_frac=flop_frac,
               hbm_frac=hbm, bound_ms=max(ops_ms, bytes_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound=bound, ridge_flops_per_byte=peak_flops / peaks.hbm_bytes)
    return out
