"""Wrapper of the eval PFN kernel (``csrc/pfn_max.cu``), its plain twin, and
the parts of the PFN that the modules of models/pfn.py share with the twin.

``pfn_max`` computes a PillarFeatureNet in eval mode over cell-sorted points,
in float32: each kept point's D + 5 features (the point, its offset to the
pillar's point mean, its offset to the pillar centre), Linear without bias,
BatchNorm from the running statistics, ReLU, then per output row the max
over the row's kept points, with relu(bn(0)) where the row holds fewer than
N points. Two layouts, set by what the caller passes:

- point-major (``num_points`` and ``pillar_mask`` [rows]): ``cell`` is each
  point's (z, y, x) [M, 3]; rows whose ``pillar_mask`` is off are zero, and
  a non-finite value of a row is 0 (``max_over_pillars``). Returns [rows, F].
- dense cell (``count`` [M], the kept points of each point's cell): ``cell``
  is each point's cell id [M] in its sample's grid, the sentinel
  ``nx * ny * nz`` where invalid; returns ([rows, F], num_points [rows]
  int32), rows of empty cells zero (``max_over_cells``).

The kernel relies on what the voxelizers (ops/voxelize.py) give: rows are
non-decreasing over the points, a row that takes a value holds a kept point
(``pillar_mask`` is ``num_points > 0`` and ``num_points`` counts kept
points; every valid point of a cell carries the cell's count). It has no
TPU counterpart: the JAX package leaves the PFN to XLA, which fuses it. A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin :func:`pfn_max_plain`. The counter ``pfn_max.launches``
(utils/tracing.py) counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.nn import functional as F

from pillars_torch.ops import _build
from pillars_torch.utils import tracing


class _Args(ctypes.Structure):
    """``PfnArgs`` of csrc/pfn_max.cu, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "points", "mean", "cell", "row", "kept", "count", "pillar_mask",
        "weight", "bn_mean", "bn_var", "bn_weight", "bn_bias", "out",
        "tail")]
        + [("m", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in (
            "rows", "features", "dim", "mean_stride", "dense", "nx", "nxy",
            "n_max")]
        + [(name, ctypes.c_float) for name in (
            "eps", "vx", "vy", "x_off", "y_off")])


MAX_FEATURES = 256  # F
POINT_WIDTHS = (3, 4)  # D: xyz, or xyz and intensity


@functools.cache
def _fn():
    fn = _build.load("pfn_max").pfn_max
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _offsets(voxel):
    """(vx, vy, x offset, y offset) of the pillar centres: centre = cell *
    size + (size / 2 + the range's corner)."""
    vx, vy = voxel.voxel_size[:2]
    pcr = voxel.point_cloud_range
    return vx, vy, vx / 2 + pcr[0], vy / 2 + pcr[1]


def pillar_centres(cell: torch.Tensor, dtype: torch.dtype, voxel):
    """(cx, cy) [M] of each point's pillar centre, in ``dtype``, from its
    (z, y, x) [M, 3] or from its cell id [M] = (z * ny + y) * nx + x."""
    vx, vy, x_off, y_off = _offsets(voxel)
    if cell.dim() == 2:
        cxi, cyi = cell[:, 2], cell[:, 1]
    else:
        nx, ny, _ = voxel.grid_size
        rem = torch.remainder(cell, ny * nx)
        cyi = torch.div(rem, nx, rounding_mode="floor")
        cxi = rem - cyi * nx
    return cxi.to(dtype) * vx + x_off, cyi.to(dtype) * vy + y_off


def point_features(points, mean, cx, cy):
    """The D + 5 features of each point [M, D + 5]: the point, its offset
    to its pillar's point mean ``mean`` [M, 3], its offset to the pillar
    centre ``cx``/``cy``."""
    return torch.cat([points, points[:, :3] - mean,
                      (points[:, 0] - cx)[:, None],
                      (points[:, 1] - cy)[:, None]], dim=-1)


def max_over_pillars(x, zero_contrib, row, kept, num_points, pillar_mask,
                     n_max: int):
    """Point-major: per pillar row [P, F] the max of ``x`` [M, F] over its
    kept points, and relu(bn(0)) ``zero_contrib`` [F] where it holds fewer
    than ``n_max`` points; rows whose ``pillar_mask`` is off, and non-finite
    values, are zero. Point ids ``row`` [M] are at most P (P: dropped)."""
    n_pillars = num_points.shape[0]
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    x = torch.where(kept[:, None], x, neg)  # dropped points cannot win a max
    # one spare row takes the id P (the JAX package drops it)
    seg = torch.full((n_pillars + 1, x.shape[1]), float("-inf"),
                     dtype=x.dtype, device=x.device)
    seg.scatter_reduce_(0, row.long()[:, None].expand_as(x), x, "amax")
    seg = seg[:n_pillars]
    pad_rows = (num_points < n_max)[:, None]
    seg = torch.maximum(seg, torch.where(pad_rows, zero_contrib[None], neg))
    return torch.where(pillar_mask[:, None] & torch.isfinite(seg), seg,
                       torch.zeros_like(seg))


def max_over_cells(x, zero_contrib, cell, row, kept, count, n_rows: int,
                   voxel):
    """Dense cell: per cell row [n_rows, F] the max of ``x`` [M, F] over its
    kept points, with relu(bn(0)) where it holds fewer than N points, and
    its point count [n_rows] int32; empty cells are zero."""
    nx, ny, nz = voxel.grid_size
    n_filters = x.shape[1]
    neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
    xm = torch.where(kept[:, None], x, neg)
    # the per-cell count rides the same scatter as channel F: every
    # valid row of a cell carries the same count, so max == count;
    # invalid rows are -inf everywhere and cannot corrupt the row they
    # alias (a sample's sentinel is the next sample's cell 0)
    valid = cell < nx * ny * nz
    cnt_ch = torch.where(valid, count.to(x.dtype), neg)
    aug = torch.cat([xm, cnt_ch[:, None]], dim=-1)

    # one spare row takes the last sample's sentinel
    seg = torch.full((n_rows + 1, n_filters + 1), float("-inf"),
                     dtype=x.dtype, device=x.device)
    seg.scatter_reduce_(0, row.long()[:, None].expand_as(aug), aug, "amax")
    seg = seg[:n_rows]
    cell_feats = seg[:, :n_filters]
    npts = seg[:, n_filters]

    occupied = npts > 0
    pad_rows = npts < voxel.max_points_per_voxel  # empty cells masked below
    cell_feats = torch.maximum(
        cell_feats, torch.where(pad_rows[:, None], zero_contrib[None], neg))
    cell_feats = torch.where(occupied[:, None], cell_feats,
                             torch.zeros_like(cell_feats))
    num_points = torch.where(occupied, npts,
                             torch.zeros_like(npts)).to(torch.int32)
    return cell_feats, num_points


def point_outputs(points, mean, cell, kept, weight, bn_mean, bn_var,
                  bn_weight, bn_bias, eps: float, voxel):
    """The eval PFN before its max, in library ops, as the modules compute
    it: (relu(bn(linear(features))) [M, F], the features zero where not
    kept; relu(bn(0)) [F])."""
    cx, cy = pillar_centres(cell, points.dtype, voxel)
    feats = point_features(points, mean[:, :3], cx, cy)
    feats = torch.where(kept[:, None], feats, torch.zeros_like(feats))
    # _PointwiseMaskedBN's eval order
    inv = torch.rsqrt(bn_var + eps)
    x = torch.relu((F.linear(feats, weight) - bn_mean) * inv * bn_weight
                   + bn_bias)
    return x, torch.relu((0.0 - bn_mean) * inv * bn_weight + bn_bias)


def pfn_max_plain(points, mean, cell, row, kept, weight, bn_mean, bn_var,
                  bn_weight, bn_bias, eps: float, voxel, n_rows: int, *,
                  num_points: Optional[torch.Tensor] = None,
                  pillar_mask: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None):
    """The modules' eval computation in library ops: ``point_outputs``,
    then the layout's segment max."""
    x, zero_contrib = point_outputs(points, mean, cell, kept, weight,
                                    bn_mean, bn_var, bn_weight, bn_bias, eps,
                                    voxel)
    if count is None:
        return max_over_pillars(x, zero_contrib, row, kept, num_points,
                                pillar_mask, voxel.max_points_per_voxel)
    return max_over_cells(x, zero_contrib, cell, row, kept, count, n_rows,
                          voxel)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got "
                         f"{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, points on {device}")
    return t.contiguous()


def pfn_max(points, mean, cell, row, kept, weight, bn_mean, bn_var,
            bn_weight, bn_bias, eps: float, voxel, n_rows: int, *,
            num_points: Optional[torch.Tensor] = None,
            pillar_mask: Optional[torch.Tensor] = None,
            count: Optional[torch.Tensor] = None):
    """points [M, D] float32 (D = 3 or 4), mean [M, >=3] float32, cell
    (point-major: [M, 3] int32 (z, y, x); dense cell: [M] int32), row [M]
    int32 (the output row), kept [M] bool; weight [F, D + 5] (F <= 256) and
    the BN's running mean and variance, weight and bias [F] float32 (read on
    the device at each launch, so a captured graph reads their current
    values); ``voxel`` the VoxelConfig. Point-major: num_points [n_rows]
    int32 and pillar_mask [n_rows] bool -> [n_rows, F]. Dense cell: count
    [M] int32 -> ([n_rows, F], [n_rows] int32)."""
    dense = count is not None
    if dense == (num_points is not None or pillar_mask is not None):
        raise ValueError("pass count (dense cell) or num_points and "
                         "pillar_mask (point-major)")
    if points.device.type == "cpu":
        return pfn_max_plain(points, mean, cell, row, kept, weight, bn_mean,
                             bn_var, bn_weight, bn_bias, eps, voxel, n_rows,
                             num_points=num_points, pillar_mask=pillar_mask,
                             count=count)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    dev = points.device
    if points.dim() != 2 or points.dtype != torch.float32:
        raise TypeError(f"points must be [M, D] float32, got "
                        f"{list(points.shape)} {points.dtype}")
    m, d = points.shape
    n_filters = weight.shape[0]
    if d not in POINT_WIDTHS or not 1 <= n_filters <= MAX_FEATURES:
        raise ValueError(f"the kernel takes D in {POINT_WIDTHS} and "
                         f"1 <= F <= {MAX_FEATURES}, got D = {d}, "
                         f"F = {n_filters}")
    if mean.dim() != 2 or mean.shape[1] < 3:
        raise ValueError(f"mean must be [M, >=3], got {list(mean.shape)}")
    points = points.contiguous()
    mean = _check("mean", mean, torch.float32, (m, mean.shape[1]), dev)
    cell = _check("cell", cell, torch.int32, (m,) if dense else (m, 3), dev)
    row = _check("row", row, torch.int32, (m,), dev)
    kept = _check("kept", kept, torch.bool, (m,), dev)
    weight = _check("weight", weight, torch.float32, (n_filters, d + 5), dev)
    vectors = [_check(name, t, torch.float32, (n_filters,), dev)
               for name, t in (("bn_mean", bn_mean), ("bn_var", bn_var),
                               ("bn_weight", bn_weight),
                               ("bn_bias", bn_bias))]
    if dense:
        count = _check("count", count, torch.int32, (m,), dev)
        tail = n_rows
    else:
        count = _check("num_points", num_points, torch.int32, (n_rows,),
                       dev)
        pillar_mask = _check("pillar_mask", pillar_mask, torch.bool,
                             (n_rows,), dev)
        tail = 2 + m  # ticket, list length, list of rows to clear
    # the output and the tail in one allocation, zeroed by one memset
    buf = torch.empty(n_rows * n_filters + tail, dtype=torch.int32,
                      device=dev)
    out = buf[:n_rows * n_filters].view(torch.float32).view(n_rows,
                                                            n_filters)
    nx, ny, _ = voxel.grid_size
    vx, vy, x_off, y_off = _offsets(voxel)
    args = _Args(
        points.data_ptr(), mean.data_ptr(), cell.data_ptr(), row.data_ptr(),
        kept.data_ptr(), count.data_ptr(),
        None if dense else pillar_mask.data_ptr(), weight.data_ptr(),
        *(t.data_ptr() for t in vectors), buf.data_ptr(),
        buf.data_ptr() + 4 * n_rows * n_filters, m, n_rows, n_filters, d,
        mean.shape[1], int(dense), nx, nx * ny, voxel.max_points_per_voxel,
        eps, vx, vy, x_off, y_off)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _fn()(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"pfn_max kernel launch failed: CUDA error {err}")
    tracing.count("pfn_max.launches")
    if dense:
        return out, buf[n_rows * n_filters:]
    return out


tracing.count("pfn_max.launches", 0)
