"""Spatial (BEV-grid) model parallelism (pillars_tpu/parallel/spatial.py).

Each rank of a ``spatial`` mesh axis runs the RPN on one band of BEV rows
(the y axis: dim 1 of the NHWC canvas, dim 2 inside the NCHW RPN). The
JAX package marks the canvas and head tensors with
``with_sharding_constraint`` and XLA inserts the halo exchanges; here they
are written out:

- the front end (voxelize + PFN, or a SECOND middle) stays replicated
  within the spatial group: every rank builds the whole canvas, then keeps
  its band (:func:`shard_canvas`);
- every 3x3 conv of the RPN blocks reads one row past each edge of its
  band: :func:`halo_exchange` brings the last row of the band above and the
  first row of the band below (zeros at the grid's edges), and the conv
  runs VALID along y. A stride-2 conv needs only the row above (output row
  i reads input rows 2i-1..2i+1 and every band starts at an even row); the
  row below is exchanged all the same, so every conv has one shape of
  exchange, and it goes unread;
- deconvs (kernel == stride) and the 1x1 heads need no halo;
- the heads come back whole on every rank (:func:`gather_canvas`), so the
  postprocess and the loss run as they do unsharded.

Bands are whole multiples of the RPN's total stride, the last taking the
remainder (:func:`band_rows`). Anchor order is (y, x, type)-major, so [B, A]
per-anchor tensors split along the same rows (:func:`shard_anchors_flat`).

Contract, as in the JAX package: set ``runtime.spatial_axis`` only with a
mesh that defines that axis (``PillarsDetector(..., mesh=spatial_mesh(n))``);
``apply`` raises otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pillars_torch.parallel.collectives import (all_gather_stack,
                                                gather_replicated)
from pillars_torch.parallel.mesh import Mesh, make_mesh

SPATIAL_AXIS = "spatial"


def spatial_mesh(num_devices: int = 0) -> Mesh:
    """1-D mesh whose one axis is :data:`SPATIAL_AXIS`."""
    return make_mesh(num_devices, axis_name=SPATIAL_AXIS)


def band_rows(rows: int, n: int, multiple: int = 1) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``n`` bands of ``rows``: whole multiples of
    ``multiple`` rows each, the last band taking the remainder."""
    if rows % multiple:
        raise ValueError(f"{rows} rows are not a multiple of {multiple}")
    per = (rows // multiple) // n * multiple
    if per == 0:
        raise ValueError(f"{rows} rows make fewer than {n} bands of "
                         f"{multiple} rows")
    return [(i * per, (i + 1) * per if i < n - 1 else rows)
            for i in range(n)]


def _band(mesh: Mesh, axis_name: str, rows: int, multiple: int):
    bands = band_rows(rows, mesh.axis_size(axis_name), multiple)
    return bands, bands[mesh.axis_index(axis_name)]


def shard_canvas(x: torch.Tensor, axis_name: Optional[str],
                 mesh: Optional[Mesh], multiple: int = 1) -> torch.Tensor:
    """This rank's band of the rows (dim 1) of an NHWC canvas or head
    tensor; ``x`` as it is without an axis."""
    if not axis_name:
        return x
    _, (start, stop) = _band(mesh, axis_name, x.shape[1], multiple)
    return x[:, start:stop]


def gather_canvas(x: torch.Tensor, axis_name: Optional[str],
                  mesh: Optional[Mesh], rows: int,
                  multiple: int = 1) -> torch.Tensor:
    """The whole NHWC tensor from every rank's band of its rows (``rows``
    in all, banded as :func:`shard_canvas` bands them), on every rank. For a result
    that every rank of the group consumes alike: the gradient of this
    rank's band is its own slice (:func:`gather_replicated`)."""
    if not axis_name:
        return x
    bands, _ = _band(mesh, axis_name, rows, multiple)
    widest = max(stop - start for start, stop in bands)
    if widest > x.shape[1]:
        pad = (x.shape[0], widest - x.shape[1]) + tuple(x.shape[2:])
        x = torch.cat([x, x.new_zeros(pad)], dim=1)
    parts = gather_replicated(x, mesh.group(axis_name))
    return torch.cat([parts[i][:, :stop - start]
                      for i, (start, stop) in enumerate(bands)], dim=1)


def shard_anchors_flat(x: torch.Tensor, axis_name: Optional[str],
                       mesh: Optional[Mesh], rows: int,
                       multiple: int = 1) -> torch.Tensor:
    """This rank's part of a [B, A] per-anchor tensor (anchor order
    (y, x, T)-major over ``rows`` rows of anchors): the anchors of the
    band's rows."""
    if not axis_name:
        return x
    per_row = x.shape[1] // rows
    _, (start, stop) = _band(mesh, axis_name, rows, multiple)
    return x[:, start * per_row:stop * per_row]


def halo_exchange(x: torch.Tensor, axis_name: str,
                  mesh: Mesh) -> torch.Tensor:
    """``x`` (this rank's band of the rows, dim 2 of NCHW) with one row on
    each side: the last row of the band above and the first row of the band
    below, zeros at the grid's edges. One all-gather of every band's two
    edge rows; its backward returns each row's gradient to its band."""
    group = mesh.group(axis_name)
    i = mesh.axis_index(axis_name)
    edges = torch.stack([x[:, :, :1], x[:, :, -1:]])
    zero = torch.zeros_like(edges)[None]
    # [n + 2, 2, ...]: every band's (first, last) row between zero bands, so
    # the band above is slot i and the band below slot i + 2 on every rank
    slots = torch.cat([zero, all_gather_stack(edges, group), zero])
    return torch.cat([slots[i, 1], x, slots[i + 2, 0]], dim=2)
