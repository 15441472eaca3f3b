"""Pillar features -> dense BEV canvas (pillars_tpu/ops/scatter.py), NHWC.

ADD semantics are load-bearing: the d435i grid has two z-layers, so two
pillars can map to the same (y, x) canvas cell; the reference's
tf.scatter_nd sums them (reference model/pointpillars.py:285-341), and so
does this scatter. Padding pillars are dropped.
"""

from __future__ import annotations

import torch


def scatter_to_canvas_batched(features: torch.Tensor, coords: torch.Tensor,
                              pillar_mask: torch.Tensor, ny: int, nx: int
                              ) -> torch.Tensor:
    """[B, P, C] features + [B, P, 3] (z, y, x) coords + [B, P] mask ->
    [B, ny, nx, C] canvas."""
    b, _, c = features.shape
    feats = torch.where(pillar_mask[..., None], features,
                        torch.zeros_like(features))
    flat = coords[..., 1].long() * nx + coords[..., 2].long()
    # padding pillars go to one spare row past the canvas, then are cut
    flat = torch.where(pillar_mask, flat, torch.full_like(flat, ny * nx))
    canvas = torch.zeros((b, ny * nx + 1, c), dtype=features.dtype,
                         device=features.device)
    canvas.scatter_add_(1, flat[..., None].expand(-1, -1, c), feats)
    return canvas[:, :ny * nx].reshape(b, ny, nx, c)


def scatter_to_canvas(features: torch.Tensor, coords: torch.Tensor,
                      pillar_mask: torch.Tensor, ny: int, nx: int
                      ) -> torch.Tensor:
    """[P, C] features + [P, 3] (z, y, x) coords -> [ny, nx, C] canvas."""
    return scatter_to_canvas_batched(features[None], coords[None],
                                     pillar_mask[None], ny, nx)[0]
