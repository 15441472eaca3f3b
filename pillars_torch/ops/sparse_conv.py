"""Sparse 3D convolutions for the SECOND voxel middle extractor
(pillars_tpu/ops/sparse_conv.py).

Active voxels live in a sorted, statically padded key array per sample
(``key = (z*ny + y)*nx + x``; the valid rows are a prefix, padding rows
carry the sentinel ``n_cells``), the layout the voxelizers emit. A rulebook
``nbr [V_out, K]`` names, for every output row and kernel tap, the input row
at ``stride*o - pad + tap`` (``V`` on a miss or for a padding row), and a
conv is one gather plus one matmul over it (:func:`gather_conv`).

The JAX package finds neighbours with sort-merges (tag-bit sorts, scans,
sorts back), because a binary search is slow on a TPU. Here every lookup is
``torch.searchsorted`` over the sorted key array, which is the exact lookup
on a GPU and on the CPU: the rulebooks are the same integers. Every function
takes a leading batch axis (``keys [B, V]``) and keeps its shapes static:
no ``unique``, ``nonzero`` or boolean-mask indexing, so the host never waits
for the card.

Strided convs take their output active set from the inputs: a cell is
active iff its window holds an active input (second.pytorch SparseConv3d).
The set is capped at ``max_active`` rows; past the cap the LOWEST keys win,
the one place the sparse path can drop data.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def conv_out_dim(n: int, k: int, s: int, p: int) -> int:
    """Standard conv output size (second.pytorch SparseConv3d formula)."""
    return (n + 2 * p - k) // s + 1


def kernel_offsets(kernel: Sequence[int]) -> np.ndarray:
    """[K, 3] (dz, dy, dx) tap offsets in z-major scan order."""
    kz, ky, kx = kernel
    return np.stack(np.meshgrid(np.arange(kz), np.arange(ky),
                                np.arange(kx), indexing="ij"),
                    axis=-1).reshape(-1, 3)


def _decompose(keys: torch.Tensor, dims: Tuple[int, int, int]):
    _, ny, nx = dims
    z = torch.div(keys, ny * nx, rounding_mode="floor")
    rem = keys - z * (ny * nx)
    y = torch.div(rem, nx, rounding_mode="floor")
    return z, y, rem - y * nx


def match_sorted(keys: torch.Tensor, valid: torch.Tensor,
                 qkeys: torch.Tensor, qvalid: torch.Tensor,
                 n_cells: int) -> torch.Tensor:
    """For each query key [..., M], the row of ``keys`` [..., V] holding that
    key, else V (int64). The valid rows of ``keys`` are a prefix, ascending
    and unique (the voxelizer layout); invalid queries and keys outside the
    grid never match."""
    V = keys.shape[-1]
    src = torch.where(valid, keys, torch.full_like(keys, n_cells))
    q = torch.where(qvalid, qkeys, torch.full_like(qkeys, n_cells))
    pos = torch.searchsorted(src.contiguous(), q.contiguous())
    found = torch.gather(src, -1, pos.clamp_max(V - 1))
    hit = qvalid & (q < n_cells) & (pos < V) & (found == q)
    return torch.where(hit, pos, torch.full_like(pos, V))


def _lookup(keys, valid, dims, zz, yy, xx, qvalid):
    """Rulebook [..., Vq, K] of query positions [..., Vq, K] in ``dims``;
    positions outside the grid miss (the key arithmetic would wrap rows)."""
    nz, ny, nx = dims
    inb = (qvalid & (zz >= 0) & (zz < nz) & (yy >= 0) & (yy < ny)
           & (xx >= 0) & (xx < nx))
    q = (zz * ny + yy) * nx + xx
    shape = q.shape
    res = match_sorted(keys, valid, q.flatten(-2), inb.flatten(-2),
                       nz * ny * nx)
    return res.reshape(shape)


def _offsets(kernel, device):
    """(dz, dy, dx) [K] of :func:`kernel_offsets`, made on ``device``: a
    copy from the host would make the host wait for the card."""
    _, ky, kx = kernel
    t = torch.arange(int(np.prod(kernel)), device=device)
    return t // (ky * kx), (t // kx) % ky, t % kx


def neighbor_indices(keys: torch.Tensor, valid: torch.Tensor,
                     dims: Tuple[int, int, int],
                     kernel: Sequence[int]) -> torch.Tensor:
    """Submanifold rulebook [..., V, K]: the input row of the neighbour at
    ``p - pad + tap`` for every active voxel p (V on a miss or a padding
    row), pad = (k-1)//2 per dim, so the centre tap is the voxel itself."""
    keys = keys.long()
    z, y, x = _decompose(keys, dims)
    dz, dy, dx = _offsets(kernel, keys.device)
    pz, py, px = ((k - 1) // 2 for k in kernel)
    return _lookup(keys, valid, dims, z[..., None] + (dz - pz),
                   y[..., None] + (dy - py), x[..., None] + (dx - px),
                   valid[..., None])


def downsample_active_set(keys: torch.Tensor, valid: torch.Tensor,
                          dims: Tuple[int, int, int],
                          kernel: Sequence[int], stride: Sequence[int],
                          padding: Sequence[int], max_active: int):
    """Active output cells of a strided sparse conv, sorted and unique:
    (out_keys [..., max_active] int64, out_valid, odims), sentinel
    ``prod(odims)`` on padding rows.

    A cell o is active iff an active input lies in its window ``stride*o -
    pad + [0, k)``. Each input proposes the outputs of its per-dim window
    (``ceil((c-p)/s) .. floor((c+p)/s)``; needs pad (k-1)//2 and k in {1,
    3}); one sort, first-of-run dedup and a second sort compact them."""
    odims = tuple(conv_out_dim(n, k, s, p) for n, k, s, p in
                  zip(dims, kernel, stride, padding))
    for k, p in zip(kernel, padding):
        assert p == (k - 1) // 2 and k in (1, 3), (
            "candidate enumeration assumes k in {1,3}, pad (k-1)//2")
    keys = keys.long()

    def dim_cands(c, k, s, odim):
        """[(o_j, valid_j)] covering every output whose window holds c."""
        if k == 3:
            start = torch.div(c + s - 2, s, rounding_mode="floor")
            end = torch.div(c + 1, s, rounding_mode="floor")
            n = 2 // s + 1
        else:  # k == 1: only the exactly divisible output
            start = torch.div(c, s, rounding_mode="floor")
            end = torch.where(c == start * s, start, start - 1)
            n = 1
        return [(start + j, (start + j <= end) & (start + j >= 0)
                 & (start + j < odim)) for j in range(n)]

    onz, ony, onx = odims
    n_ocells = onz * ony * onx
    z, y, x = _decompose(keys, dims)
    cand, cval = [], []
    for oz, vz in dim_cands(z, kernel[0], stride[0], onz):
        for oy, vy in dim_cands(y, kernel[1], stride[1], ony):
            for ox, vx in dim_cands(x, kernel[2], stride[2], onx):
                cand.append((oz * ony + oy) * onx + ox)
                cval.append(vz & vy & vx & valid)
    ckeys = torch.where(torch.cat(cval, -1), torch.cat(cand, -1),
                        torch.full_like(keys[..., :1], n_ocells))
    ckeys = torch.sort(ckeys, dim=-1).values
    first = torch.cat([torch.ones_like(ckeys[..., :1], dtype=torch.bool),
                       ckeys[..., 1:] != ckeys[..., :-1]], -1)
    uniq = torch.where(first & (ckeys < n_ocells), ckeys,
                       torch.full_like(ckeys, n_ocells))
    uniq = torch.sort(uniq, dim=-1).values  # distinct keys to the front
    short = max_active - uniq.shape[-1]
    if short > 0:  # cap above the candidate count: pad with the sentinel
        uniq = torch.cat([uniq, torch.full(uniq.shape[:-1] + (short,),
                                           n_ocells, dtype=uniq.dtype,
                                           device=uniq.device)], -1)
    out_keys = uniq[..., :max_active]
    return out_keys, out_keys < n_ocells, odims


def strided_rulebook(keys: torch.Tensor, valid: torch.Tensor,
                     out_keys: torch.Tensor, out_valid: torch.Tensor,
                     dims: Tuple[int, int, int],
                     odims: Tuple[int, int, int],
                     kernel: Sequence[int], stride: Sequence[int],
                     padding: Sequence[int]) -> torch.Tensor:
    """[..., V_out, K] input row feeding output cell o at tap t: input
    position ``stride*o - pad + tap`` (V on a miss)."""
    oz, oy, ox = _decompose(out_keys.long(), odims)
    dz, dy, dx = _offsets(kernel, out_keys.device)
    return _lookup(keys.long(), valid, dims,
                   oz[..., None] * stride[0] - padding[0] + dz,
                   oy[..., None] * stride[1] - padding[1] + dy,
                   ox[..., None] * stride[2] - padding[2] + dx,
                   out_valid[..., None])


def gather_conv(features: torch.Tensor, nbr: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Sparse conv compute: ``out[v] = sum_k feats[nbr[v, k]] @ W[k]``.

    features [V, Cin], nbr [Vo, K] with sentinel V, weights [K, Cin, Cout].
    One zero guard row makes the sentinel inert; the K gathered rows of an
    output lie side by side, so the taps contract in one matmul."""
    V, cin = features.shape
    K, _, cout = weights.shape
    ext = torch.cat([features, features.new_zeros((1, cin))])
    g = ext[nbr.long()].reshape(nbr.shape[0], K * cin)
    return g @ weights.reshape(K * cin, cout)
