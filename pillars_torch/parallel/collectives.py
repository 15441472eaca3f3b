"""The collectives of the parallel port, over ``torch.distributed`` process
groups, differentiable where a gradient flows through them.

- :func:`all_reduce_sum`: the sum over a group; its backward is the sum of
  the gradients over the group (train-mode BatchNorm statistics).
- :func:`all_gather_stack`: every rank's tensor, stacked; its backward sums
  the gradients over the group and hands each rank its own slot (the halo
  rows of the spatial RPN, which a neighbour consumes).
- :func:`gather_replicated`: the same forward, for a result that every rank
  of the group consumes in the same way (the spatial RPN's heads, whose
  loss is computed whole on every rank of a spatial group): the backward
  hands each rank its own slot of its own gradient, with no sum.
- :func:`all_reduce_flat`: one collective over a flat buffer of many
  tensors (the gradient leaves, the loss parts); not differentiable.

Every rank of a group calls the same collectives in the same order; the
backward keeps that order because every rank runs the same graph.

Backends. NCCL on cards, gloo on CPU processes, and gloo with CUDA tensors
for several ranks that share one card (NCCL refuses two ranks on one
device). Gloo takes CUDA tensors for every collective used here
(all_reduce, all_gather, broadcast, broadcast_object_list: checked on an
H100 with torch 2.11), copying them through host memory itself, so every
route here is the same call on every backend.

CUDA graphs (pillars_torch/cuda_graph.py). An NCCL collective is a kernel
(or a device copy) on the process group's stream, joined to the caller's
stream by events, and a graph captures it; a gloo collective copies through
host memory, which a graph cannot hold. :func:`graph_safe` says which
bodies may be captured. The differentiable collectives above make no host
sync and build no tensor from host data: their host values (the group's
size and this rank's index in it) are fixed for the group, and the output
lists of their all-gathers come from the caller's allocator (the graph's
pool during a capture).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def graph_safe(group) -> bool:
    """Whether a CUDA graph can hold a collective over ``group``: an NCCL
    group's, not gloo's."""
    return dist.get_backend(group) == "nccl"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward sums the gradients."""
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group = group
        ctx.reduce_grad = reduce_grad
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.reduce_grad:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None, None


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[group size, *x.shape]: every rank's ``x`` in rank order. The
    backward sums each slot's gradient over the group and returns this
    rank's slot: right where ranks consume other ranks' slots."""
    return _AllGather.apply(x, group, True)


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """As :func:`all_gather_stack`, for a result that every rank of the
    group turns into the same loss: the backward returns this rank's slot
    of its own gradient (summing would count the loss once per rank)."""
    return _AllGather.apply(x, group, False)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group,
                    scale: Optional[float] = None) -> List[torch.Tensor]:
    """``tensors`` summed over ``group`` in ONE collective over a flat
    buffer (in the dtype they share), times ``scale`` when given; returns
    new tensors of the same shapes."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale is not None:
        flat = flat * scale
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (same shape on every rank) concatenated along dim
    0 in rank order; not differentiable."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_(x: torch.Tensor, src_rank: int, group) -> torch.Tensor:
    """``x`` of the group's rank ``src_rank`` on every rank, in place."""
    dist.broadcast(x, dist.get_global_rank(group, src_rank), group=group)
    return x


def broadcast_object(obj, src_rank: int, group):
    """A picklable object of the group's rank ``src_rank`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(group, src_rank),
                               group=group)
    return box[0]
