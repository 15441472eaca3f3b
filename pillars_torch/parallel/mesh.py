"""The device mesh over process groups (pillars_tpu/parallel/mesh.py).

The JAX package runs one process over N devices and lets XLA partition one
program over a ``jax.sharding.Mesh``. The port runs one process per device
(``parallel/launch.py``); a :class:`Mesh` is that process's view of the
world: its rank, the axis names and sizes, its index on each axis and one
process group per axis (the ranks that differ only on that axis). Ranks map
onto the mesh in row-major order, as ``np.reshape`` lays devices out.

A mesh covers the whole world: no entry point shrinks it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """``shape``: axis name -> size, in mesh order; their product must be
    the world size. Every rank builds the same mesh (group creation is
    collective)."""

    def __init__(self, shape: Sequence[Tuple[str, int]]):
        if not dist.is_initialized():
            raise RuntimeError(
                "a Mesh needs an initialized process group: start the ranks "
                "with pillars_torch.parallel.launch")
        self.axis_names = tuple(name for name, _ in shape)
        self.shape = {name: int(n) for name, n in shape}
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        size = int(np.prod([n for _, n in shape]))
        if size != self.world_size:
            raise ValueError(
                f"a mesh of {dict(self.shape)} needs {size} ranks; the world "
                f"has {self.world_size}")
        ranks = np.arange(self.world_size).reshape(
            [self.shape[a] for a in self.axis_names])
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(self.rank, ranks.shape))))
        self._groups: Dict[str, object] = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:  # every rank creates every group, in order
                line = [int(r) for r in line]
                group = (dist.group.WORLD if len(line) == self.world_size
                         else dist.new_group(line))
                if self.rank in line:
                    self._groups[axis] = group

    @property
    def size(self) -> int:
        return self.world_size

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: Optional[str] = None):
        """The process group of ``axis`` (None: every rank), or None when
        the mesh has no such axis."""
        if axis is None:
            return dist.group.WORLD
        return self._groups.get(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(num_devices: int = 0, axis_name: str = "data") -> Mesh:
    """1-D mesh over every rank (``num_devices`` 0, or the world size)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices and num_devices != world:
        raise ValueError(
            f"runtime.num_devices={num_devices} needs {num_devices} ranks; "
            f"this process group has {world}: start them with "
            f"pillars_torch.parallel.launch (pillars-torch train and "
            f"evaluate do)")
    return Mesh([(axis_name, num_devices or world)])


def make_mesh_2d(data: int, spatial: int,
                 axis_names: Sequence[str] = ("data", "spatial")) -> Mesh:
    """2-D mesh composing batch data-parallelism with BEV-grid spatial
    parallelism (parallel/spatial.py): the batch splits over axis 0, the
    canvas rows over axis 1."""
    return Mesh([(axis_names[0], data), (axis_names[1], spatial)])


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: its leading (batch) dimension split
    into contiguous blocks over ``axis`` in rank order, or, with ``axis``
    None, whole on every rank."""

    mesh: Mesh
    axis: Optional[str]

    def local(self, x):
        """This rank's block of ``x`` (an array or a tensor)."""
        if self.axis is None:
            return x
        n = self.mesh.axis_size(self.axis)
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} ranks "
                             f"of the {self.axis!r} axis")
        i = self.mesh.axis_index(self.axis)
        return x[i * (b // n):(i + 1) * (b // n)]


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> Sharding:
    """Split the leading (batch) dimension over ``axis_name``."""
    return Sharding(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's block of every array or tensor leaf of ``batch`` (a dict
    of them, or one): contiguous blocks in rank order, the layout
    ``P(axis_name)`` gives in the JAX package. Other leaves pass as they
    are."""
    sh = batch_sharding(mesh, axis_name)

    def one(x):
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            return sh.local(x)
        return x

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
