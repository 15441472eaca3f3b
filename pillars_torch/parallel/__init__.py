"""Distributed execution over process groups (pillars_tpu/parallel/): one
process per device (``launch``), a mesh of named axes over them
(``mesh``), data parallelism over the batch and BEV-grid spatial
parallelism over the canvas rows (``spatial``), and the collectives
between them (``collectives``).

A global-batch step gives the result of the same step on one device: the
train-mode BatchNorms reduce their statistics over the ranks that hold the
batch (models/layers.py), and the gradients are reduced once per step
(train/loop.py).
"""

from pillars_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    make_mesh_2d,
    replicated_sharding,
    shard_batch,
)
