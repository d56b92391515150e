"""Sequence-parallel training over a mesh: the port's ``sp`` half of
``ray_tpu/parallel``. The mesh and its process groups (``mesh``), the
collectives over a mesh axis (``collectives``), ring attention through the
stats kernel and Ulysses (``ring_attention``, ``ulysses``), and a step's
loss and gradients over a split batch (``training``)."""

from . import collectives
from .mesh import (AXES, Mesh, MeshSpec, data_axes, local_batch_size,
                   make_mesh, mesh_spec_from_string, shard_batch)
from .ring_attention import make_ring_attention, ring_attention
from .training import allreduce_grads, sharded_loss_fn
from .ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "AXES", "Mesh", "MeshSpec", "make_mesh", "mesh_spec_from_string",
    "data_axes", "local_batch_size", "shard_batch", "collectives",
    "ring_attention", "make_ring_attention", "ulysses_attention",
    "make_ulysses_attention", "sharded_loss_fn", "allreduce_grads",
]
