"""The port's device mesh: axis sizes, this rank's coordinates and one
process group per axis.

Port of ``ray_tpu/parallel/mesh.py``. ``AXES``, ``MeshSpec``,
``mesh_spec_from_string``, ``data_axes`` and ``local_batch_size`` are
copies of that module's JAX-free code. JAX's ``Mesh`` is a grid of devices
that one program spans; here each rank runs its own program, so a mesh
says where this rank sits and which process group joins it to the ranks
beside it along each axis.

Two kinds of mesh:
  * with ``torch.distributed`` initialised, the world's ranks fill the
    mesh in JAX's axis order (rank r sits where ``jax.devices()[r]`` sits
    in ``make_mesh``'s reshape), and every axis of size > 1 gets a group
    over the ranks that differ only along it. The groups' backend follows
    the device (NCCL for CUDA, gloo for the CPU) unless the caller names
    one: gloo on CUDA puts several ranks on one card, and the collectives
    then stage each tensor through host memory (``host_staged``).
  * with no process group, all of the mesh's ranks live on one device and
    run in lockstep, inside the attention that needs them (the ring's and
    Ulysses' ``sp`` ranks): the counterpart of the JAX package running an
    ``sp`` mesh on virtual devices of one host. Such a mesh takes global
    tensors.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

AXES = ("dp", "fsdp", "ep", "pp", "sp", "tp")
#: The axes the batch is split over, major to minor (JAX's
#: ``batch_sharding``: ``P(("dp", "fsdp", "ep"), "sp")``).
BATCH_AXES = ("dp", "fsdp", "ep")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout; ``-1`` on one axis means "the rest"."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {sizes} = {fixed} devices but {n_devices} present")
        return MeshSpec(**sizes)

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes().values())


def mesh_spec_from_string(s: str, n_devices: Optional[int] = None) -> MeshSpec:
    """Parse "dp=2,tp=4" style strings (CLI/config-friendly)."""
    sizes: Dict[str, int] = {}
    if s:
        for part in s.split(","):
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in AXES:
                raise ValueError(f"unknown mesh axis {k!r}; valid: {AXES}")
            sizes[k] = int(v)
    spec = MeshSpec(**sizes)
    if n_devices is not None:
        spec = spec.resolve(n_devices)
    return spec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A resolved layout on ``device``. On a process-group mesh ``coords``
    holds this rank's index along each axis, ``groups`` a process group
    for each axis of size > 1 and ``backend`` their backend; on a
    one-device mesh all are empty. ``traffic`` counts what this rank's
    collectives over the mesh carried (``parallel.collectives``): per
    collective its calls and the bytes of this rank's input
    (``"<name>_bytes"``), and ``"host_staged"`` the calls that went
    through host memory."""

    spec: MeshSpec
    device: torch.device
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    groups: Dict[str, "dist.ProcessGroup"] = dataclasses.field(
        default_factory=dict)
    backend: str = ""
    traffic: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.sizes()

    @property
    def distributed(self) -> bool:
        return bool(self.coords)

    @property
    def host_staged(self) -> bool:
        """Whether collectives copy through host memory: gloo groups over
        CUDA tensors, which gloo does not take for every collective (its
        send and receive abort the process on a device pointer)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def group(self, axis: str):
        """The process group of ``axis``; None where the axis has size 1.
        A one-device mesh has none and raises."""
        if not self.distributed:
            raise ValueError("a one-device mesh has no process groups")
        return self.groups.get(axis)


def make_mesh(spec: Optional[MeshSpec] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """Build the mesh for ``spec`` on ``device`` (CUDA unless the caller
    names another).

    With ``torch.distributed`` initialised the spec is resolved against
    the world size, and every rank must call this with the same spec: each
    group is created by all ranks, in the same order. The groups' backend
    is ``backend``, or NCCL for CUDA and gloo for the CPU; ``"gloo"`` on
    CUDA lets several ranks share one card, their collectives staged
    through host memory. Without ``torch.distributed`` the spec must name
    every size (no ``-1``), and the mesh's ranks share ``device``."""
    device = resolve_device(device)
    spec = spec or MeshSpec()
    if not (dist.is_available() and dist.is_initialized()):
        if -1 in spec.sizes().values():
            raise ValueError("a one-device mesh needs every axis size; -1 "
                             "resolves only against a process group")
        return Mesh(spec.resolve(spec.n_devices), device)
    world, rank = dist.get_world_size(), dist.get_rank()
    spec = spec.resolve(world)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    grid = np.arange(world).reshape([spec.sizes()[a] for a in AXES])
    coords = dict(zip(AXES, (int(i) for i in
                             np.unravel_index(rank, grid.shape))))
    groups = {}
    for i, axis in enumerate(AXES):
        n = grid.shape[i]
        if n == 1:
            continue
        for ranks in np.moveaxis(grid, i, -1).reshape(-1, n).tolist():
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[axis] = group
    return Mesh(spec, device, coords, groups, backend)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if mesh.shape[a] > 1)


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = math.prod(mesh.shape[a] for a in BATCH_AXES)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel degree {n}")
    return global_batch // n


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's ``[B / (dp·fsdp·ep), L / sp]`` slice of a global batch
    ``x`` [B, L, ...]: the eager counterpart of ``batch_sharding``, whose
    ``P(("dp", "fsdp", "ep"), "sp")`` gives each rank a contiguous block of
    rows and of positions. A one-device mesh's ranks all live here, so it
    returns ``x`` whole."""
    if not mesh.distributed:
        return x
    rows = local_batch_size(mesh, x.shape[0])
    sp = mesh.shape["sp"]
    if x.shape[1] % sp:
        raise ValueError(f"sequence length {x.shape[1]} not divisible by "
                         f"sp={sp}")
    cols = x.shape[1] // sp
    b = 0
    for a in BATCH_AXES:
        b = b * mesh.shape[a] + mesh.coords[a]
    s = mesh.coords["sp"]
    return x[b * rows:(b + 1) * rows, s * cols:(s + 1) * cols]


def rank_shards(mesh: Mesh, axis: str, *ts: torch.Tensor):
    """The ``axis`` ranks this process runs and each tensor's shard for
    each of them, as ``(ranks, [shards of ts[0]], [shards of ts[1]], ...)``.
    On a process-group mesh: this rank's index, and the tensors as they
    are (each already this rank's shard). On a one-device mesh: every
    index, each tensor cut into that many contiguous blocks along dim 1."""
    n = mesh.shape[axis]
    if mesh.distributed:
        return ([mesh.coords[axis]],) + tuple([t] for t in ts)
    for t in ts:
        if t.shape[1] % n:
            raise ValueError(f"dim 1 of {tuple(t.shape)} is not divisible by "
                             f"{axis}={n}")
    return (list(range(n)),) + tuple(list(t.chunk(n, dim=1)) for t in ts)
