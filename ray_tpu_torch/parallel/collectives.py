"""Collectives over a mesh axis's process group.

Port of the in-program tier of ``ray_tpu/parallel/collectives.py``. There
each function is traced inside ``shard_map`` and the "group" is a mesh axis
name; here each rank calls it eagerly, on its own tensor, and the axis
names the process group of a ``Mesh`` built over ``torch.distributed``
(``parallel/mesh.py``). Every rank of the group must make the same call.
A function returns a new tensor and leaves its input as it was, as the
JAX ones do. Over an axis of size 1 each is the identity (or index 0). A
one-device mesh has no groups, and a call on it raises.

The host tier (``HostCollectiveGroup``, reductions between actors through
the object store) belongs to the runtime tier and is not ported here.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh

AxisName = Union[str, Sequence[str]]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _peer(group, i: int) -> int:
    """The global rank of index ``i`` in ``group``."""
    return dist.get_global_rank(group, i)


def allreduce(x: torch.Tensor, mesh: Mesh, axis: AxisName = "dp",
              op: str = "sum") -> torch.Tensor:
    """All-reduce over an axis, or over several in turn (``sum``, ``mean``,
    ``max``, ``min``)."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported op {op!r}")
    out = x.clone()
    for a in ((axis,) if isinstance(axis, str) else axis):
        group = mesh.group(a)
        if group is None:
            continue
        dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op],
                        group=group)
        if op == "mean":
            out /= mesh.shape[a]
    return out


def allgather(x: torch.Tensor, mesh: Mesh, axis: str = "dp", *,
              tiled: bool = True, gather_axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` in axis order, joined along ``gather_axis``
    (``tiled``) or stacked in a new one there."""
    group = mesh.group(axis)
    if group is None:
        parts = [x]
    else:
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x, group=group)
    return (torch.cat if tiled else torch.stack)(parts, dim=gather_axis)


def reducescatter(x: torch.Tensor, mesh: Mesh, axis: str = "dp", *,
                  scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the axis, then keep this rank's block of ``scatter_axis``
    (tiled: the axis is split into equal blocks)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    parts = [c.contiguous() for c in
             x.chunk(mesh.shape[axis], dim=scatter_axis)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str = "dp",
              root: int = 0) -> torch.Tensor:
    """Every rank gets the value of index ``root`` along the axis."""
    group = mesh.group(axis)
    out = x.clone().contiguous()
    if group is not None:
        dist.broadcast(out, src=_peer(group, root), group=group)
    return out


def alltoall(x: torch.Tensor, mesh: Mesh, axis: str = "sp", *,
             split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block j to rank
    j, and join the blocks received along ``concat_axis`` in rank order
    (JAX's tiled ``all_to_all``)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    n = mesh.shape[axis]
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def send_recv(x: torch.Tensor, mesh: Mesh, axis: str,
              pairs: List[tuple]) -> torch.Tensor:
    """Point to point along the axis: for each ``(src, dst)`` pair of axis
    indices, ``dst`` gets ``src``'s ``x``; a rank that no pair sends to
    gets zeros (JAX's ``ppermute``)."""
    group = mesh.group(axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    out = x.clone() if (me, me) in pairs else torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, _peer(group, d), group)
           for s, d in pairs if s == me != d]
    ops += [dist.P2POp(dist.irecv, out, _peer(group, s), group)
            for s, d in pairs if d == me != s]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def permute(x: torch.Tensor, mesh: Mesh, axis: str,
            shift: int = 1) -> torch.Tensor:
    """Ring shift by ``shift`` along the axis: index i gets index
    ``i - shift``'s ``x``."""
    n = mesh.shape[axis]
    return send_recv(x, mesh, axis, [(i, (i + shift) % n) for i in range(n)])


def axis_index(mesh: Mesh, axis: str) -> int:
    """This rank's index along the axis."""
    mesh.group(axis)  # raises on a one-device mesh
    return mesh.coords[axis]


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]
