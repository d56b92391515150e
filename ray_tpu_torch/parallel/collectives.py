"""Collectives over a mesh axis's process group.

Port of the in-program tier of ``ray_tpu/parallel/collectives.py``. There
each function is traced inside ``shard_map`` and the "group" is a mesh axis
name; here each rank calls it eagerly, on its own tensor, and the axis
names the process group of a ``Mesh`` built over ``torch.distributed``
(``parallel/mesh.py``). Every rank of the group must make the same call.
A function returns a new tensor and leaves its input as it was, as the
JAX ones do. Over an axis of size 1 each is the identity (or index 0). A
one-device mesh has no groups, and a call on it raises.

Every call is counted in ``mesh.traffic`` (its calls and the bytes of
this rank's input). On a mesh built with gloo over CUDA tensors
(``mesh.host_staged``) each call copies its tensors to host buffers, runs
the gloo collective there and copies the result back to the card, and
counts ``"host_staged"``: the caller chose that route to put several ranks
on one card; the tensors, the kernels and the autograd graph stay on the
card.

``gather_param``, ``allreduce_fwd`` and ``allreduce_bwd`` carry a gradient
of their own, for FSDP and tensor parallelism (``parallel/sharding.py``);
``alltoall`` carries the exchange back as its gradient, for Ulysses and
the MoE's expert parallelism (``parallel/moe.py``); ``rotate`` carries the
hop back, for the ring's K/V and the pipeline's activations
(``parallel/ring_attention.py``, ``parallel/pipeline.py``).

The host tier, ``HostCollectiveGroup``, reduces small host arrays between
actors through the GCS's key-value store, as the reference's does.
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


def _wire(mesh: Mesh, name: str, x: torch.Tensor) -> torch.Tensor:
    """Count a call of collective ``name`` on ``x`` and return the buffer
    it runs on: ``x`` contiguous, or a copy in host memory on a
    host-staged mesh."""
    mesh.traffic[name] += 1
    mesh.traffic[name + "_bytes"] += x.numel() * x.element_size()
    if mesh.host_staged:
        mesh.traffic["host_staged"] += 1
        return x.to("cpu", memory_format=torch.contiguous_format)
    return x.contiguous()


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result ``buf`` on ``like``'s device."""
    return buf.to(like.device)


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
        buf = _wire(mesh, "allreduce", out)
        dist.all_reduce(buf, op=_OPS["sum" if op == "mean" else op],
                        group=group)
        out = _back(buf, x)
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
        buf = _wire(mesh, "allgather", x)
        parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, buf, group=group)
        parts = [_back(p, x) for p in parts]
    return (torch.cat if tiled else torch.stack)(parts, dim=gather_axis)


def reducescatter(x: torch.Tensor, mesh: Mesh, axis: str = "dp", *,
                  scatter_axis: int = 0) -> torch.Tensor:
    """Sum over the axis, then keep this rank's block of ``scatter_axis``
    (tiled: the axis is split into equal blocks)."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    buf = _wire(mesh, "reducescatter", x)
    parts = [c.contiguous() for c in
             buf.chunk(mesh.shape[axis], dim=scatter_axis)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return _back(out, x)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str = "dp",
              root: int = 0) -> torch.Tensor:
    """Every rank gets the value of index ``root`` along the axis."""
    group = mesh.group(axis)
    if group is None:
        return x.clone()
    buf = _wire(mesh, "broadcast", x.clone())
    dist.broadcast(buf, src=_peer(group, root), group=group)
    return _back(buf, x)


def alltoall(x: torch.Tensor, mesh: Mesh, axis: str = "sp", *,
             split_axis: int, concat_axis: int) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block j to rank
    j, and join the blocks received along ``concat_axis`` in rank order
    (JAX's tiled ``all_to_all``). Differentiable, as JAX's is: the
    gradient is the exchange back, split and join axes swapped (Ulysses'
    head/sequence exchanges and the MoE's dispatch and return)."""
    if mesh.group(axis) is None:
        return x.clone()
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _alltoall(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    group = mesh.group(axis)
    n = mesh.shape[axis]
    send = _wire(mesh, "alltoall", torch.stack(x.chunk(n, dim=split_axis)))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(_back(recv, x).unbind(0), dim=concat_axis)


def send_recv(x: torch.Tensor, mesh: Mesh, axis: str,
              pairs: List[tuple]) -> torch.Tensor:
    """Point to point along the axis: for each ``(src, dst)`` pair of axis
    indices, ``dst`` gets ``src``'s ``x``; a rank that no pair sends to
    gets zeros (JAX's ``ppermute``)."""
    group = mesh.group(axis)
    me = axis_index(mesh, axis)
    x = x.contiguous()
    sends = [d for s, d in pairs if s == me != d]
    recvs = [s for s, d in pairs if d == me != s]
    buf = _wire(mesh, "send_recv", x) if sends else x
    out = x.clone() if (me, me) in pairs else torch.zeros_like(x)
    into = out.cpu() if mesh.host_staged else out
    ops = [dist.P2POp(dist.isend, buf, _peer(group, d), group)
           for d in sends]
    ops += [dist.P2POp(dist.irecv, into, _peer(group, s), group)
            for s in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _back(into, x)


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


class _GatherParam(torch.autograd.Function):
    """FSDP's gather: ``allgather`` along ``dim`` in the forward, and in
    the backward the gradient reduce-scattered along ``dim``, so each rank
    keeps the sum over the axis of its own block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return allgather(x, mesh, axis, gather_axis=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return reducescatter(g, mesh, axis, scatter_axis=dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    """``alltoall``'s exchange; its gradient is the exchange back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _alltoall(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_alltoall(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


class _RingShift(torch.autograd.Function):
    """One hop forward along the axis's ring; its gradient is the hop
    back."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return permute(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return permute(g, *ctx.args, -1), None, None


def rotate(xs: List[torch.Tensor], mesh: Mesh,
           axis: str) -> List[torch.Tensor]:
    """One hop forward along the axis for the tensors of the ranks this
    process runs (``parallel.mesh.rank_shards``' convention): rank j's
    tensor goes to rank j + 1 and the last rank's to rank 0. Over a
    process group ``xs`` holds this rank's one tensor and the hop is
    ``permute`` with the hop back as its gradient; on a one-device mesh
    ``xs`` holds every rank's, and the hop is a turn of the list."""
    if mesh.distributed:
        return [_RingShift.apply(xs[0], mesh, axis)]
    return xs[-1:] + xs[:-1]


class _AllReduceFwd(torch.autograd.Function):
    """Megatron's g: the sum over the axis in the forward, the identity in
    the backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return allreduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceBwd(torch.autograd.Function):
    """Megatron's f: the identity in the forward, the sum over the axis in
    the backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g, *ctx.args), None, None


def gather_param(x: torch.Tensor, mesh: Mesh, axis: str,
                 dim: int) -> torch.Tensor:
    """The axis's blocks of ``x`` joined along ``dim`` in axis order; the
    gradient is reduce-scattered back to this rank's block."""
    if mesh.group(axis) is None:
        return x
    return _GatherParam.apply(x, mesh, axis, dim)


def allreduce_fwd(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the axis, with the identity as its gradient:
    the output of a row-parallel product, whose every rank then computes
    the same function of it."""
    if mesh.group(axis) is None:
        return x
    return _AllReduceFwd.apply(x, mesh, axis)


def allreduce_bwd(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` itself, with its gradient summed over the axis: the input of a
    column-parallel product, which each rank uses for its own columns."""
    if mesh.group(axis) is None:
        return x
    return _AllReduceBwd.apply(x, mesh, axis)


class HostCollectiveGroup:
    """CPU-side collectives between actors via the object store.

    The Gloo-tier analog (``gloo_collective_group.py``): rank 0 gathers,
    reduces with numpy, and publishes; other ranks poll a named KV slot.
    Only for small control-plane data (metrics, rendezvous info) — tensor
    traffic belongs in the mesh's process-group collectives above.
    """

    def __init__(self, group_name: str, world_size: int, rank: int):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._round = 0

    def _kv(self):
        from .._private.worker import global_worker

        return global_worker()

    def allreduce(self, arr, op: str = "sum", timeout: float = 60.0):
        import pickle
        import time

        import numpy as np

        w = self._kv()
        ns = f"col:{self.group_name}"
        key = f"r{self._round}:{self.rank}"
        w.kv_put(key, pickle.dumps(np.asarray(arr)), ns=ns)
        deadline = time.time() + timeout
        parts = {}
        while len(parts) < self.world_size:
            for r in range(self.world_size):
                if r in parts:
                    continue
                blob = w.kv_get(f"r{self._round}:{r}", ns=ns)
                if blob is not None:
                    parts[r] = pickle.loads(blob)
            if time.time() > deadline:
                raise TimeoutError(
                    f"allreduce timed out: {len(parts)}/{self.world_size}")
            if len(parts) < self.world_size:
                time.sleep(0.005)
        # Everyone finishing round r implies everyone has READ round r-1,
        # so our own r-1 slot can be garbage-collected (bounds KV growth;
        # a restarted member reusing the name then blocks loudly instead of
        # silently averaging stale data).
        if self._round > 0:
            w.kv_del(f"r{self._round - 1}:{self.rank}", ns=ns)
        self._round += 1
        stacked = np.stack([parts[r] for r in range(self.world_size)])
        if op == "sum":
            return stacked.sum(0)
        if op == "mean":
            return stacked.mean(0)
        if op == "max":
            return stacked.max(0)
        if op == "min":
            return stacked.min(0)
        raise ValueError(f"unsupported op {op!r}")

    def barrier(self, timeout: float = 60.0):
        self.allreduce([1.0], timeout=timeout)
