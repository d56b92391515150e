"""Ulysses (DeepSpeed-style) sequence parallelism by all-to-all.

Port of ``ray_tpu/parallel/ulysses.py``. Where the ring keeps heads local
and rotates K/V, Ulysses exchanges activations so that each ``sp`` rank
holds every position for 1/sp of the heads, runs the whole sequence's
attention locally (the port's ``flash_attention``: the K1/K2 kernels on
CUDA), and exchanges back.

GQA: when ``n_kv_heads % sp == 0`` the head blocks stay aligned through
the exchange, so K/V move at their true kv-head count and the local
attention groups them itself (the kernels are GQA-aware; the JAX package
repeats them after the exchange). Otherwise K/V are repeated to the query
heads before the exchange, which costs the group factor in bytes.

Ranks run as in ``ring_attention``: over a process group each passes its
own shards and the exchange is ``all_to_all_single`` over the axis group;
on a one-device mesh the ranks run in lockstep on a list of shards.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..ops.attention import flash_attention
from . import collectives
from .mesh import Mesh, rank_shards
from .ring_attention import check_axes


def _all_to_all(xs: List[torch.Tensor], mesh: Mesh, axis: str, *,
                split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """Every exchange goes through this seam, so tests can count the bytes
    that travel. ``xs`` holds one tensor per rank this process runs; rank
    j gets block j of every rank's ``split_axis``, joined in rank order
    along ``concat_axis``."""
    if mesh.distributed:
        return [collectives.alltoall(xs[0], mesh, axis, split_axis=split_axis,
                                     concat_axis=concat_axis)]
    blocks = [x.chunk(len(xs), dim=split_axis) for x in xs]
    return [torch.cat([b[j] for b in blocks], dim=concat_axis)
            for j in range(len(xs))]


def _seq_to_heads(xs, mesh: Mesh, axis: str):
    """[B, L/n, H, D] -> [B, L, H/n, D] over the sp ranks."""
    return _all_to_all(xs, mesh, axis, split_axis=2, concat_axis=1)


def _heads_to_seq(xs, mesh: Mesh, axis: str):
    """[B, L, H/n, D] -> [B, L/n, H, D]."""
    return _all_to_all(xs, mesh, axis, split_axis=1, concat_axis=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis: str = "sp", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention by head/sequence all-to-all.

    Inputs as ``ring_attention``'s: this rank's shards [B, L / n, H, D] on
    a process-group mesh, the global [B, L, H, D] on a one-device mesh.
    H must divide by the sp degree. The local attention is
    ``flash_attention``."""
    n = mesh.shape[axis]
    H, Hkv = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(f"{H} query heads do not split over {axis}={n}")
    _, qs, ks, vs = rank_shards(mesh, axis, q, k, v)
    if Hkv % n:
        # Misaligned head blocks: repeat before the exchange (pays the
        # group factor on the wire, but always correct).
        ks = [t.repeat_interleave(H // Hkv, dim=2) for t in ks]
        vs = [t.repeat_interleave(H // Hkv, dim=2) for t in vs]
    qh, kh, vh = (_seq_to_heads(t, mesh, axis) for t in (qs, ks, vs))
    outs = [flash_attention(a, b, c, causal=causal, scale=scale)
            for a, b, c in zip(qh, kh, vh)]
    return torch.cat(_heads_to_seq(outs, mesh, axis), dim=1)


def make_ulysses_attention(mesh: Mesh, *, causal: bool = True,
                           axis: str = "sp", batch_axes=("dp", "fsdp")):
    """Ulysses over ``mesh``'s ``axis`` as an ``attn_impl`` for
    ``models.llama``, with the inputs ``make_ring_attention``'s function
    takes: global tensors on a one-device mesh, this rank's shards on a
    process-group mesh, its rows of the batch over ``batch_axes``. Where
    the model splits heads over ``tp`` a rank passes its own heads and the
    exchange runs on them; JAX's spec leaves heads whole, so there every
    tp rank computes every head, to the same result."""

    def attend(q, k, v, causal: bool = causal,
               scale: Optional[float] = None):
        check_axes(mesh, q, k, batch_axes, None)
        return ulysses_attention(q, k, v, mesh, axis=axis, causal=causal,
                                 scale=scale)

    return attend
