"""The loss and gradients of a step whose batch is split over a
process-group mesh.

JAX's ``loss_fn`` over sharded arrays is one global program: its mean is
the global mean and ``jax.grad`` sums each replicated parameter's
gradient over the ranks. Here each rank runs its own program on its
shard, so both are made explicit. Parameters are replicated on every
rank (FSDP/TP sharding is not ported yet).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

from ..models.llama import LlamaConfig, forward, next_token_targets
from ..ops.layers import cross_entropy_loss
from .collectives import allreduce
from .mesh import BATCH_AXES, Mesh, shard_batch

#: The axes a batch is split over: its rows and its positions.
SPLIT_AXES = BATCH_AXES + ("sp",)


def sharded_loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
                    cfg: LlamaConfig, mesh: Mesh,
                    attn_impl=None) -> torch.Tensor:
    """This rank's share of the mean next-token loss of the global batch
    ``tokens`` [B, L]: the shares of all ranks sum to that mean.

    Targets are built on the global batch before it is sliced (a shard's
    last target is the next shard's first token), RoPE sees global
    positions, and the rank's summed token losses are divided by the
    count of all ranks' targets: the last shard of each row holds one
    ignored target, so averaging local means would weigh it wrongly.
    ``attn_impl`` must attend across the ``sp`` shards (a ring or Ulysses
    attention over ``mesh``). The backward of the share gives this rank's
    part of each gradient; ``allreduce_grads`` sums them."""
    if mesh.shape["tp"] > 1 or mesh.shape["pp"] > 1:
        raise NotImplementedError("tp and pp meshes are not ported yet")
    tok = shard_batch(mesh, tokens)
    tgt = shard_batch(mesh, next_token_targets(tokens))
    logits = forward(params, tok, cfg, remat=False, attn_impl=attn_impl,
                     seq_offset=mesh.coords["sp"] * tok.shape[1])
    loss, n = cross_entropy_loss(logits, tgt)
    return loss * (n / allreduce(n, mesh, SPLIT_AXES))


def allreduce_grads(leaves: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum each leaf's ``.grad`` over the ranks that split the batch, so
    every rank holds the global batch's gradient."""
    for t in leaves:
        if t.grad is not None:
            t.grad = allreduce(t.grad, mesh, SPLIT_AXES)
