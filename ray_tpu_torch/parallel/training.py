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

from ..models.llama import (LlamaConfig, chunked_head_loss, forward,
                            forward_hidden, next_token_targets)
from ..ops.chunked_xent import IGNORE
from ..ops.layers import cross_entropy_loss
from .collectives import allreduce
from .mesh import BATCH_AXES, Mesh, shard_batch

#: The axes a batch is split over: its rows and its positions.
SPLIT_AXES = BATCH_AXES + ("sp",)


def sharded_loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
                    cfg: LlamaConfig, mesh: Mesh, attn_impl=None,
                    remat: bool = False,
                    chunked_vocab: int = 0) -> torch.Tensor:
    """This rank's share of the mean next-token loss of the global batch
    ``tokens`` [B, L]: the shares of all ranks sum to that mean.

    Targets are built on the global batch before it is sliced (a shard's
    last target is the next shard's first token), RoPE sees global
    positions, and the rank's mean is rescaled by its count of targets
    over the count of all ranks' targets: the last shard of each row holds
    one ignored target, so averaging local means would weigh it wrongly.
    ``attn_impl`` must attend across the ``sp`` shards (a ring or Ulysses
    attention over ``mesh``). ``remat`` and ``chunked_vocab`` are
    ``models.llama.loss_fn``'s: each layer recomputed in the backward, and
    the vocab streamed in chunks of that size on this rank's rows. On a
    one-device mesh the ranks run in lockstep inside ``attn_impl`` and the
    share is the whole loss. The backward of the share gives this rank's
    part of each gradient; ``allreduce_grads`` sums them."""
    if mesh.shape["tp"] > 1 or mesh.shape["pp"] > 1:
        raise NotImplementedError("tp and pp meshes are not ported yet")
    tok = shard_batch(mesh, tokens)
    tgt = shard_batch(mesh, next_token_targets(tokens))
    seq_offset = mesh.coords["sp"] * tok.shape[1] if mesh.distributed else 0
    if chunked_vocab > 0:
        x = forward_hidden(params, tok, cfg, remat=remat,
                           attn_impl=attn_impl, seq_offset=seq_offset)
        loss = chunked_head_loss(params, x, tgt, cfg, chunked_vocab)
        n = (tgt != IGNORE).sum().float()
    else:
        logits = forward(params, tok, cfg, remat=remat, attn_impl=attn_impl,
                         seq_offset=seq_offset)
        loss, n = cross_entropy_loss(logits, tgt)
    if not mesh.distributed:
        return loss  # every rank lives here: the share is the whole mean
    return loss * (n / allreduce(n, mesh, SPLIT_AXES))


def allreduce_grads(leaves: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Sum each leaf's ``.grad`` over the ranks that split the batch, so
    every rank holds the global batch's gradient."""
    for t in leaves:
        if t.grad is not None:
            t.grad = allreduce(t.grad, mesh, SPLIT_AXES)
