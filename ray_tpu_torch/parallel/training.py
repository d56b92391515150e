"""The loss and gradients of a step over a process-group mesh: the batch
split over ``dp``, ``fsdp``, ``ep`` and ``sp``, the parameters sharded over
``fsdp`` and ``tp`` as their specs say (``parallel/sharding.py``), and a
Mixtral's experts over ``ep`` (``models.mixtral.sharded_forward``).

JAX's ``loss_fn`` over sharded arrays is one global program: its mean is
the global mean and ``jax.grad`` gives each parameter's whole gradient.
Here each rank runs its own program on its shard, so both are made
explicit: each rank's loss is its share of the global mean, the FSDP
gathers reduce-scatter their gradients over ``fsdp`` in the backward, and
``allreduce_grads`` sums the rest over the batch axes.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..models.llama import LlamaConfig, chunked_head_loss
from ..models.llama import forward as llama_forward
from ..models.llama import forward_hidden, next_token_targets
from ..ops.chunked_xent import IGNORE
from ..ops.layers import cross_entropy_loss
from .collectives import allreduce
from .mesh import AXES, BATCH_AXES, Mesh, shard_batch
from .sharding import Placement, spec_axes, tree_paths

#: The axes a batch is split over: its rows and its positions.
SPLIT_AXES = BATCH_AXES + ("sp",)


def sharded_loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
                    cfg: LlamaConfig, mesh: Mesh, attn_impl=None,
                    remat: bool = False, chunked_vocab: int = 0,
                    specs: Any = None, forward=None) -> torch.Tensor:
    """This rank's share of the mean next-token loss of the global batch
    ``tokens`` [B, L]: the shares of the ranks that split the batch sum to
    that mean, and ranks that differ only along ``tp`` hold the same share.

    ``params`` are this rank's shards of the tree (``shard_params``) under
    ``specs`` (``shardings_for_tree`` of the global tree), or, with no
    ``specs``, the whole tree on every rank. Targets are built on the
    global batch before it is sliced (a shard's last target is the next
    shard's first token), RoPE sees global positions, and the rank's mean
    is rescaled by its count of targets over the count of all ranks'
    targets: the last shard of each row holds one ignored target, so
    averaging local means would weigh it wrongly. ``attn_impl`` must attend
    across the ``sp`` shards (a ring or Ulysses attention over ``mesh``)
    where ``sp`` > 1. ``remat`` and ``chunked_vocab`` are
    ``models.llama.loss_fn``'s: each layer recomputed in the backward (its
    FSDP gathers too), and the vocab streamed in chunks of that size on
    this rank's rows and vocab slice. On a one-device mesh the ranks run
    in lockstep inside ``attn_impl`` on the whole tree and the share is
    the whole loss. The backward of the share gives this rank's part of
    each gradient; ``allreduce_grads`` completes them.

    ``forward(params, tokens, cfg, attn_impl=, remat=, seq_offset=,
    shard=)`` is the model's forward on this rank's rows, returning
    ``(logits, extra)``: ``extra`` None, or a term the rank adds to its
    share as it is (``models.mixtral.sharded_forward``: its share of the
    load-balance loss). Unless given, llama's forward with no term; only
    llama's takes ``chunked_vocab``.

    A ``pp`` mesh pipelines the layers over its stages: its loss is
    ``parallel.make_pipelined_loss``'s, and this one raises."""
    if mesh.shape["pp"] > 1:
        raise NotImplementedError(
            "a pp mesh pipelines the layers over its stages: take the loss "
            "from parallel.make_pipelined_loss")
    return loss_share(params, tokens, cfg, mesh, attn_impl=attn_impl,
                      remat=remat, chunked_vocab=chunked_vocab, specs=specs,
                      forward=forward)


def loss_share(params: Dict[str, Any], tokens: torch.Tensor,
               cfg: LlamaConfig, mesh: Mesh, attn_impl=None,
               remat: bool = False, chunked_vocab: int = 0,
               specs: Any = None, forward=None) -> torch.Tensor:
    """``sharded_loss_fn``'s share on any mesh: the batch split, the
    targets, the share's rescaling and the ``forward`` hook, which the
    pipelined loss (``parallel.pipeline``) fills with its forward over the
    ``pp`` stages."""
    if forward is not None and chunked_vocab > 0:
        raise NotImplementedError("chunked_vocab streams llama's head only")
    tok = shard_batch(mesh, tokens)
    tgt = shard_batch(mesh, next_token_targets(tokens))
    seq_offset = mesh.coords["sp"] * tok.shape[1] if mesh.distributed else 0
    shard = Placement(mesh, cfg, specs) if mesh.distributed else None
    extra = None
    if chunked_vocab > 0:
        x = forward_hidden(params, tok, cfg, remat=remat,
                           attn_impl=attn_impl, seq_offset=seq_offset,
                           shard=shard)
        loss = chunked_head_loss(params, x, tgt, cfg, chunked_vocab,
                                 shard=shard)
        n = (tgt != IGNORE).sum().float()
    else:
        logits, extra = (forward or _llama_forward)(
            params, tok, cfg, attn_impl=attn_impl, remat=remat,
            seq_offset=seq_offset, shard=shard)
        loss, n = cross_entropy_loss(logits, tgt,
                                     vocab=shard.vocab if shard else None)
    if mesh.distributed:
        loss = loss * (n / allreduce(n, mesh, SPLIT_AXES))
    # on a one-device mesh every rank lives here: the share is the whole
    return loss if extra is None else loss + extra


def _llama_forward(params, tokens, cfg, **kw):
    return llama_forward(params, tokens, cfg, **kw), None


def _sum_axes(spec) -> tuple:
    """The batch axes a leaf's gradient is still to be summed over: those
    its spec does not split (an FSDP gather's backward summed over its
    own)."""
    return tuple(a for a in SPLIT_AXES if a not in spec_axes(spec))


def allreduce_grads(tree: Any, mesh: Mesh, specs: Any = None) -> None:
    """Complete each leaf's ``.grad`` in ``tree`` (a parameter tree, or a
    list of leaves) so every rank holds its shard of the global batch's
    gradient: summed over the batch axes and ``sp`` that its spec in
    ``specs`` (the tree's mirror; None: every leaf replicated) does not
    split. Nothing is summed over ``tp``: a tp-split leaf's gradient is
    its rank's own, and a replicated one's is whole on every tp rank."""
    spec_of = dict(tree_paths(specs)) if specs is not None else {}
    for path, t in tree_paths(tree):
        if t.grad is not None:
            t.grad = allreduce(t.grad, mesh,
                               _sum_axes(spec_of.get(path, ())))


def global_grad_norm(tree: Any, mesh: Mesh, specs: Any = None
                     ) -> torch.Tensor:
    """The L2 norm of the global gradient from every rank's synced shards
    (after ``allreduce_grads``): each rank's sums of squares, a leaf's
    divided by the number of ranks that hold the same shard, summed over
    the mesh. fp32, on every rank."""
    spec_of = dict(tree_paths(specs)) if specs is not None else {}
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for path, t in tree_paths(tree):
        if t.grad is None:
            continue
        split = spec_axes(spec_of.get(path, ()))
        copies = math.prod(n for a, n in mesh.shape.items()
                           if a not in split) if mesh.distributed else 1
        total = total + t.grad.float().square().sum() / copies
    if mesh.distributed:
        total = allreduce(total, mesh, AXES)
    return total.sqrt()
