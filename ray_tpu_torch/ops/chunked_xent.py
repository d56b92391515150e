"""Chunked-vocab cross entropy: the mean next-token NLL without the full
[N, V] logits.

Port of ``ray_tpu/ops/chunked_xent.py``, as a ``torch.autograd.Function``
in plain PyTorch (the JAX package has no Pallas kernel here):

  forward:  stream vocab chunks of ``chunk`` columns, an online
            log-sum-exp in fp32 and a gather of each target's logit.
  backward: recompute each chunk's logits from the saved ``lse`` and emit
            the ``(softmax - onehot)`` terms of ``d_hidden`` and
            ``d_head`` chunk by chunk; no logits are saved.

As in JAX, every chunk has the same width: the last one is zero-padded
and its padded columns are masked to ``-inf``. Labels of ``-100`` are
ignored, and the mean is over the other rows.

With a vocab split over ranks (tensor parallelism) each rank streams its
own columns; the rows' max, sum of exponentials and target logit are
reduced over the vocab's shards in the forward, and the backward needs no
collective: each rank's ``d_hidden`` is its columns' part, which the
caller's ``allreduce_bwd`` sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE = -100


def _chunks(head: torch.Tensor, chunk: int):
    """Yield ``(c0, w, col_ok)``: each chunk's first column, its fp32
    [D, chunk] weight (the last zero-padded) and a mask of its real
    columns (None where all are)."""
    V = head.shape[1]
    for c0 in range(0, V, chunk):
        w = head[:, c0:c0 + chunk].float()
        col_ok = None
        if w.shape[1] < chunk:
            col_ok = torch.arange(chunk, device=head.device) < w.shape[1]
            w = F.pad(w, (0, chunk - w.shape[1]))
        yield c0, w, col_ok


def _local_labels(labels, V, vocab):
    """Each label clipped to the vocab, as a column of this rank's ``V``
    (outside ``[0, V)`` where another shard holds it)."""
    if vocab is None:
        return labels.clamp(0, V - 1)
    return labels.clamp(0, vocab.total - 1) - vocab.start


class _ChunkedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk: int, vocab):
        N = hidden.shape[0]
        V = head.shape[1]
        h32 = hidden.float()
        valid = labels != IGNORE
        clipped = _local_labels(labels, V, vocab)
        m = torch.full((N,), float("-inf"), device=hidden.device)
        s = torch.zeros(N, device=hidden.device)
        tl = torch.zeros(N, device=hidden.device)
        for c0, w, col_ok in _chunks(head, chunk):
            logits = h32 @ w                                     # [N, chunk]
            if col_ok is not None:
                logits = logits.masked_fill(~col_ok, float("-inf"))
            cm = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - cm) + torch.exp(
                logits - cm[:, None]).sum(-1)
            m = cm
            local = clipped - c0
            in_chunk = (local >= 0) & (local < min(chunk, V - c0))
            got = logits.gather(1, local.clamp(0, chunk - 1)[:, None])[:, 0]
            tl = torch.where(in_chunk, got, tl)
        if vocab is not None:
            cm = vocab.reduce(m, "max")
            s = vocab.reduce(s * torch.exp(m - cm))
            m, tl = cm, vocab.reduce(tl)
        lse = m + torch.log(s)
        n = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - tl, 0.0).sum() / n
        ctx.save_for_backward(hidden, head, labels, lse, n)
        ctx.chunk, ctx.vocab = chunk, vocab
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, lse, n = ctx.saved_tensors
        chunk = ctx.chunk
        V = head.shape[1]
        h32 = hidden.float()
        clipped = _local_labels(labels, V, ctx.vocab)
        scale = (g / n) * (labels != IGNORE).float()   # [N] per-row weight
        dh = torch.zeros_like(h32)
        dhead = torch.empty(head.shape, dtype=torch.float32,
                            device=head.device)
        for c0, w, col_ok in _chunks(head, chunk):
            # softmax over the whole vocab through the saved lse
            p = torch.exp(h32 @ w - lse[:, None])
            if col_ok is not None:
                p = p.masked_fill(~col_ok, 0.0)
            width = min(chunk, V - c0)
            local = clipped - c0
            in_chunk = (local >= 0) & (local < width)
            # each row's target column less 1 (the others less 0.0): no
            # host read of which rows hold one, and no data-dependent shape
            p.scatter_add_(1, local.clamp(0, chunk - 1)[:, None],
                           -in_chunk.to(p.dtype)[:, None])
            p *= scale[:, None]                            # d_logits
            dh += p @ w.T
            dhead[:, c0:c0 + width] = (h32.T @ p)[:, :width]
        return dh.to(hidden.dtype), dhead.to(head.dtype), None, None, None


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor,
                          chunk: int = 8192, vocab=None) -> torch.Tensor:
    """Mean next-token NLL without materialising the full logits.

    hidden: [N, D], any float dtype; head: [D, V]; labels: [N] int
    (``-100`` = ignore). Gradients flow to ``hidden`` and ``head``.
    ``vocab`` (a ``parallel.sharding.VocabShard``) says ``head`` holds
    this rank's columns of a vocab split over ranks."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _ChunkedCrossEntropy.apply(hidden, head, labels, chunk, vocab)
