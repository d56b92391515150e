"""Core transformer ops: RMSNorm, RoPE, SwiGLU, cross-entropy.

The port of ``ray_tpu/ops/layers.py``. These are memory-bound elementwise
ops that the JAX package leaves to XLA; here they are plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, scaled by ``(1 + scale)`` (norm weights start at
    zero), cast back to ``x``'s dtype."""
    orig_dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(orig_dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 500000.0,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: [max_len, head_dim // 2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved). x: [B, L, H, D];
    cos/sin: [max_len, D // 2]; positions: [B, L] gathers table rows."""
    B, L, H, D = x.shape
    if positions is None:
        c = cos[:L][None, :, None, :]
        s = sin[:L][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100, z_loss: float = 0.0,
                       vocab=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE with optional z-loss; returns ``(loss, n_valid)``.
    logits: [..., V]; labels: [...] int. Log-softmax in fp32.

    ``vocab`` (a ``parallel.sharding.VocabShard``) says the logits are this
    rank's columns ``[start, start + V)`` of a vocab split over ranks: the
    rows' max, sum of exponentials and target logit are then reduced over
    the vocab's shards, and every shard gets the same loss."""
    logits = logits.float()
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        clipped = labels.clamp(0, logits.shape[-1] - 1).long()
        true_logit = torch.gather(logits, -1, clipped[..., None])[..., 0]
    else:
        V = logits.shape[-1]
        m = vocab.reduce(logits.detach().amax(dim=-1), "max")
        lse = m + torch.log(vocab.sum(torch.exp(logits - m[..., None])
                                      .sum(dim=-1)))
        local = labels.clamp(0, vocab.total - 1).long() - vocab.start
        here = (local >= 0) & (local < V)
        got = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])
        true_logit = vocab.sum(torch.where(here, got[..., 0], 0.0))
    nll = lse - true_logit
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    valid = (labels != ignore_index).float()
    loss = (nll * valid).sum() / valid.sum().clamp(min=1.0)
    return loss, valid.sum()
