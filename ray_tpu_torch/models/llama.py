"""Llama-family transformer over a plain parameter dict.

Port of ``ray_tpu/models/llama.py``: the same parameter tree, names and
``[in, out]`` weight layout, so a JAX tree converts as it is
(``models/convert.py``). ``forward_hidden``, ``forward`` and ``loss_fn``
are differentiable, with per-layer remat (``torch.utils.checkpoint``, for
``jax.checkpoint``) and the chunked-vocab loss; the cached decode path
runs under ``torch.no_grad``.

KV caches are per-layer ``(k, v)`` tensors ``[B, total, Hkv, D]`` that
``_decode_step`` writes in place (JAX returns new arrays); the write-back
copy is what in-place saves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import NEG_INF, flash_attention
from ..ops.chunked_xent import chunked_cross_entropy
from ..ops.layers import (apply_rope, cross_entropy_loss, rms_norm,
                          rope_frequencies)
from ..ops.quant import Q8, mm


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h = self.head_dim
        per_layer = (d * self.n_heads * h + 2 * d * self.n_kv_heads * h
                     + self.n_heads * h * d + 3 * d * f + 2 * d)
        total = v * d + self.n_layers * per_layer + d
        if not self.tie_embeddings:
            total += d * v
        return total


# Model-card configs (the published Llama-3 family shapes).
LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(d_model=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                        d_ff=8192, vocab_size=128256)
LLAMA_DEBUG = LlamaConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype=torch.float32)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights in the JAX package's tree and layout.

    Each weight is drawn in fp32 on the device and cast to ``cfg.dtype``
    once, so the 8B init takes seconds and its peak temporary is one fp32
    embedding (~2.1 GB). ``generator`` must live on ``device``. The values
    are not JAX's ``jax.random`` bits; parity with the JAX package runs
    through ``models/convert.py``."""
    device = resolve_device(device)

    def dense(shape, scale=None):
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[0])
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(scale).to(cfg.dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    d, hd = cfg.d_model, cfg.head_dim
    params: Dict[str, Any] = {
        "embedding": dense((cfg.vocab_size, d), 1.0),
        "norm": zeros(d),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense((d, cfg.n_heads * hd)),
            "wk": dense((d, cfg.n_kv_heads * hd)),
            "wv": dense((d, cfg.n_kv_heads * hd)),
            "wo": dense((cfg.n_heads * hd, d)),
            "w_gate": dense((d, cfg.d_ff)),
            "w_up": dense((d, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, d)),
            "attn_norm": zeros(d),
            "mlp_norm": zeros(d),
        })
    return params


def _cache_attention(q, k_all, v_all, pos, cfg: LlamaConfig):
    """Masked attention of the new rows over the whole cache, with JAX's
    type placement: fp32 scores, ``-1e30`` mask, p cast to the cache dtype
    before the PV product. q: [B, L, H, D]; pos: [B, L] absolute positions
    (a key is visible when its index <= the query's position)."""
    B, L = q.shape[:2]
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    G = cfg.n_heads // Hkv
    total = k_all.shape[1]
    qg = q.float().reshape(B, L, Hkv, G, D)
    s = torch.einsum("blkgd,btkd->bkglt", qg, k_all.float())
    s = s * (D ** -0.5)
    visible = torch.arange(total, device=q.device)[None, None, :] <= \
        pos[:, :, None]                                        # [B, L, T]
    s = torch.where(visible[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkglt,btkd->blkgd", p.to(v_all.dtype), v_all)
    return o.reshape(B, L, cfg.n_heads, D)


def _attention_block(layer, x, cos, sin, cfg: LlamaConfig, kv_cache=None,
                     positions=None, attn_impl=None, shard=None):
    """Attention sublayer. ``kv_cache=(k_all, v_all, start)`` writes the new
    K/V in place at ``start`` (an int, or a [B] tensor of per-row offsets)
    and returns ``(out, (k_all, v_all, start + L))``. Without a cache the
    attention is ``attn_impl(q, k, v, causal=True)``, ``flash_attention``
    unless given. Heads are counted from the weights, so a rank whose
    ``shard`` (a ``parallel.sharding.Placement``) splits them over ``tp``
    runs its own heads and sums its part of the output over ``tp``."""
    B, L, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    if shard is not None:
        h = shard.enter(h)
    q = mm(h, layer["wq"]).reshape(B, L, -1, cfg.head_dim)
    k = mm(h, layer["wk"]).reshape(B, L, -1, cfg.head_dim)
    v = mm(h, layer["wv"]).reshape(B, L, -1, cfg.head_dim)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    new_cache = None
    if kv_cache is not None:
        k_all, v_all, start = kv_cache
        k = k.to(k_all.dtype)
        v = v.to(v_all.dtype)
        if isinstance(start, int):
            k_all[:, start:start + L] = k
            v_all[:, start:start + L] = v
            pos = (start + torch.arange(L, device=x.device))[None, :] \
                .expand(B, L)
        else:
            pos = start[:, None] + torch.arange(L, device=x.device)[None, :]
            rows = torch.arange(B, device=x.device)[:, None]
            k_all[rows, pos] = k
            v_all[rows, pos] = v
        new_cache = (k_all, v_all, start + L)
        if isinstance(start, int) and start == 0 and L > 1:
            # A fresh prompt: the keys past it are masked and the keys
            # before it do not exist, so the cache branch is exactly
            # causal attention over the new rows.
            o = flash_attention(q, k, v, causal=True)
        else:
            o = _cache_attention(q, k_all, v_all, pos, cfg)
    else:
        o = (attn_impl or flash_attention)(q, k, v, causal=True)
    out = mm(o.reshape(B, L, -1), layer["wo"])
    if shard is not None:
        out = shard.leave(out)
    return out, new_cache


def _mlp_block(layer, x, cfg: LlamaConfig, shard=None):
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if shard is not None:
        h = shard.enter(h)
    g = mm(h, layer["w_gate"])
    u = mm(h, layer["w_up"])
    out = mm(F.silu(g) * u, layer["w_down"])
    return out if shard is None else shard.leave(out)


def _head(params, cfg: LlamaConfig, shard=None):
    """The [D, V] head (this rank's vocab columns where ``shard`` splits
    them)."""
    if shard is None:
        return params["embedding"].T if cfg.tie_embeddings \
            else params["lm_head"]
    if cfg.tie_embeddings:
        return shard.param("embedding", params["embedding"]).T
    return shard.param("lm_head", params["lm_head"])


def _layer(x, layer, cos, sin, cfg: LlamaConfig, attn_impl, shard=None,
           i=0):
    """One block. Under ``shard`` layer ``i``'s weights are gathered here,
    inside what remat recomputes, so they live one layer at a time."""
    if shard is not None:
        layer = shard.layer(i, layer)
    a, _ = _attention_block(layer, x, cos, sin, cfg, attn_impl=attn_impl,
                            shard=shard)
    x = x + a
    return x + _mlp_block(layer, x, cfg, shard)


def forward_hidden(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: LlamaConfig, remat: bool = True, attn_impl=None,
                   seq_offset: int = 0, shard=None) -> torch.Tensor:
    """Final-norm hidden states [B, L, D] (no lm_head projection).

    ``remat`` recomputes each layer's activations in the backward pass
    instead of keeping them; it has no effect where no gradient is taken.
    ``attn_impl(q, k, v, causal=True)`` is the attention
    (``flash_attention`` unless given; a ring or Ulysses attention from
    ``parallel``). ``seq_offset`` is the global position of ``tokens``'
    first column: a rank that holds one sequence shard passes where its
    shard starts, so RoPE sees global positions, as JAX's one global
    program does. ``shard`` (a ``parallel.sharding.Placement``) says how
    ``params``, this rank's shards, are gathered and split (FSDP, TP)."""
    L = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, seq_offset + L,
                                cfg.rope_theta, device=tokens.device)
    cos, sin = cos[seq_offset:], sin[seq_offset:]
    if shard is None:
        x = params["embedding"][tokens.long()].to(cfg.dtype)
    else:
        x = shard.embed(shard.param("embedding", params["embedding"]),
                        tokens).to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, x, layer, cos, sin, cfg, attn_impl, shard,
                           i, use_reentrant=False)
        else:
            x = _layer(x, layer, cos, sin, cfg, attn_impl, shard, i)
    norm = params["norm"] if shard is None else \
        shard.param("norm", params["norm"])
    return rms_norm(x, norm, cfg.norm_eps)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: LlamaConfig,
            remat: bool = True, attn_impl=None,
            seq_offset: int = 0, shard=None) -> torch.Tensor:
    """Logits for a token batch. tokens: [B, L] int -> [B, L, V] (this
    rank's vocab columns where ``shard`` splits them); the other arguments
    as ``forward_hidden``'s."""
    x = forward_hidden(params, tokens, cfg, remat=remat, attn_impl=attn_impl,
                       seq_offset=seq_offset, shard=shard)
    if shard is not None:
        x = shard.enter(x)
    return mm(x, _head(params, cfg, shard))


def next_token_targets(tokens: torch.Tensor) -> torch.Tensor:
    """Shifted targets with -100 (ignore) padding the final position."""
    return torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                     dim=1)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig, remat: bool = True,
            chunked_vocab: int = 0, attn_impl=None) -> torch.Tensor:
    """Mean next-token loss. batch: {"tokens": [B, L]} or {"tokens",
    "targets"}.

    ``chunked_vocab > 0`` streams the vocab softmax in chunks of that size
    (``ops/chunked_xent.py``), so the [B, L, V] fp32 logits are never
    materialised. ``attn_impl`` as ``forward_hidden``'s. Over a
    process-group mesh each rank holds a shard, and the global mean is
    ``parallel.sharded_loss_fn``."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = next_token_targets(tokens)
    if chunked_vocab > 0:
        x = forward_hidden(params, tokens, cfg, remat=remat,
                           attn_impl=attn_impl)
        return chunked_head_loss(params, x, targets, cfg, chunked_vocab)
    logits = forward(params, tokens, cfg, remat=remat, attn_impl=attn_impl)
    loss, _ = cross_entropy_loss(logits, targets)
    return loss


def chunked_head_loss(params: Dict[str, Any], x: torch.Tensor,
                      targets: torch.Tensor, cfg: LlamaConfig,
                      chunked_vocab: int, shard=None) -> torch.Tensor:
    """Mean loss of the final-norm hidden states ``x`` [B, L, D] through
    the head, the vocab streamed in chunks of ``chunked_vocab`` (this
    rank's vocab slice where ``shard`` splits it)."""
    head = _head(params, cfg, shard)
    if isinstance(head, Q8):
        # the chunked loss streams its own products from dense weights
        head = head.w.to(x.dtype) * head.s
    vocab = None
    if shard is not None:
        x, vocab = shard.enter(x), shard.vocab
    B, L, D = x.shape
    return chunked_cross_entropy(x.reshape(B * L, D), head,
                                 targets.reshape(B * L), chunked_vocab,
                                 vocab=vocab)


def flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Approximate training FLOPs per token (6 N plus the attention term),
    for MFU."""
    attn = 12 * cfg.n_layers * cfg.d_model * seq_len  # fwd+bwd attention
    return 6 * cfg.param_count() + attn


@torch.no_grad()
def _decode_step(params, tokens, caches, start: Union[int, torch.Tensor],
                 cfg: LlamaConfig, cos, sin,
                 ffn=None) -> Tuple[torch.Tensor, List[tuple]]:
    """One cached forward over ``tokens`` [B, L] beginning at ``start``
    (an int, or a [B] tensor of per-row positions). ``caches`` are
    per-layer ``(k, v)`` written in place; returns ``(logits, caches)``.
    ``ffn(layer, x, cfg)`` is the feed-forward block, the dense SwiGLU MLP
    unless given: the hook the MoE family (``models.mixtral``) shares this
    loop through."""
    if ffn is None:
        ffn = _mlp_block
    B, L = tokens.shape
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    if isinstance(start, int):
        positions = (start + torch.arange(L, device=tokens.device))[None, :] \
            .expand(B, L)
    else:
        positions = start[:, None] + torch.arange(L, device=tokens.device)
    new_caches = []
    for layer, (kc, vc) in zip(params["layers"], caches):
        a, nc = _attention_block(layer, x, cos, sin, cfg,
                                 kv_cache=(kc, vc, start),
                                 positions=positions)
        x = x + a
        x = x + ffn(layer, x, cfg)
        new_caches.append((nc[0], nc[1]))
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    return mm(x, _head(params, cfg)), new_caches


def new_caches(cfg: LlamaConfig, batch: int, total: int, device
               ) -> List[tuple]:
    """Zeroed per-layer KV caches [batch, total, Hkv, D] in ``cfg.dtype``."""
    shape = (batch, total, cfg.n_kv_heads, cfg.head_dim)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]


def _prefill(params, prompt, cfg: LlamaConfig, max_new: int, ffn=None):
    B, L = prompt.shape
    total = L + max_new
    caches = new_caches(cfg, B, total, prompt.device)
    cos, sin = rope_frequencies(cfg.head_dim, total, cfg.rope_theta,
                                device=prompt.device)
    logits, caches = _decode_step(params, prompt, caches, 0, cfg, cos, sin,
                                  ffn=ffn)
    return logits, caches, L, cos, sin


@torch.no_grad()
def _generate(params, prompt, cfg: LlamaConfig, max_new: int, pick,
              ffn=None):
    """The decode loop; ``pick(logits) -> tokens``, ``ffn`` as in
    ``_decode_step``."""
    logits, caches, L, cos, sin = _prefill(params, prompt, cfg, max_new,
                                           ffn=ffn)
    tok = pick(logits[:, -1])
    out = [tok]
    for pos in range(L, L + max_new - 1):
        logits, caches = _decode_step(params, tok[:, None], caches, pos, cfg,
                                      cos, sin, ffn=ffn)
        tok = pick(logits[:, -1])
        out.append(tok)
    return torch.stack(out, dim=1)


def generate_greedy(params, prompt: torch.Tensor, cfg: LlamaConfig,
                    max_new: int = 32) -> torch.Tensor:
    """KV-cached greedy decode: prompt [B, L] -> tokens [B, max_new]."""
    return _generate(params, prompt, cfg, max_new,
                     lambda logits: logits.argmax(dim=-1))


def generate_sample(params, prompt: torch.Tensor, cfg: LlamaConfig,
                    generator: torch.Generator, max_new: int = 32,
                    temperature: float = 1.0) -> torch.Tensor:
    """KV-cached sampled decode with temperature; draws from
    ``generator`` (which lives on the prompt's device)."""
    def pick(logits):
        probs = torch.softmax(logits.float() / max(temperature, 1e-6), -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return _generate(params, prompt, cfg, max_new, pick)
