"""Mixtral-family MoE transformer: Llama attention and a top-k expert FFN.

Port of ``ray_tpu/models/mixtral.py``: the same parameter tree (each
layer's experts stacked on a leading E dim under ``experts``, an fp32
``router`` [D, E] in any model dtype), so a JAX tree converts as it is
(``models/convert.py``). Attention is llama's ``_attention_block`` (the
flash kernels on CUDA); the FFN is ``parallel.moe``'s dense all-experts
path unless a ``moe_ffn`` is given, such as
``parallel.moe.make_ep_moe_ffn`` for expert parallelism. Cached decoding
is llama's loop with the MoE as its ``ffn``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.layers import cross_entropy_loss, rms_norm, rope_frequencies
from ..ops.quant import mm
from ..parallel.moe import expert_shardings, make_ep_moe_ffn, moe_ffn_dense
from ..parallel.sharding import TP, shardings_for_tree
from . import llama
from .llama import LlamaConfig, next_token_targets


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    aux_coef: float = 0.01

    def param_count(self) -> int:
        """Every parameter: E experts and the router a layer (the dense
        count's MoE counterpart)."""
        d, hd, E, f = self.d_model, self.head_dim, self.n_experts, self.d_ff
        per_layer = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                     + self.n_heads * hd * d + d * E + 3 * E * d * f + 2 * d)
        total = self.vocab_size * d + self.n_layers * per_layer + d
        if not self.tie_embeddings:
            total += d * self.vocab_size
        return total

    def active_param_count(self) -> int:
        """The parameters a token touches (its top-k experts): the count
        MFU takes for an MoE, since routed tokens skip the other experts."""
        skipped = 3 * self.d_model * self.d_ff * (self.n_experts - self.top_k)
        return self.param_count() - self.n_layers * skipped


# The published Mixtral-8x7B's shapes; a debug config for tests.
MIXTRAL_8X7B = MixtralConfig(vocab_size=32000, d_model=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, d_ff=14336,
                             max_seq_len=32768, rope_theta=1e6)
MIXTRAL_DEBUG = MixtralConfig(vocab_size=256, d_model=64, n_layers=2,
                              n_heads=4, n_kv_heads=2, d_ff=128,
                              max_seq_len=256, n_experts=4, top_k=2,
                              dtype=torch.float32)


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights in the JAX package's tree and layout, drawn as
    ``llama.init_params`` draws them (fp32 on the device, scaled by the
    fan-in, cast once); the router stays fp32. ``generator`` lives on
    ``device``."""
    device = resolve_device(device)

    def dense(shape, dtype=cfg.dtype, scale=None):
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2])
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(scale).to(dtype)

    def zeros(n):
        return torch.zeros((n,), dtype=cfg.dtype, device=device)

    d, hd, E, f = cfg.d_model, cfg.head_dim, cfg.n_experts, cfg.d_ff
    params: Dict[str, Any] = {
        "embedding": dense((cfg.vocab_size, d), scale=1.0),
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
            "router": dense((d, E), torch.float32),
            "experts": {
                "w_gate": dense((E, d, f)),
                "w_up": dense((E, d, f)),
                "w_down": dense((E, f, d)),
            },
            "attn_norm": zeros(d),
            "mlp_norm": zeros(d),
        })
    return params


def _layer(x, layer, cos, sin, cfg: MixtralConfig, attn_impl, moe_ffn,
           shard=None, i=0):
    """One block, returning ``(x, aux)``. Under ``shard`` layer ``i``'s
    weights are gathered here, inside what remat recomputes."""
    if shard is not None:
        layer = shard.layer(i, layer)
    a, _ = llama._attention_block(layer, x, cos, sin, cfg,
                                  attn_impl=attn_impl, shard=shard)
    x = x + a
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    y, aux = moe_ffn(h, layer["router"], layer["experts"])
    return x + y, aux


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MixtralConfig,
            attn_impl=None, remat: bool = True, moe_ffn=None, shard=None):
    """Logits and the layers' summed aux loss: tokens [B, L] -> ([B, L, V],
    fp32 scalar).

    ``moe_ffn(x, router, experts) -> (y, aux)`` defaults to the dense
    all-experts path; ``parallel.moe.make_ep_moe_ffn(mesh, k)`` dispatches
    over ``ep``. ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, for ``jax.checkpoint``); ``attn_impl`` and
    ``shard`` (a ``parallel.sharding.Placement``) as
    ``llama.forward_hidden``'s."""
    if moe_ffn is None:
        def moe_ffn(x, router, experts):
            return moe_ffn_dense(x, router, experts, cfg.top_k)
    cos, sin = rope_frequencies(cfg.head_dim, tokens.shape[1],
                                cfg.rope_theta, device=tokens.device)
    if shard is None:
        x = params["embedding"][tokens.long()].to(cfg.dtype)
    else:
        x = shard.embed(shard.param("embedding", params["embedding"]),
                        tokens).to(cfg.dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, layer in enumerate(params["layers"]):
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_layer, x, layer, cos, sin, cfg, attn_impl,
                                moe_ffn, shard, i, use_reentrant=False)
        else:
            x, aux = _layer(x, layer, cos, sin, cfg, attn_impl, moe_ffn,
                            shard, i)
        aux_total = aux_total + aux
    norm = params["norm"] if shard is None else \
        shard.param("norm", params["norm"])
    x = rms_norm(x, norm, cfg.norm_eps)
    if shard is not None:
        x = shard.enter(x)
    return mm(x, llama._head(params, cfg, shard)), aux_total


def sharded_forward(params, tokens, cfg: MixtralConfig, attn_impl=None,
                    remat: bool = True, seq_offset: int = 0, shard=None,
                    moe_ffn=None):
    """``parallel.sharded_loss_fn``'s ``forward`` for a Mixtral: the logits
    and ``aux_coef`` times the aux, JAX's ``loss_fn(..., moe_ffn=...)``.
    Under ``shard`` the MoE defaults to ``make_ep_moe_ffn(mesh, cfg.top_k,
    cfg.capacity_factor)``, whose aux is this rank's share of the mean over
    the token shards, so the term counts once in the sum of the shares (and
    its gradient once). The experts must then be split over ``tp`` wherever
    the mesh has it (``mixtral_shardings``), and the batch is not split over
    ``sp``, as in JAX."""
    if shard is not None:
        mesh = shard.mesh
        if mesh.shape["sp"] > 1 or seq_offset:
            raise NotImplementedError("the MoE loss takes no sp split")
        if shard.tp != mesh.shape[TP]:
            raise ValueError("the expert-parallel MoE needs the model split "
                             "over tp (mixtral_shardings)")
        if moe_ffn is None:
            moe_ffn = make_ep_moe_ffn(mesh, cfg.top_k, cfg.capacity_factor)
    logits, aux = forward(params, tokens, cfg, attn_impl=attn_impl,
                          remat=remat, moe_ffn=moe_ffn, shard=shard)
    return logits, cfg.aux_coef * aux


def loss_fn(params, batch, cfg: MixtralConfig, attn_impl=None,
            remat: bool = True, moe_ffn=None) -> torch.Tensor:
    """Next-token CE plus ``aux_coef`` times the load-balance loss. Over a
    process-group mesh the global loss is ``parallel.sharded_loss_fn`` with
    ``forward=sharded_forward``."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = next_token_targets(tokens)
    logits, aux = forward(params, tokens, cfg, attn_impl=attn_impl,
                          remat=remat, moe_ffn=moe_ffn)
    ce, _ = cross_entropy_loss(logits, targets)
    return ce + cfg.aux_coef * aux


def mixtral_shardings(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Spec tree: ``LLAMA_RULES`` for attention and embeddings,
    ``expert_shardings`` for each layer's experts."""
    specs = shardings_for_tree(params, mesh)
    for layer, layer_specs in zip(params["layers"], specs["layers"]):
        layer_specs["experts"] = expert_shardings(layer["experts"], mesh)
    return specs


def _moe_decode_ffn(layer, x, cfg: MixtralConfig):
    """The ``ffn`` hook of llama's decode loop: the mlp norm, then every
    token routed through the dense MoE."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    y, _ = moe_ffn_dense(h, layer["router"], layer["experts"], cfg.top_k)
    return y


def _decode_step(params, tokens, caches, start, cfg: MixtralConfig, cos,
                 sin):
    """One cached forward: llama's with the MoE FFN hook."""
    return llama._decode_step(params, tokens, caches, start, cfg, cos, sin,
                              ffn=_moe_decode_ffn)


def generate_greedy(params, prompt: torch.Tensor, cfg: MixtralConfig,
                    max_new: int = 32) -> torch.Tensor:
    """KV-cached greedy decode: prompt [B, L] -> tokens [B, max_new]
    (llama's loop, each token routed through its experts)."""
    return llama._generate(params, prompt, cfg, max_new,
                           lambda logits: logits.argmax(dim=-1),
                           ffn=_moe_decode_ffn)
