"""Vision Transformer over a plain parameter dict.

Port of ``ray_tpu/models/vit.py``: the same tree, names and ``[in, out]``
layout (the head in fp32 in any model dtype), so a JAX tree converts as it
is (``models/convert.py``). Patch embedding is one product over the
flattened patches; attention is bidirectional ``flash_attention`` with as
many kv heads as query heads (the flash kernels on CUDA, at a length no
tile divides: 197 tokens for ViT-B/16); the MLP's GELU is the tanh
approximation, ``jax.nn.gelu``'s default; the pooled CLS row and the
classifier are fp32.

On a process-group mesh ``encode``, ``forward`` and ``loss_fn`` take a
``shard`` (a ``parallel.sharding.Placement`` of ``VIT_RULES``' specs, its
``whole`` leaves ``WHOLE_LEAVES``): each layer's weights are gathered over
``fsdp`` where it uses them, attention and the MLP run on this rank's
heads and hidden units between Megatron's f and g, and the patch embed and
the head, whose column-parallel specs would split the residual stream and
the classes, are gathered over ``tp`` for their products.
``parallel.sharded_vit_loss_fn`` runs a step on such shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm


#: The leaves a sharded step uses whole over ``tp``: the patch embed and
#: the classifier (0.59 M and 0.77 M parameters at ViT-B/16).
WHOLE_LEAVES = ("patch_embed/w", "head/w")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT-B/16 by default ("An Image is Worth 16x16 Words", Table 1)."""

    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        per_layer = (4 * self.d_model ** 2          # qkv + out
                     + 2 * self.d_model * self.d_ff  # mlp up/down
                     + 2 * self.d_model)             # norms
        return (self.patch_dim * self.d_model + self.d_model  # patch embed
                + (self.num_patches + 1) * self.d_model       # pos embed
                + self.d_model                                # cls token
                + self.n_layers * per_layer
                + self.d_model                                # final norm
                + self.d_model * self.num_classes + self.num_classes)


def init_params(cfg: ViTConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights in the JAX package's tree and scales (He-normal by
    the first dim unless a scale is given), drawn in fp32 on the device
    and cast once. ``generator`` lives on ``device``."""
    device = resolve_device(device)

    def dense(shape, dtype=cfg.dtype, scale=None):
        if scale is None:
            scale = (2.0 / shape[0]) ** 0.5
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(scale).to(dtype)

    def zeros(n, dtype=cfg.dtype):
        return torch.zeros((n,), dtype=dtype, device=device)

    D = cfg.d_model
    params: Dict[str, Any] = {
        "patch_embed": {"w": dense((cfg.patch_dim, D)), "b": zeros(D)},
        "pos_embed": dense((cfg.num_patches + 1, D), scale=0.02),
        "cls_token": dense((1, D), scale=0.02),
        "norm": zeros(D),  # rms_norm scales by (1 + scale)
        "head": {"w": dense((D, cfg.num_classes), torch.float32, 0.02),
                 "b": zeros(cfg.num_classes, torch.float32)},
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": zeros(D),
            "wq": dense((D, D)),
            "wk": dense((D, D)),
            "wv": dense((D, D)),
            "wo": dense((D, D)),
            "mlp_norm": zeros(D),
            "w_up": dense((D, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, D)),
        })
    return params


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, P*P*C], patches in row-major order."""
    B, H, W, C = images.shape
    P = cfg.patch_size
    x = images.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // P) * (W // P), P * P * C)


def _attention(layer, x, cfg: ViTConfig, attn_impl, shard=None):
    """Heads are counted from the weights: under ``shard`` this rank's."""
    B, N, D = x.shape
    h = rms_norm(x, layer["attn_norm"])
    if shard is not None:
        h = shard.enter(h)
    q = (h @ layer["wq"]).reshape(B, N, -1, cfg.head_dim)
    k = (h @ layer["wk"]).reshape(B, N, -1, cfg.head_dim)
    v = (h @ layer["wv"]).reshape(B, N, -1, cfg.head_dim)
    a = attn_impl(q, k, v, causal=False).reshape(B, N, -1)
    out = a @ layer["wo"]
    if shard is not None:
        out = shard.leave(out)
    return x + out.to(x.dtype)


def _mlp(layer, x, shard=None):
    h = rms_norm(x, layer["mlp_norm"])
    if shard is not None:
        h = shard.enter(h)
    up = F.gelu(h @ layer["w_up"], approximate="tanh")
    out = up @ layer["w_down"]
    if shard is not None:
        out = shard.leave(out)
    return x + out.to(x.dtype)


def _leaf(params, path: str, shard):
    """Leaf ``path`` of ``params``, gathered as ``shard`` says."""
    t = params
    for key in path.split("/"):
        t = t[key]
    return t if shard is None else shard.param(path, t)


def encode(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
           attn_impl=None, shard=None) -> torch.Tensor:
    """[B, H, W, C] images -> the pooled CLS features [B, d_model], fp32.
    ``attn_impl(q, k, v, causal=False)`` is ``flash_attention`` unless
    given; ``shard`` places ``params``, this rank's shards."""
    attn_impl = attn_impl or flash_attention
    patches = patchify(images.to(cfg.dtype), cfg)
    x = (patches @ _leaf(params, "patch_embed/w", shard)
         + _leaf(params, "patch_embed/b", shard))
    cls = _leaf(params, "cls_token", shard).expand(x.shape[0], 1,
                                                   cfg.d_model)
    x = torch.cat([cls, x], dim=1) + _leaf(params, "pos_embed", shard)
    for i, layer in enumerate(params["layers"]):
        if shard is not None:
            layer = shard.layer(i, layer)
        x = _attention(layer, x, cfg, attn_impl, shard)
        x = _mlp(layer, x, shard)
    x = rms_norm(x, _leaf(params, "norm", shard))
    return x[:, 0].float()


def forward(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
            attn_impl=None, shard=None) -> torch.Tensor:
    """[B, H, W, C] images -> [B, num_classes] logits, fp32."""
    pooled = encode(params, images, cfg, attn_impl, shard)
    return pooled @ _leaf(params, "head/w", shard) + _leaf(params, "head/b",
                                                          shard)


def loss_fn(params, batch, cfg: ViTConfig, attn_impl=None,
            shard=None) -> torch.Tensor:
    """Mean softmax cross entropy over ``batch = {"images", "labels"}``."""
    logp = torch.log_softmax(forward(params, batch["images"], cfg,
                                     attn_impl, shard), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None]).mean()


def flops_per_image(cfg: ViTConfig) -> float:
    """Approximate forward + backward FLOPs per image, for MFU."""
    N = cfg.num_patches + 1
    per_layer = (4 * 2 * N * cfg.d_model ** 2          # qkv + out proj
                 + 2 * 2 * N * N * cfg.d_model         # attention matmuls
                 + 2 * 2 * N * cfg.d_model * cfg.d_ff)  # mlp
    fwd = (2 * N * cfg.patch_dim * cfg.d_model
           + cfg.n_layers * per_layer
           + 2 * cfg.d_model * cfg.num_classes)
    return 3.0 * fwd  # fwd + ~2x bwd
