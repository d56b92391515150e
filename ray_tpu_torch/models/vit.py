"""Vision Transformer over a plain parameter dict.

Port of ``ray_tpu/models/vit.py``: the same tree, names and ``[in, out]``
layout (the head in fp32 in any model dtype), so a JAX tree converts as it
is (``models/convert.py``). Patch embedding is one product over the
flattened patches; attention is bidirectional ``flash_attention`` with as
many kv heads as query heads (the flash kernels on CUDA, at a length no
tile divides: 197 tokens for ViT-B/16); the MLP's GELU is the tanh
approximation, ``jax.nn.gelu``'s default; the pooled CLS row and the
classifier are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..ops.attention import flash_attention
from ..ops.layers import rms_norm


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


def _attention(layer, x, cfg: ViTConfig, attn_impl):
    B, N, D = x.shape
    h = rms_norm(x, layer["attn_norm"])
    q = (h @ layer["wq"]).reshape(B, N, cfg.n_heads, cfg.head_dim)
    k = (h @ layer["wk"]).reshape(B, N, cfg.n_heads, cfg.head_dim)
    v = (h @ layer["wv"]).reshape(B, N, cfg.n_heads, cfg.head_dim)
    a = attn_impl(q, k, v, causal=False).reshape(B, N, D)
    return x + (a @ layer["wo"]).to(x.dtype)


def _mlp(layer, x):
    h = rms_norm(x, layer["mlp_norm"])
    up = F.gelu(h @ layer["w_up"], approximate="tanh")
    return x + (up @ layer["w_down"]).to(x.dtype)


def encode(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
           attn_impl=None) -> torch.Tensor:
    """[B, H, W, C] images -> the pooled CLS features [B, d_model], fp32.
    ``attn_impl(q, k, v, causal=False)`` is ``flash_attention`` unless
    given."""
    attn_impl = attn_impl or flash_attention
    patches = patchify(images.to(cfg.dtype), cfg)
    x = patches @ params["patch_embed"]["w"] + params["patch_embed"]["b"]
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    for layer in params["layers"]:
        x = _attention(layer, x, cfg, attn_impl)
        x = _mlp(layer, x)
    x = rms_norm(x, params["norm"])
    return x[:, 0].float()


def forward(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
            attn_impl=None) -> torch.Tensor:
    """[B, H, W, C] images -> [B, num_classes] logits, fp32."""
    pooled = encode(params, images, cfg, attn_impl)
    return pooled @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params, batch, cfg: ViTConfig, attn_impl=None) -> torch.Tensor:
    """Mean softmax cross entropy over ``batch = {"images", "labels"}``."""
    logp = torch.log_softmax(forward(params, batch["images"], cfg,
                                     attn_impl), dim=-1)
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
