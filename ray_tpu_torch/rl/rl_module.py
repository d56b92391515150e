"""RLModule: the framework-neutral policy/value model, in torch.

Port of ``ray_tpu/rl/rl_module.py``. Reference:
``rllib/core/rl_module/rl_module.py`` — an RLModule owns the forward
passes for exploration/inference/training. Here it is a plain parameter
tree (like ``models/llama.py``): ``init`` makes params, plain forward
functions produce action logits + value estimates, so the same module
runs in env-runner actors (host inference) and learner actors (the
update on the card) without framework glue. The tree is the JAX
package's (``{"layers": [{"w", "b"}], "pi", "vf"}``, or ``{"vit", "vf"}``
for pixels, weights ``[in, out]``), so ``models.convert.params_from_numpy``
carries its parameters across unchanged. Every function runs on the
device of the tensors it is given; the JAX package's ``jit`` variants are
the same functions here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class MLPModuleConfig:
    obs_dim: int
    num_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class PixelModuleConfig:
    """Policy/value module over image observations, riding the existing
    ViT encoder (``models/vit.py``): patch-embed matmul + transformer
    blocks + pooled CLS features, with pi/vf heads on top. The pi head
    IS the ViT classification head (``num_classes = num_actions``); the
    vf head is one extra [D, 1] matmul on the same pooled features —
    no second model family, the vision path RL trains is the vision
    path the framework serves. Attention runs the flash kernels on CUDA
    only at head dims 64 and 128 (``d_model / n_heads``); at the
    defaults' 8 it takes ``dense_attention``."""

    image_size: int
    num_actions: int
    channels: int = 1
    patch_size: int = 4
    d_model: int = 32
    n_layers: int = 1
    n_heads: int = 4
    d_ff: int = 64

    @property
    def vit(self):
        from ..models import vit as _vit

        return _vit.ViTConfig(
            image_size=self.image_size, patch_size=self.patch_size,
            channels=self.channels, num_classes=self.num_actions,
            d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, d_ff=self.d_ff, dtype=torch.float32)


def init(cfg, generator: torch.Generator, device=None) -> Dict[str, Any]:
    """Random params in the JAX package's tree and scales, drawn on
    ``device`` (CUDA unless the caller names another) from ``generator``,
    which lives there."""
    device = resolve_device(device)

    def normal(shape, scale, dtype=torch.float32):
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return t.mul_(scale).to(dtype)

    if isinstance(cfg, PixelModuleConfig):
        from ..models import vit as _vit

        params = {"vit": _vit.init_params(cfg.vit, generator, device)}
        params["vf"] = {
            "w": normal((cfg.d_model, 1), 0.02),
            "b": torch.zeros((1,), dtype=torch.float32, device=device),
        }
        return params
    sizes = (cfg.obs_dim,) + tuple(cfg.hidden)
    params: Dict[str, Any] = {"layers": []}
    for i in range(len(sizes) - 1):
        params["layers"].append({
            "w": normal((sizes[i], sizes[i + 1]), np.sqrt(2.0 / sizes[i]),
                        cfg.dtype),
            "b": torch.zeros((sizes[i + 1],), dtype=cfg.dtype,
                             device=device),
        })
    params["pi"] = {
        "w": normal((sizes[-1], cfg.num_actions), 0.01, cfg.dtype),
        "b": torch.zeros((cfg.num_actions,), dtype=cfg.dtype, device=device),
    }
    params["vf"] = {
        "w": normal((sizes[-1], 1), 1.0, cfg.dtype),
        "b": torch.zeros((1,), dtype=cfg.dtype, device=device),
    }
    return params


def params_device(params) -> torch.device:
    """The device a parameter tree lives on (its first leaf's)."""
    from ..ops.quant import tree_leaves

    return next(iter(tree_leaves(params))).device


def as_obs(obs, device) -> torch.Tensor:
    """Observations (numpy or a tensor) as an fp32 tensor on ``device``."""
    return torch.as_tensor(obs, dtype=torch.float32, device=device)


def _trunk(params, obs):
    h = obs
    for layer in params["layers"]:
        h = torch.tanh(h @ layer["w"] + layer["b"])
    return h


def forward(params, obs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (action_logits [B, A], value [B])."""
    h = _trunk(params, obs)
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


forward_jit = forward


def _draw(logits, value, generator):
    """Sampled actions (int32, as ``jax.random.categorical``'s), their
    logp and the values, as numpy."""
    actions = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                generator=generator)[:, 0]
    logp = torch.log_softmax(logits, dim=-1)[
        torch.arange(logits.shape[0], device=logits.device), actions]
    return (actions.to(torch.int32).cpu().numpy(), logp.cpu().numpy(),
            value.cpu().numpy())


def sample_actions(params, obs, generator: torch.Generator
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exploration forward: sampled actions + logp + value (numpy out).
    ``generator`` lives on the params' device."""
    with torch.no_grad():
        logits, value = forward(params, as_obs(obs, params_device(params)))
        return _draw(logits, value, generator)


def pixel_forward(cfg: PixelModuleConfig, params, obs, attn_impl=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, C] images -> (action_logits [B, A], value [B]) through
    the shared ViT encoder (``models/vit.py:encode``); ``attn_impl`` is
    the encoder's attention (``flash_attention`` unless given)."""
    from ..models import vit as _vit

    vcfg = cfg.vit
    pooled = _vit.encode(params["vit"], obs, vcfg, attn_impl)
    logits = (pooled @ params["vit"]["head"]["w"]
              + params["vit"]["head"]["b"])
    value = (pooled @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def make_forward(cfg, attn_impl=None):
    """Config-dispatched forward: ``fn(params, obs) -> (logits, value)``.
    MLP configs resolve to the module-level :func:`forward`; pixel
    configs close over the config (and ``attn_impl``) and route through
    the ViT encoder."""
    if isinstance(cfg, PixelModuleConfig):
        import functools

        return functools.partial(pixel_forward, cfg, attn_impl=attn_impl)
    return forward


def make_sample_fn(cfg):
    """Exploration forward for any module config: sampled actions +
    behaviour logp + value, numpy out (the env-runner hot loop), under
    ``no_grad`` on the params' device, ``generator`` there too."""
    fwd = make_forward(cfg)

    def sample(params, obs, generator: torch.Generator):
        with torch.no_grad():
            logits, value = fwd(params, as_obs(obs, params_device(params)))
            return _draw(logits, value, generator)

    return sample


def epsilon_greedy_actions(params, obs, generator: torch.Generator,
                           epsilon: float) -> np.ndarray:
    """Q-learning exploration: argmax-Q with epsilon random actions.

    For value-based algorithms the ``pi`` head's logits ARE the Q-values
    (reference: DQN's RLModule emits Q per action).
    """
    with torch.no_grad():
        q, _ = forward(params, as_obs(obs, params_device(params)))
        greedy = torch.argmax(q, dim=-1)
        rand = torch.randint(0, q.shape[-1], greedy.shape,
                             generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < epsilon
        return torch.where(explore, rand, greedy).to(
            torch.int32).cpu().numpy()
