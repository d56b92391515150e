"""PPO loss + update (reference: ``rllib/algorithms/ppo/ppo_learner``
losses — clipped surrogate + value clip + entropy bonus).

Port of ``ray_tpu/rl/ppo_loss.py``. The update runs over a parameter tree
whose leaves require a gradient, with :class:`ClipAdam`, the port's
counterpart of the JAX learners' ``optax.chain(clip_by_global_norm(c),
adam(lr))``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch


class PPOUpdate(NamedTuple):
    step: Any
    compute_grads: Any
    apply_grads: Any


class ClipAdam:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` over the
    leaves of a parameter tree, updated in place.

    The clip is optax's: an update whose global norm is below
    ``grad_clip`` is left as it is; otherwise every leaf becomes
    ``g / norm * grad_clip`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
    to the norm and is not the same clip). ``torch.optim.Adam`` with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root)
    computes ``optax.adam``'s step."""

    def __init__(self, params, lr: float = 3e-4, grad_clip: float = 0.5):
        from ..models.convert import trainable

        self.leaves: List[torch.Tensor] = trainable(params)
        self.grad_clip = float(grad_clip)
        self.adam = torch.optim.Adam(self.leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.grad_clip
        return [torch.where(keep, g, g / norm * self.grad_clip)
                for g in grads]

    def apply(self, grads: List[torch.Tensor]) -> None:
        """One step with ``grads``, in the leaves' order."""
        for p, g in zip(self.leaves, self.clip(grads)):
            p.grad = g
        self.adam.step()
        for p in self.leaves:
            p.grad = None


def loss_grads(loss_fn, opt: ClipAdam, params, batch):
    """``loss_fn(params, batch) -> (total, stats)``'s gradients over
    ``opt``'s leaves, and its stats detached."""
    total, stats = loss_fn(params, batch)
    grads = list(torch.autograd.grad(total, opt.leaves))
    return grads, {k: v.detach() for k, v in stats.items()}


def make_ppo_update(opt: ClipAdam, hparams: dict) -> PPOUpdate:
    """``step(params, batch) -> stats``, ``compute_grads(params, batch) ->
    (grads, stats)`` and ``apply_grads(params, grads)`` over the tree that
    ``opt`` was built on; ``batch`` holds tensors on its device."""
    from . import rl_module

    clip = hparams.get("clip_param", 0.2)
    vf_clip = hparams.get("vf_clip_param", 10.0)
    vf_coeff = hparams.get("vf_loss_coeff", 0.5)
    ent_coeff = hparams.get("entropy_coeff", 0.01)

    def loss_fn(params, batch):
        logits, values = rl_module.forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()
        logp = torch.gather(logp_all, 1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # jnp's std is the population std
        adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
        pi_loss = -torch.mean(torch.minimum(surr1, surr2))
        # Clipped value loss (reference PPO learner semantics)
        vf_err = torch.square(values - batch["returns"])
        vf_clipped = batch["values"] + torch.clamp(
            values - batch["values"], -vf_clip, vf_clip)
        vf_err2 = torch.square(vf_clipped - batch["returns"])
        vf_loss = 0.5 * torch.mean(torch.maximum(vf_err, vf_err2))
        entropy = -torch.mean(
            torch.sum(torch.softmax(logits, dim=-1) * logp_all, dim=-1))
        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
        stats = {
            "policy_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
            "total_loss": total,
            "kl": torch.mean(batch["logp"] - logp),
        }
        return total, stats

    def compute_grads(params, batch):
        return loss_grads(loss_fn, opt, params, batch)

    def apply_grads(params, grads):
        opt.apply(grads)

    def step(params, batch) -> Dict[str, torch.Tensor]:
        grads, stats = compute_grads(params, batch)
        opt.apply(grads)
        return stats

    return PPOUpdate(step, compute_grads, apply_grads)
