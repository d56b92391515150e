"""V-trace off-policy correction (IMPALA).

Port of ``ray_tpu/rl/vtrace.py``: :func:`vtrace` is the JAX package's
numpy function as it is; :func:`vtrace_scan` is its ``lax.scan`` twin in
torch.

Reference: ``rllib/algorithms/impala/`` vtrace_torch/tf — importance-
weighted multi-step value targets with clipped rho/c (Espeholt et al.
2018). Two implementations with identical semantics:

* :func:`vtrace` — numpy reverse scan over [T, N] arrays; runs on the
  learner's host path right before the update (like GAE).
* :func:`vtrace_scan` — the same math on tensors, a reversed loop over
  T on the tensors' device, so the Podracer mesh learner folds the
  correction INTO its update (no host round trip per batch). It runs
  under autograd; the caller detaches the outputs.

``lam`` is the Espeholt λ: it scales the c ("trace cutting") weights
only — λ=1 is full n-step V-trace, λ<1 decays the off-policy correction
toward one-step TD exactly like TD(λ) (rho, the policy-gradient weight,
is never scaled).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def vtrace(behaviour_logp: np.ndarray, target_logp: np.ndarray,
           rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
           bootstrap_value: np.ndarray, gamma: float = 0.99,
           clip_rho: float = 1.0, clip_c: float = 1.0,
           lam: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vs, pg_advantages), both [T, N].

    vs are the v-trace value targets; pg_advantages are the clipped-rho
    weighted advantages for the policy gradient.
    """
    T, N = rewards.shape
    rho = np.minimum(np.exp(target_logp - behaviour_logp), clip_rho)
    c = lam * np.minimum(np.exp(target_logp - behaviour_logp), clip_c)
    nonterminal = 1.0 - dones.astype(np.float32)
    values_tp1 = np.concatenate([values[1:], bootstrap_value[None]], axis=0)
    deltas = rho * (rewards + gamma * values_tp1 * nonterminal - values)
    vs_minus_v = np.zeros((T, N), np.float32)
    acc = np.zeros(N, np.float32)
    for t in range(T - 1, -1, -1):
        acc = deltas[t] + gamma * nonterminal[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_tp1 = np.concatenate([vs[1:], bootstrap_value[None]], axis=0)
    pg_adv = rho * (rewards + gamma * vs_tp1 * nonterminal - values)
    return vs.astype(np.float32), pg_adv.astype(np.float32)


def vtrace_scan(behaviour_logp, target_logp, rewards, values, dones,
                bootstrap_value, gamma: float = 0.99,
                clip_rho: float = 1.0, clip_c: float = 1.0,
                lam: float = 1.0):
    """V-trace on tensors: the math of :func:`vtrace` as a reversed loop
    over the time axis on the inputs' device (the JAX package's reversed
    ``lax.scan``). Inputs [T, N] (+ bootstrap [N]); returns
    (vs, pg_advantages) as tensors."""
    import torch

    rho = torch.clamp(torch.exp(target_logp - behaviour_logp), max=clip_rho)
    c = lam * torch.clamp(torch.exp(target_logp - behaviour_logp),
                          max=clip_c)
    nonterminal = 1.0 - dones.to(torch.float32)
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rho * (rewards + gamma * values_tp1 * nonterminal - values)
    acc = torch.zeros_like(bootstrap_value)
    rows = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * nonterminal[t] * c[t] * acc
        rows.append(acc)
    vs = torch.stack(rows[::-1]) + values
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * vs_tp1 * nonterminal - values)
    return vs, pg_adv
