"""Replay buffers for off-policy algorithms.

Copied from ``ray_tpu/rl/replay.py`` with the package renamed.

Reference: ``rllib/utils/replay_buffers/`` (EpisodeReplayBuffer /
PrioritizedEpisodeReplayBuffer used by DQN/SAC). Stored as a plain actor so
every learner/runner shares one buffer through the object store; uniform
and proportional-prioritized sampling.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import ray_tpu_torch


@ray_tpu_torch.remote
class ReplayBuffer:
    """Ring buffer of transitions with optional prioritized sampling."""

    def __init__(self, capacity: int = 100_000, prioritized: bool = False,
                 alpha: float = 0.6, beta: float = 0.4, seed: int = 0):
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha = alpha
        self.beta = beta
        self.rng = np.random.RandomState(seed)
        self._storage: Dict[str, np.ndarray] = {}
        self._prio: Optional[np.ndarray] = None
        self._next = 0
        self._size = 0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> int:
        n = len(batch["obs"])
        if not self._storage:
            for k, v in batch.items():
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            v.dtype)
            self._prio = np.zeros(self.capacity, np.float64)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = v
        if self._prio is not None:
            max_p = self._prio[:self._size].max() if self._size else 1.0
            self._prio[idx] = max(max_p, 1e-6)
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        return self._size

    def sample(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        if self._size < batch_size:
            return None
        if self.prioritized:
            p = self._prio[:self._size] ** self.alpha
            p = p / p.sum()
            idx = self.rng.choice(self._size, batch_size, p=p)
            weights = (self._size * p[idx]) ** (-self.beta)
            weights = weights / weights.max()
        else:
            idx = self.rng.randint(0, self._size, batch_size)
            weights = np.ones(batch_size, np.float32)
        out = {k: v[idx] for k, v in self._storage.items()}
        out["_indices"] = idx
        out["_weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> bool:
        if self._prio is not None:
            self._prio[np.asarray(indices)] = np.abs(priorities) + 1e-6
        return True

    def size(self) -> int:
        return self._size
