"""CatchEnv: a procedurally generated pixel environment, no assets.

Port of ``ray_tpu/rl/pixel_env.py``: the same game, observations and
random draws. With gymnasium installed it is a ``gymnasium.Env`` with a
``Box`` and a ``Discrete`` space, as in the JAX package; without it, it
carries plain spaces with the ``shape``, ``dtype`` and ``n`` that the
space probes read.

The bsuite/DeepMind-classic "Catch" game on an ``size x size`` grid: a
ball falls one row per step from a random top column; the agent moves a
paddle along the bottom row (left / stay / right) and is rewarded +1
for catching the ball, -1 for missing. Observations are the raw pixel
grid ([size, size, 1] float32, ball and paddle lit) so the policy must
go through the conv/ViT module path (``rl_module.PixelModuleConfig``) —
this is the heavier-than-CartPole learning threshold the Podracer tier
certifies against (ISSUE r10): an MLP on flat pixels can also solve it,
but the suite asserts the ViT path does, under a step budget.

Episodes are one drop (``size - 1`` steps), so returns are exactly
+/-1 and "learned" is unambiguous: mean return >= threshold means the
policy catches >= (1+threshold)/2 of balls. A random policy scores
~ -0.6 (the paddle random-walks ~sqrt(T) columns while the ball can
spawn anywhere).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError:  # gymnasium is optional
    gym = None
    spaces = None


class Box:
    """A bounded array space: what the probes read of ``gymnasium``'s."""

    def __init__(self, low: float, high: float, shape: Tuple[int, ...],
                 dtype=np.float32):
        self.low, self.high = low, high
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)


class Discrete:
    """``n`` actions, ``0 .. n - 1``."""

    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)


class CatchEnv(gym.Env if gym is not None else object):
    metadata = {"render_modes": []}

    def __init__(self, size: int = 8, seed: Optional[int] = None):
        assert size >= 3
        self.size = size
        self._rng = np.random.RandomState(seed)
        box, discrete = ((spaces.Box, spaces.Discrete) if spaces is not None
                         else (Box, Discrete))
        self.observation_space = box(
            0.0, 1.0, shape=(size, size, 1), dtype=np.float32)
        self.action_space = discrete(3)
        self._ball_row = 0
        self._ball_col = 0
        self._paddle_col = 0

    def _obs(self) -> np.ndarray:
        obs = np.zeros((self.size, self.size, 1), np.float32)
        obs[self._ball_row, self._ball_col, 0] = 1.0
        obs[self.size - 1, self._paddle_col, 0] = 1.0
        return obs

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._ball_row = 0
        self._ball_col = int(self._rng.randint(self.size))
        self._paddle_col = int(self._rng.randint(self.size))
        return self._obs(), {}

    def step(self, action: Any):
        move = int(action) - 1  # 0/1/2 -> left/stay/right
        self._paddle_col = int(
            np.clip(self._paddle_col + move, 0, self.size - 1))
        self._ball_row += 1
        terminated = self._ball_row >= self.size - 1
        reward = 0.0
        if terminated:
            reward = 1.0 if self._ball_col == self._paddle_col else -1.0
        return self._obs(), reward, terminated, False, {}

    def close(self):
        pass
