"""Connector pipelines: composable data transforms between env, module,
and learner.

Copied from ``ray_tpu/rl/connectors.py`` with the package renamed.

Reference: Connectors V2 (``rllib/connectors/``): env→module pipelines
(observation preprocessing), module→env (action unpacking), and learner
pipelines (GAE etc.). Here a connector is a callable
``(batch: dict, ctx: dict) -> dict`` composed in a ``ConnectorPipeline``
with list-like editing (prepend/append/insert_after/remove) so users can
customize the default stack the way the reference allows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

Connector = Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]


class ConnectorPipeline:
    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, batch: Dict[str, Any],
                 ctx: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        ctx = ctx if ctx is not None else {}
        for c in self.connectors:
            batch = c(batch, ctx)
        return batch

    def _names(self) -> List[str]:
        return [getattr(c, "name", type(c).__name__)
                for c in self.connectors]

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def insert_after(self, name: str, connector: Connector):
        self.connectors.insert(self._names().index(name) + 1, connector)
        return self

    def remove(self, name: str) -> "ConnectorPipeline":
        self.connectors.pop(self._names().index(name))
        return self


class FlattenObs:
    """Flatten trailing observation dims to one feature axis."""

    name = "FlattenObs"

    def __call__(self, batch, ctx):
        obs = np.asarray(batch["obs"])
        if obs.ndim > 2:
            batch["obs"] = obs.reshape(obs.shape[0], -1)
        return batch


class NormalizeObs:
    """Running mean/std observation normalization (Welford)."""

    name = "NormalizeObs"

    def __init__(self, clip: float = 10.0, eps: float = 1e-8):
        self.clip = clip
        self.eps = eps
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None

    def __call__(self, batch, ctx):
        obs = np.asarray(batch["obs"], np.float64)
        flat = obs.reshape(-1, obs.shape[-1])
        if self.mean is None:
            self.mean = np.zeros(flat.shape[-1])
            self.m2 = np.ones(flat.shape[-1])
        if ctx.get("update_stats", True):
            for row in (flat.mean(axis=0),):  # batched Welford update
                n = len(flat)
                delta = row - self.mean
                self.count += n
                self.mean += delta * (n / self.count)
                self.m2 += ((flat - row) ** 2).sum(axis=0) + \
                    delta ** 2 * n * (self.count - n) / self.count
        std = np.sqrt(self.m2 / max(self.count, 1.0)) + self.eps
        batch["obs"] = np.clip(
            (obs - self.mean) / std, -self.clip, self.clip
        ).astype(np.float32)
        return batch


class ClipRewards:
    name = "ClipRewards"

    def __init__(self, limit: float = 1.0):
        self.limit = limit

    def __call__(self, batch, ctx):
        if "rewards" in batch:
            batch["rewards"] = np.clip(batch["rewards"], -self.limit,
                                       self.limit)
        return batch


class GAEConnector:
    """Learner connector computing advantages/returns from a [T, N] rollout
    (reference: learner connector pipeline's GAE step)."""

    name = "GAEConnector"

    def __init__(self, gamma: float = 0.99, lam: float = 0.95):
        self.gamma = gamma
        self.lam = lam

    def __call__(self, batch, ctx):
        from .learner import gae

        adv, ret = gae(batch["rewards"], batch["values"], batch["dones"],
                       batch["bootstrap_value"], self.gamma, self.lam)
        batch["advantages"] = adv
        batch["returns"] = ret
        return batch


def default_env_to_module() -> ConnectorPipeline:
    return ConnectorPipeline([FlattenObs()])


def default_learner_pipeline(gamma: float = 0.99,
                             lam: float = 0.95) -> ConnectorPipeline:
    return ConnectorPipeline([GAEConnector(gamma, lam)])
