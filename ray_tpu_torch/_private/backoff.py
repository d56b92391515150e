"""Jittered exponential backoff — the one retry-delay policy.

Reference analog: ``ExponentialBackoff`` (``src/ray/util/exponential_
backoff.h``) which every C++ retry loop shares. Before this module the
repo's reconnect/retry loops each hardcoded their own ``time.sleep``
ladder (worker store-pressure retry, GCS reconnect, head-ready poll) —
uniform caps and jitter now come from three config knobs
(``retry_backoff_base_s`` / ``retry_backoff_cap_s`` /
``retry_backoff_jitter``) so chaos schedules and slow hosts tune ONE
policy instead of hunting sleeps.

Jitter multiplies each delay by a uniform draw from ``[1 - jitter, 1]``:
many peers retrying after one shared failure (a GCS restart drops every
connection at once) decorrelate instead of thundering back in lockstep.
"""

from __future__ import annotations

import random
from typing import Optional


class Backoff:
    """Stateful delay ladder: ``next_delay()`` grows exponentially from
    ``base`` to ``cap``; ``reset()`` after a success."""

    __slots__ = ("base", "cap", "factor", "jitter", "_attempt", "_rng")

    def __init__(self, base: Optional[float] = None,
                 cap: Optional[float] = None, factor: float = 2.0,
                 jitter: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        if base is None or cap is None or jitter is None:
            from .config import config as _cfg

            c = _cfg()
            base = c.retry_backoff_base_s if base is None else base
            cap = c.retry_backoff_cap_s if cap is None else cap
            jitter = c.retry_backoff_jitter if jitter is None else jitter
        self.base = max(1e-4, float(base))
        self.cap = max(self.base, float(cap))
        self.factor = max(1.0, float(factor))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self._attempt = 0
        self._rng = rng or random

    def next_delay(self) -> float:
        d = min(self.cap, self.base * (self.factor ** self._attempt))
        self._attempt += 1
        if self.jitter:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def reset(self) -> None:
        self._attempt = 0

    @property
    def attempts(self) -> int:
        return self._attempt
