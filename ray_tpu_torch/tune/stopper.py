"""Stop conditions (reference: ``python/ray/tune/stopper/``).

``RunConfig.stop`` accepts a dict (``{"training_iteration": 10}`` — stop a
trial when any named field reaches its threshold), a callable
``(trial_id, result) -> bool``, or a ``Stopper``. The Tune loop consults
the stopper on every report (per-trial stop) and every iteration
(``stop_all`` — experiment-wide stop, e.g. ``TimeoutStopper``).
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Any, Callable, Dict, Optional


class Stopper:
    """Per-trial + experiment-wide stop decisions."""

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class NoopStopper(Stopper):
    def __call__(self, trial_id, result):
        return False


class FunctionStopper(Stopper):
    """Wrap a plain ``(trial_id, result) -> bool`` callable."""

    def __init__(self, fn: Callable[[str, Dict[str, Any]], bool]):
        self.fn = fn

    def __call__(self, trial_id, result):
        return bool(self.fn(trial_id, result))


class DictStopper(Stopper):
    """The ``stop={"metric": threshold}`` form: stop a trial once ANY
    named result field reaches its threshold."""

    def __init__(self, criteria: Dict[str, float]):
        self.criteria = dict(criteria)

    def __call__(self, trial_id, result):
        return any(k in result and result[k] >= v
                   for k, v in self.criteria.items())


class MaximumIterationStopper(Stopper):
    """Stop each trial after ``max_iter`` reported results."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def __call__(self, trial_id, result):
        self._counts[trial_id] += 1
        return self._counts[trial_id] >= self.max_iter


class TimeoutStopper(Stopper):
    """Stop the WHOLE experiment after a wall-clock budget."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._start: Optional[float] = None

    def __call__(self, trial_id, result):
        return self.stop_all()

    def stop_all(self):
        if self._start is None:
            self._start = time.time()
        return time.time() - self._start >= self.timeout_s


class TrialPlateauStopper(Stopper):
    """Stop a trial whose ``metric`` has plateaued: the std-dev of the
    last ``num_results`` values is below ``std`` once at least
    ``grace_period`` results arrived."""

    def __init__(self, metric: str, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace_period = grace_period
        self._hist: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)

    def __call__(self, trial_id, result):
        if self.metric not in result:
            return False
        self._counts[trial_id] += 1
        h = self._hist.setdefault(
            trial_id, collections.deque(maxlen=self.num_results))
        h.append(float(result[self.metric]))
        if (self._counts[trial_id] < self.grace_period
                or len(h) < self.num_results):
            return False
        return statistics.pstdev(h) < self.std


class ExperimentPlateauStopper(Stopper):
    """Stop the experiment when the best ``metric`` seen stops improving
    for ``patience`` consecutive completed results."""

    def __init__(self, metric: str, mode: str = "max",
                 patience: int = 10, epsilon: float = 0.0):
        self.metric = metric
        self.mode = mode
        self.patience = patience
        self.epsilon = epsilon
        self._best: Optional[float] = None
        self._stale = 0

    def __call__(self, trial_id, result):
        if self.metric not in result:
            return False
        v = float(result[self.metric])
        score = v if self.mode == "max" else -v
        if self._best is None or score > self._best + self.epsilon:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return False  # per-trial: never; the experiment gate stops all

    def stop_all(self):
        return self._stale >= self.patience


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self.stoppers = stoppers

    def __call__(self, trial_id, result):
        # no short-circuit: stateful stoppers (iteration counters,
        # plateau windows) must observe every result
        return any([s(trial_id, result) for s in self.stoppers])

    def stop_all(self):
        return any(s.stop_all() for s in self.stoppers)


def coerce_stopper(stop: Any) -> Optional[Stopper]:
    """``RunConfig.stop`` -> Stopper (dict / callable / Stopper / None)."""
    if stop is None:
        return None
    if isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        return DictStopper(stop)
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(f"unsupported stop criterion: {stop!r}")
