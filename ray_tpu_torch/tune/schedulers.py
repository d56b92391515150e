"""Trial schedulers: FIFO, ASHA (async successive halving), PBT.

Reference: ``python/ray/tune/schedulers/`` — ``async_hyperband.py``
(ASHAScheduler), ``pbt.py`` (PopulationBasedTraining). The controller calls
``on_result`` for every report and acts on the returned decision.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "continue"
STOP = "stop"
# PBT: stop current run; restart with new config from a donor checkpoint.
EXPLOIT = "exploit"
# ResourceChangingScheduler: checkpoint, kill, relaunch with new resources.
REALLOCATE = "reallocate"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str):
        pass


class ASHAScheduler(FIFOScheduler):
    """Async successive halving: at each rung, trials below the top
    ``1/reduction_factor`` quantile of completed rung results stop early."""

    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_results: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        for rung in reversed(self.rungs):
            if t == rung:
                vals = self.rung_results[rung]
                vals.append(float(metric) if self.mode == "max"
                            else -float(metric))
                if len(vals) < self.rf:
                    return CONTINUE  # not enough data: optimistic continue
                cutoff_idx = max(0, math.ceil(len(vals) / self.rf) - 1)
                cutoff = sorted(vals, reverse=True)[cutoff_idx]
                return CONTINUE if vals[-1] >= cutoff else STOP
        return CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT: at each perturbation interval, bottom-quantile trials clone the
    checkpoint of a top-quantile trial and mutate hyperparameters
    (reference: ``tune/schedulers/pbt.py`` exploit/explore)."""

    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: Dict[str, Dict[str, Any]] = {}  # trial -> last result
        self.last_perturb: Dict[str, int] = {}

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        self.latest[trial_id] = result
        if t - self.last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self.last_perturb[trial_id] = t
        scores = {tid: (r.get(self.metric, -float("inf"))
                        if self.mode == "max"
                        else -r.get(self.metric, float("inf")))
                  for tid, r in self.latest.items()}
        if len(scores) < 2:
            return CONTINUE
        ranked = sorted(scores, key=scores.get, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        if trial_id in ranked[-k:] and trial_id not in ranked[:k]:
            return EXPLOIT
        return CONTINUE

    def exploit_target(self, trial_id: str) -> Optional[str]:
        scores = {tid: (r.get(self.metric, -float("inf"))
                        if self.mode == "max"
                        else -r.get(self.metric, float("inf")))
                  for tid, r in self.latest.items()}
        ranked = sorted(scores, key=scores.get, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top = [t for t in ranked[:k] if t != trial_id]
        return self.rng.choice(top) if top else None

    def mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            elif callable(spec):
                out[key] = spec()
            elif hasattr(spec, "sample"):
                out[key] = spec.sample(self.rng)
            elif key in out and isinstance(out[key], (int, float)):
                factor = self.rng.choice([0.8, 1.2])
                out[key] = out[key] * factor
        return out


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose running-average metric falls below the median of
    other trials' running averages at the same step (reference:
    ``tune/schedulers/median_stopping_rule.py``)."""

    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 4, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.history: Dict[str, List[float]] = {}

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        v = float(metric) if self.mode == "max" else -float(metric)
        self.history.setdefault(trial_id, []).append(v)
        if t <= self.grace_period:
            return CONTINUE
        step = len(self.history[trial_id])
        others = [h for tid, h in self.history.items()
                  if tid != trial_id and len(h) >= step]
        if len(others) < self.min_samples:
            return CONTINUE
        my_avg = sum(self.history[trial_id]) / step
        other_avgs = sorted(sum(h[:step]) / step for h in others)
        median = other_avgs[len(other_avgs) // 2]
        return STOP if my_avg < median else CONTINUE


class HyperBandScheduler(FIFOScheduler):
    """Synchronous-flavored HyperBand simplified to banded successive
    halving: each trial is assigned round-robin to a bracket with its own
    (grace, rf) budget; within a bracket, ASHA rung logic applies
    (reference: ``tune/schedulers/hyperband.py``; ASHA is the async variant
    the reference recommends, implemented above)."""

    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        # Brackets: s_max+1 ASHA instances with increasing grace periods.
        import math as _m

        s_max = int(_m.log(max_t, reduction_factor))
        self.brackets: List[ASHAScheduler] = []
        for s in range(s_max + 1):
            grace = max(1, max_t // (reduction_factor ** s))
            self.brackets.append(None)  # placeholder, built lazily
            self.brackets[s] = ASHAScheduler(
                metric=metric, mode=mode, time_attr=time_attr,
                max_t=max_t, grace_period=grace,
                reduction_factor=reduction_factor)
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def _bracket(self, trial_id: str) -> ASHAScheduler:
        if trial_id not in self._assignment:
            self._assignment[trial_id] = self._next % len(self.brackets)
            self._next += 1
        b = self.brackets[self._assignment[trial_id]]
        b.metric = b.metric or self.metric
        return b

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return self._bracket(trial_id).on_result(trial_id, result)


class PB2(PopulationBasedTraining):
    """Population-based bandits: PBT where explore steps are selected by a
    GP-UCB model over (hyperparams -> score improvement) instead of
    random perturbation (reference: ``tune/schedulers/pb2.py``, Parker-
    Holder et al. 2020). Continuous bounds only, like the reference.
    """

    def __init__(self, metric: str = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 kappa: float = 2.0, seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode, time_attr=time_attr,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds: "
                             "{name: [low, high]}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.kappa = kappa
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._prev_score: Dict[str, float] = {}
        # observations: (normalized hyperparam vector, score delta)
        self._data: List[tuple] = []

    # tuner hook: called with the trial's live config before on_result
    def record_config(self, trial_id: str, config: Dict[str, Any]):
        self._configs[trial_id] = config

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        metric = result.get(self.metric)
        if metric is not None:
            score = metric if self.mode == "max" else -metric
            prev = self._prev_score.get(trial_id)
            cfg = self._configs.get(trial_id)
            if prev is not None and cfg is not None:
                x = self._vec(cfg)
                if x is not None:
                    self._data.append((x, score - prev))
                    if len(self._data) > 500:
                        self._data = self._data[-500:]
            self._prev_score[trial_id] = score
        return super().on_result(trial_id, result)

    def _vec(self, config) -> Optional[List[float]]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = config.get(k)
            if v is None:
                return None
            out.append((float(v) - lo) / max(hi - lo, 1e-12))
        return out

    def mutate(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """GP-UCB selection over the bounds (numpy RBF GP; falls back to
        uniform sampling until enough observations exist)."""
        import numpy as np

        out = dict(config)
        d = len(self.bounds)
        cand = np.asarray([[self.rng.random() for _ in range(d)]
                           for _ in range(256)])
        if len(self._data) >= 4:
            X = np.asarray([x for x, _ in self._data])
            y = np.asarray([dy for _, dy in self._data], dtype=float)
            y_std = y.std() or 1.0
            y = (y - y.mean()) / y_std
            ls, noise = 0.2, 1e-3

            def k(a, b):
                d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
                return np.exp(-d2 / (2 * ls * ls))

            K = k(X, X) + noise * np.eye(len(X))
            Kinv = np.linalg.inv(K)
            Ks = k(cand, X)
            mu = Ks @ Kinv @ y
            var = np.clip(1.0 - (Ks * (Ks @ Kinv)).sum(-1), 1e-9, None)
            ucb = mu + self.kappa * np.sqrt(var)
            best = cand[int(np.argmax(ucb))]
        else:
            best = cand[0]
        for i, (key, (lo, hi)) in enumerate(self.bounds.items()):
            v = lo + float(best[i]) * (hi - lo)
            if isinstance(config.get(key), int):
                v = int(round(v))
            out[key] = v
        return out


class ResourceChangingScheduler(FIFOScheduler):
    """Reallocate a live trial's resources mid-tune.

    Reference: ``tune/schedulers/resource_changing_scheduler.py`` — wraps
    a base scheduler; after any report the
    ``resources_allocation_function(trial_id, result, current_resources)``
    may return a NEW resource dict for that trial. The controller then
    checkpoints (implicitly: the trial's latest pushed checkpoint), kills
    the trial actor, and relaunches it with the new resources, resuming
    from its own checkpoint. The base scheduler's early-stopping decisions
    take precedence; a PBT base's exploit mechanics do not compose through
    this wrapper (matching the reference's documented restriction).
    """

    def __init__(self, base_scheduler=None,
                 resources_allocation_function=None):
        self.base = base_scheduler or FIFOScheduler()
        self.alloc = resources_allocation_function
        self._current: Dict[str, Dict[str, float]] = {}
        # trial_id -> resources for its next incarnation (the controller
        # pops this when it processes the REALLOCATE decision).
        self.pending_resources: Dict[str, Dict[str, float]] = {}

    def set_trial_resources(self, trial_id: str,
                            resources: Optional[Dict[str, float]]):
        self._current[trial_id] = dict(resources or {})

    def trial_resources(self, trial_id: str) -> Dict[str, float]:
        return dict(self._current.get(trial_id) or {})

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        decision = self.base.on_result(trial_id, result)
        if decision != CONTINUE or self.alloc is None:
            return decision
        cur = self.trial_resources(trial_id)
        new = self.alloc(trial_id, result, dict(cur))
        if new and dict(new) != cur:
            self.pending_resources[trial_id] = dict(new)
            self._current[trial_id] = dict(new)
            return REALLOCATE
        return CONTINUE

    def on_trial_complete(self, trial_id: str):
        self.base.on_trial_complete(trial_id)


def evenly_distribute_cpus(max_total_cpus: float):
    """A stock allocation function (reference: ``DistributeResources``):
    grow each reporting trial's CPU share toward an even split of
    ``max_total_cpus`` over the trials seen so far."""
    seen = set()

    def alloc(trial_id, result, current):
        # Reallocated incarnations keep the controller's `<id>r...`
        # naming — count the LOGICAL trial, or each reallocation would
        # shrink its own share and thrash.
        seen.add(trial_id.rstrip("r"))
        share = max(1.0, max_total_cpus // max(len(seen), 1))
        if current.get("CPU") != share:
            return {**current, "CPU": share}
        return None

    return alloc
