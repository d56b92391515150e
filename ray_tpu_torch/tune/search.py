"""Search spaces + variant generation.

Reference: ``python/ray/tune/search/`` — the basic variant generator
(grid + random sampling) plus the sampling-primitive API
(``tune.choice/uniform/loguniform/randint/grid_search``).
"""

from __future__ import annotations

import copy
import itertools
import math
import random
from typing import Any, Callable, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class Randint(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class QUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        return round(rng.uniform(self.low, self.high) / self.q) * self.q


class LogRandint(Domain):
    """Integer drawn log-uniformly from [low, high) (reference:
    ``tune.lograndint``)."""

    def __init__(self, low: int, high: int):
        if low < 1:
            raise ValueError("lograndint requires low >= 1")
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return min(self.high - 1, int(math.exp(
            rng.uniform(math.log(self.low), math.log(self.high)))))


class QRandint(Domain):
    def __init__(self, low: int, high: int, q: int = 1):
        self.low, self.high, self.q = int(low), int(high), int(q)

    def sample(self, rng):
        v = rng.randint(self.low, self.high)
        return int(round(v / self.q) * self.q)


class QLogRandint(Domain):
    def __init__(self, low: int, high: int, q: int = 1):
        self.inner = LogRandint(low, high)
        self.q = int(q)

    def sample(self, rng):
        return int(round(self.inner.sample(rng) / self.q) * self.q)


class Normal(Domain):
    """Gaussian N(mean, sd) (reference: ``tune.randn``)."""

    def __init__(self, mean: float = 0.0, sd: float = 1.0):
        self.mean, self.sd = mean, sd

    def sample(self, rng):
        return rng.gauss(self.mean, self.sd)


class QNormal(Domain):
    def __init__(self, mean: float, sd: float, q: float):
        self.mean, self.sd, self.q = mean, sd, q

    def sample(self, rng):
        return round(rng.gauss(self.mean, self.sd) / self.q) * self.q


class QLogUniform(Domain):
    def __init__(self, low: float, high: float, q: float):
        self.inner = LogUniform(low, high)
        self.q = q

    def sample(self, rng):
        return max(self.inner.low,
                   round(self.inner.sample(rng) / self.q) * self.q)


class SampleFrom(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> Randint:
    return Randint(low, high)


def quniform(low: float, high: float, q: float) -> QUniform:
    return QUniform(low, high, q)


def lograndint(low: int, high: int) -> LogRandint:
    return LogRandint(low, high)


def qrandint(low: int, high: int, q: int = 1) -> QRandint:
    return QRandint(low, high, q)


def qlograndint(low: int, high: int, q: int = 1) -> QLogRandint:
    return QLogRandint(low, high, q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def qrandn(mean: float, sd: float, q: float) -> QNormal:
    return QNormal(mean, sd, q)


def qloguniform(low: float, high: float, q: float) -> QLogUniform:
    return QLogUniform(low, high, q)


def sample_from(fn: Callable) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(values)


def _walk(space: Any, path=()):
    """Yield (path, value) for nested dict leaves."""
    if isinstance(space, dict):
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, space


def _set_path(d: dict, path, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def generate_variants(param_space: Dict[str, Any], num_samples: int = 1,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Expand grid axes (cartesian) x num_samples random draws.

    Matches the reference semantics: each grid combination is run
    ``num_samples`` times, with random domains re-sampled per run.
    """
    rng = random.Random(seed)
    grids = [(p, v.values) for p, v in _walk(param_space)
             if isinstance(v, GridSearch)]
    randoms = [(p, v) for p, v in _walk(param_space) if isinstance(v, Domain)]
    constants = [(p, v) for p, v in _walk(param_space)
                 if not isinstance(v, (Domain, GridSearch))]
    grid_combos = (list(itertools.product(*[vals for _, vals in grids]))
                   if grids else [()])
    variants = []
    for combo in grid_combos:
        for _ in range(num_samples):
            cfg: Dict[str, Any] = {}
            for p, v in constants:
                _set_path(cfg, p, copy.deepcopy(v))
            for (p, _), val in zip(grids, combo):
                _set_path(cfg, p, val)
            for p, dom in randoms:
                _set_path(cfg, p, dom.sample(rng))
            variants.append(cfg)
    return variants


# --------------------------------------------------------------- searchers
# Sequential suggest/observe search algorithms (reference:
# ``python/ray/tune/search/`` — BasicVariantGenerator, hyperopt-TPE,
# bayesopt, ConcurrencyLimiter). Re-implemented natively: the cluster image
# ships no optuna/hyperopt, and the math is small.


class Searcher:
    """suggest() next configs, observe completed trials."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: str,
                              space: Dict[str, Any]):
        self.metric = self.metric or metric
        self.mode = mode or self.mode
        self._space = space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None):
        pass

    def _score(self, result: Optional[Dict[str, Any]]) -> Optional[float]:
        if not result or self.metric not in result:
            return None
        v = float(result[self.metric])
        return v if self.mode == "max" else -v


class BasicVariantGenerator(Searcher):
    """Grid + random sampling, served sequentially (the default)."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None,
                 **kw):
        super().__init__(**kw)
        self.num_samples = num_samples
        self.seed = seed
        self._queue: Optional[List[dict]] = None

    def suggest(self, trial_id):
        if self._queue is None:
            self._queue = generate_variants(self._space, self.num_samples,
                                            self.seed)
        return self._queue.pop(0) if self._queue else None


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (hyperopt's default algorithm).

    Per-dimension independent TPE: observations are split at the
    ``gamma`` quantile into good/bad sets; candidates are drawn from a
    kernel density over the good set and ranked by the good/bad density
    ratio. Random sampling for the first ``n_initial`` trials.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._live: Dict[str, dict] = {}
        self._obs: List[tuple] = []  # (config, score)

    def suggest(self, trial_id):
        if any(isinstance(d, GridSearch) for _, d in _walk(self._space)):
            raise ValueError(
                "TPESearcher does not support grid_search axes; use the "
                "default variant generator (no search_alg) for grids, or "
                "replace grid_search with choice()")
        dims = [(p, d) for p, d in _walk(self._space)
                if isinstance(d, Domain)]
        consts = [(p, v) for p, v in _walk(self._space)
                  if not isinstance(v, (Domain, GridSearch))]
        cfg: Dict[str, Any] = {}
        for p, v in consts:
            _set_path(cfg, p, copy.deepcopy(v))
        scored = [(c, s) for c, s in self._obs if s is not None]
        if len(scored) < self.n_initial:
            for p, dom in dims:
                _set_path(cfg, p, dom.sample(self.rng))
        else:
            scored.sort(key=lambda cs: cs[1], reverse=True)
            n_good = max(1, int(len(scored) * self.gamma))
            good = [c for c, _ in scored[:n_good]]
            bad = [c for c, _ in scored[n_good:]] or good
            for p, dom in dims:
                if isinstance(dom, SampleFrom):
                    # Opaque user sampler: no density model; just sample.
                    _set_path(cfg, p, dom.sample(self.rng))
                else:
                    _set_path(cfg, p, self._suggest_dim(p, dom, good, bad))
        self._live[trial_id] = cfg
        return cfg

    @staticmethod
    def _get_path(cfg: dict, path):
        for k in path:
            cfg = cfg[k]
        return cfg

    def _suggest_dim(self, path, dom, good, bad):
        gvals = [self._get_path(c, path) for c in good]
        bvals = [self._get_path(c, path) for c in bad]
        if isinstance(dom, Categorical):
            # Weighted by smoothed counts in the good set over the bad set.
            def weight(cat):
                g = gvals.count(cat) + 1.0
                b = bvals.count(cat) + 1.0
                return g / b
            cats = dom.categories
            weights = [weight(c) for c in cats]
            total = sum(weights)
            r = self.rng.random() * total
            acc = 0.0
            for c, w in zip(cats, weights):
                acc += w
                if r <= acc:
                    return c
            return cats[-1]
        # Continuous / integer dims: KDE ratio over log-ish space.
        import math as _m

        log = isinstance(dom, LogUniform)
        to_x = (lambda v: _m.log(v)) if log else float
        from_x = (lambda x: _m.exp(x)) if log else (lambda x: x)
        gx = [to_x(v) for v in gvals]
        bx = [to_x(v) for v in bvals]
        spread = (max(gx + bx) - min(gx + bx)) or 1.0
        bw = max(spread / max(len(gx), 1) ** 0.5, 1e-6 * spread)

        def density(x, pts):
            return sum(_m.exp(-0.5 * ((x - p) / bw) ** 2) for p in pts) \
                / (len(pts) * bw) + 1e-12

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(gx)
            x = self.rng.gauss(center, bw)
            ratio = density(x, gx) / density(x, bx)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        v = from_x(best_x)
        # Clamp into the domain + integer/quantized rounding.
        if isinstance(dom, Randint):
            v = int(min(max(round(v), dom.low), dom.high - 1))
        elif isinstance(dom, QUniform):
            v = min(max(round(v / dom.q) * dom.q, dom.low), dom.high)
        elif isinstance(dom, (Uniform, LogUniform)):
            v = min(max(v, dom.low), dom.high)
        return v

    def on_trial_complete(self, trial_id, result=None):
        cfg = self._live.pop(trial_id, None)
        if cfg is not None:
            self._obs.append((cfg, self._score(result)))


class BayesOptSearcher(Searcher):
    """GP + expected-improvement over continuous dims (numpy RBF GP).

    Reference analog: ``tune/search/bayesopt``. Categorical/grid axes are
    not supported — use TPESearcher for mixed spaces.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 n_initial: int = 5, n_candidates: int = 256,
                 length_scale: float = 0.2, seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.n_initial = n_initial
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.rng = random.Random(seed)
        self._live: Dict[str, dict] = {}
        self._obs: List[tuple] = []

    def _dims(self):
        dims = []
        for p, d in _walk(self._space):
            if isinstance(d, (Uniform, LogUniform, Randint, QUniform)):
                dims.append((p, d))
            elif isinstance(d, (Categorical, GridSearch)):
                raise ValueError(
                    "BayesOptSearcher supports continuous/integer domains "
                    "only; use TPESearcher for categorical/grid axes")
        return dims

    @staticmethod
    def _norm(dom, v):
        import math as _m

        if isinstance(dom, LogUniform):
            lo, hi = _m.log(dom.low), _m.log(dom.high)
            return (_m.log(v) - lo) / (hi - lo)
        return (float(v) - dom.low) / (dom.high - dom.low)

    @staticmethod
    def _denorm(dom, u):
        import math as _m

        if isinstance(dom, LogUniform):
            lo, hi = _m.log(dom.low), _m.log(dom.high)
            return _m.exp(lo + u * (hi - lo))
        v = dom.low + u * (dom.high - dom.low)
        if isinstance(dom, Randint):
            return int(min(max(round(v), dom.low), dom.high - 1))
        if isinstance(dom, QUniform):
            return min(max(round(v / dom.q) * dom.q, dom.low), dom.high)
        return v

    def suggest(self, trial_id):
        import numpy as np

        dims = self._dims()
        consts = [(p, v) for p, v in _walk(self._space)
                  if not isinstance(v, (Domain, GridSearch))]
        cfg: Dict[str, Any] = {}
        for p, v in consts:
            _set_path(cfg, p, copy.deepcopy(v))
        scored = [(c, s) for c, s in self._obs if s is not None]
        if len(scored) < self.n_initial:
            u = [self.rng.random() for _ in dims]
        else:
            X = np.array([[self._norm(d, self._get(c, p))
                           for p, d in dims] for c, _ in scored])
            y = np.array([s for _, s in scored], dtype=np.float64)
            y_mean, y_std = y.mean(), y.std() or 1.0
            yn = (y - y_mean) / y_std
            K = self._kernel(X, X) + 1e-6 * np.eye(len(X))
            Kinv = np.linalg.inv(K)
            cand = np.array([[self.rng.random() for _ in dims]
                             for _ in range(self.n_candidates)])
            Ks = self._kernel(cand, X)
            mu = Ks @ Kinv @ yn
            var = np.maximum(1.0 - np.einsum(
                "ij,jk,ik->i", Ks, Kinv, Ks), 1e-9)
            sigma = np.sqrt(var)
            best = yn.max()
            z = (mu - best) / sigma
            from math import erf, exp, pi, sqrt

            pdf = np.exp(-0.5 * z ** 2) / sqrt(2 * pi)
            cdf = 0.5 * (1.0 + np.vectorize(erf)(z / sqrt(2)))
            ei = (mu - best) * cdf + sigma * pdf
            u = cand[int(np.argmax(ei))].tolist()
        for (p, d), ui in zip(dims, u):
            _set_path(cfg, p, self._denorm(d, ui))
        self._live[trial_id] = cfg
        return cfg

    def _kernel(self, A, B):
        import numpy as np

        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    @staticmethod
    def _get(cfg: dict, path):
        for k in path:
            cfg = cfg[k]
        return cfg

    def on_trial_complete(self, trial_id, result=None):
        cfg = self._live.pop(trial_id, None)
        if cfg is not None:
            self._obs.append((cfg, self._score(result)))


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference: ``search/concurrency_limiter``)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None  # controller retries later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)
