"""External-searcher adapters: optuna / hyperopt / ax / nevergrad / hebo /
skopt, plus a native BOHB.

Reference: ``python/ray/tune/search/{optuna,hyperopt,ax,nevergrad,hebo,
skopt,bohb}/`` — the reference wraps each library behind its ``Searcher``
interface; these adapters do the same over the native interface in
``search.py``.

None of these libraries ship in this cluster image, so every adapter
imports its target lazily at construction and raises an actionable
``ImportError`` when the package is absent. The part that can rot silently
— the translation layer (native ``Domain`` objects -> each library's
parameter language, the ask/tell drive, mode-correct objective sign,
nested-path flatten/unflatten) — is exercised against API-faithful fakes
in ``tests/test_tune_external.py``, so the adapters are tested code, not
scaffolding.

``BOHBSearcher`` is different: BOHB's model (budget-stratified TPE driven
under HyperBand) needs no external library — it composes the native
``TPESearcher`` with per-budget observation pools and pairs with
``HyperBandScheduler``/``ASHAScheduler``.
"""

from __future__ import annotations

import copy
import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .search import (
    Categorical,
    Domain,
    GridSearch,
    LogUniform,
    QUniform,
    Randint,
    SampleFrom,
    Searcher,
    TPESearcher,
    Uniform,
    _set_path,
    _walk,
)

SEP = "/"


class _ExternalSearcher(Searcher):
    """Shared machinery: flatten the nested native space into (name, Domain)
    pairs the external library can consume, and rebuild nested configs from
    the library's flat suggestions."""

    #: human name of the wrapped package, for error messages
    _package = "?"

    def _flat_dims(self) -> List[Tuple[str, Domain]]:
        dims = []
        for path, dom in _walk(self._space):
            if isinstance(dom, GridSearch):
                raise ValueError(
                    f"{type(self).__name__} does not support grid_search "
                    "axes; use the default variant generator for grids, or "
                    "replace grid_search with choice()")
            if isinstance(dom, SampleFrom):
                raise ValueError(
                    f"{type(self).__name__} cannot model opaque "
                    "sample_from() domains; use explicit primitives")
            if isinstance(dom, Domain):
                dims.append((SEP.join(path), dom))
        return dims

    def _build_cfg(self, flat: Dict[str, Any]) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}
        for path, v in _walk(self._space):
            if not isinstance(v, (Domain, GridSearch)):
                _set_path(cfg, path, copy.deepcopy(v))
        for name, value in flat.items():
            _set_path(cfg, tuple(name.split(SEP)), value)
        return cfg

    def _objective(self, result: Optional[Dict[str, Any]],
                   minimize: bool) -> Optional[float]:
        """Raw metric with the sign the wrapped library expects."""
        if not result or self.metric not in result:
            return None
        v = float(result[self.metric])
        if minimize:
            return v if self.mode == "min" else -v
        return v if self.mode == "max" else -v


def _import(module: str, package_hint: str):
    try:
        return __import__(module, fromlist=["_"])
    except ImportError as e:
        raise ImportError(
            f"{module} is not installed in this image; install "
            f"`{package_hint}` to use this searcher (the from-scratch "
            "TPESearcher/BayesOptSearcher need no extra packages)") from e


# ------------------------------------------------------------------ optuna


class OptunaSearch(_ExternalSearcher):
    """Ask/tell adapter over an optuna study.

    Reference analog: ``python/ray/tune/search/optuna/optuna_search.py``.
    Intermediate results are reported to the optuna trial so optuna-side
    pruners see the learning curve; final results are ``tell``-ed with the
    study's own direction handling (no sign flip needed).
    """

    _package = "optuna"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 seed: Optional[int] = None, sampler=None):
        super().__init__(metric, mode)
        self._optuna = _import("optuna", "optuna")
        self._seed = seed
        self._sampler = sampler
        self._study = None
        self._trials: Dict[str, Any] = {}
        self._steps: Dict[str, int] = {}

    def _ensure_study(self):
        if self._study is None:
            sampler = self._sampler or self._optuna.samplers.TPESampler(
                seed=self._seed)
            self._study = self._optuna.create_study(
                direction="maximize" if self.mode == "max" else "minimize",
                sampler=sampler)

    def suggest(self, trial_id):
        self._ensure_study()
        trial = self._study.ask()
        flat: Dict[str, Any] = {}
        for name, dom in self._flat_dims():
            if isinstance(dom, Categorical):
                flat[name] = trial.suggest_categorical(name, dom.categories)
            elif isinstance(dom, LogUniform):
                flat[name] = trial.suggest_float(name, dom.low, dom.high,
                                                 log=True)
            elif isinstance(dom, QUniform):
                flat[name] = trial.suggest_float(name, dom.low, dom.high,
                                                 step=dom.q)
            elif isinstance(dom, Randint):
                flat[name] = trial.suggest_int(name, dom.low, dom.high - 1)
            elif isinstance(dom, Uniform):
                flat[name] = trial.suggest_float(name, dom.low, dom.high)
            else:  # pragma: no cover - _flat_dims filtered already
                raise TypeError(f"unsupported domain {dom!r}")
        self._trials[trial_id] = trial
        self._steps[trial_id] = 0
        return self._build_cfg(flat)

    def on_trial_result(self, trial_id, result):
        trial = self._trials.get(trial_id)
        if trial is None or self.metric not in (result or {}):
            return
        step = result.get("training_iteration")
        if step is None:
            step = self._steps[trial_id] = self._steps.get(trial_id, 0) + 1
        try:
            trial.report(float(result[self.metric]), int(step))
        except AttributeError:
            pass  # ask/tell trials on old optuna lack report()

    def on_trial_complete(self, trial_id, result=None):
        trial = self._trials.pop(trial_id, None)
        self._steps.pop(trial_id, None)
        if trial is None:
            return
        if result and self.metric in result:
            self._study.tell(trial, float(result[self.metric]))
        else:
            self._study.tell(
                trial, state=self._optuna.trial.TrialState.FAIL)


# ---------------------------------------------------------------- hyperopt


class HyperOptSearch(_ExternalSearcher):
    """Adapter over hyperopt's TPE via the Trials-document protocol.

    Reference analog: ``python/ray/tune/search/hyperopt/hyperopt_search.py``
    — hyperopt has no ask/tell API, so suggestions are drawn by invoking
    the suggest algorithm against a live ``Trials`` object and results are
    injected back as completed trial documents. hyperopt minimizes, so
    mode="max" metrics are sign-flipped.
    """

    _package = "hyperopt"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 seed: Optional[int] = None, algo=None):
        super().__init__(metric, mode)
        self._hpo = _import("hyperopt", "hyperopt")
        self._algo = algo or self._hpo.tpe.suggest
        self._rng = random.Random(seed)
        self._trials_obj = None
        self._domain = None
        self._space_expr = None
        self._hpo_ids: Dict[str, Any] = {}

    def _ensure_domain(self):
        if self._domain is not None:
            return
        hp = self._hpo.hp
        expr: Dict[str, Any] = {}
        for name, dom in self._flat_dims():
            if isinstance(dom, Categorical):
                expr[name] = hp.choice(name, dom.categories)
            elif isinstance(dom, LogUniform):
                expr[name] = hp.loguniform(name, math.log(dom.low),
                                           math.log(dom.high))
            elif isinstance(dom, QUniform):
                expr[name] = hp.quniform(name, dom.low, dom.high, dom.q)
            elif isinstance(dom, Randint):
                expr[name] = hp.randint(name, dom.low, dom.high)
            elif isinstance(dom, Uniform):
                expr[name] = hp.uniform(name, dom.low, dom.high)
        self._space_expr = expr
        self._domain = self._hpo.base.Domain(lambda spc: 0, expr)
        self._trials_obj = self._hpo.Trials()

    def suggest(self, trial_id):
        self._ensure_domain()
        new_ids = self._trials_obj.new_trial_ids(1)
        self._trials_obj.refresh()
        docs = self._algo(new_ids, self._domain, self._trials_obj,
                          self._rng.randrange(2 ** 31 - 1))
        self._trials_obj.insert_trial_docs(docs)
        self._trials_obj.refresh()
        misc = docs[0]["misc"]
        # vals holds one-element lists (choice indices for hp.choice);
        # space_eval resolves them to actual values.
        assignment = {k: v[0] for k, v in misc["vals"].items() if v}
        flat = self._hpo.space_eval(self._space_expr, assignment)
        self._hpo_ids[trial_id] = docs[0]["tid"]
        return self._build_cfg(dict(flat))

    def on_trial_complete(self, trial_id, result=None):
        tid = self._hpo_ids.pop(trial_id, None)
        if tid is None:
            return
        loss = self._objective(result, minimize=True)
        for doc in self._trials_obj.trials:
            if doc["tid"] == tid:
                if loss is None:
                    doc["state"] = self._hpo.JOB_STATE_ERROR
                    doc["result"] = {"status": self._hpo.STATUS_FAIL}
                else:
                    doc["state"] = self._hpo.JOB_STATE_DONE
                    doc["result"] = {"loss": loss,
                                     "status": self._hpo.STATUS_OK}
                break
        self._trials_obj.refresh()


# ---------------------------------------------------------------------- ax


class AxSearch(_ExternalSearcher):
    """Adapter over ``ax.service.ax_client.AxClient`` (ask/tell).

    Reference analog: ``python/ray/tune/search/ax/ax_search.py``.
    """

    _package = "ax-platform"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 ax_client=None):
        super().__init__(metric, mode)
        self._ax = _import("ax.service.ax_client", "ax-platform")
        self._client = ax_client
        self._indices: Dict[str, int] = {}

    def _ensure_client(self):
        if self._client is not None:
            return
        params = []
        for name, dom in self._flat_dims():
            if isinstance(dom, Categorical):
                params.append({"name": name, "type": "choice",
                               "values": list(dom.categories)})
            elif isinstance(dom, Randint):
                params.append({"name": name, "type": "range",
                               "bounds": [dom.low, dom.high - 1],
                               "value_type": "int"})
            elif isinstance(dom, (Uniform, LogUniform, QUniform)):
                params.append({"name": name, "type": "range",
                               "bounds": [dom.low, dom.high],
                               "value_type": "float",
                               "log_scale": isinstance(dom, LogUniform)})
        self._client = self._ax.AxClient()
        self._client.create_experiment(
            parameters=params, objective_name=self.metric,
            minimize=self.mode == "min")

    def suggest(self, trial_id):
        self._ensure_client()
        flat, index = self._client.get_next_trial()
        self._indices[trial_id] = index
        return self._build_cfg(dict(flat))

    def on_trial_complete(self, trial_id, result=None):
        index = self._indices.pop(trial_id, None)
        if index is None:
            return
        if result and self.metric in result:
            self._client.complete_trial(
                trial_index=index,
                raw_data={self.metric: (float(result[self.metric]), 0.0)})
        else:
            self._client.log_trial_failure(trial_index=index)


# ------------------------------------------------------------- nevergrad


class NevergradSearch(_ExternalSearcher):
    """Adapter over a nevergrad optimizer (ask/tell; ng minimizes).

    Reference analog: ``python/ray/tune/search/nevergrad/nevergrad_search.py``.
    """

    _package = "nevergrad"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 optimizer_cls=None, budget: int = 100):
        super().__init__(metric, mode)
        self._ng = _import("nevergrad", "nevergrad")
        self._optimizer_cls = optimizer_cls
        self._budget = budget
        self._opt = None
        self._cands: Dict[str, Any] = {}

    def _ensure_opt(self):
        if self._opt is not None:
            return
        p = self._ng.p
        kw = {}
        for name, dom in self._flat_dims():
            if isinstance(dom, Categorical):
                kw[name] = p.Choice(dom.categories)
            elif isinstance(dom, LogUniform):
                kw[name] = p.Log(lower=dom.low, upper=dom.high)
            elif isinstance(dom, Randint):
                kw[name] = p.Scalar(lower=dom.low,
                                    upper=dom.high - 1).set_integer_casting()
            elif isinstance(dom, (Uniform, QUniform)):
                kw[name] = p.Scalar(lower=dom.low, upper=dom.high)
        cls = self._optimizer_cls or self._ng.optimizers.NGOpt
        self._opt = cls(parametrization=p.Dict(**kw), budget=self._budget)

    def suggest(self, trial_id):
        self._ensure_opt()
        cand = self._opt.ask()
        self._cands[trial_id] = cand
        flat = dict(cand.value)
        for name, dom in self._flat_dims():
            if isinstance(dom, QUniform):
                v = flat[name]
                flat[name] = min(max(round(v / dom.q) * dom.q, dom.low),
                                 dom.high)
        return self._build_cfg(flat)

    def on_trial_complete(self, trial_id, result=None):
        cand = self._cands.pop(trial_id, None)
        if cand is None:
            return
        loss = self._objective(result, minimize=True)
        if loss is not None:
            self._opt.tell(cand, loss)


# ------------------------------------------------------------------- hebo


class HEBOSearch(_ExternalSearcher):
    """Adapter over HEBO (suggest/observe over pandas frames; minimizes).

    Reference analog: ``python/ray/tune/search/hebo/hebo_search.py``.
    """

    _package = "HEBO"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._hebo_mod = _import("hebo.optimizers.hebo", "HEBO")
        self._ds_mod = _import("hebo.design_space.design_space", "HEBO")
        self._seed = seed
        self._opt = None
        self._rows: Dict[str, Any] = {}

    def _ensure_opt(self):
        if self._opt is not None:
            return
        spec = []
        for name, dom in self._flat_dims():
            if isinstance(dom, Categorical):
                spec.append({"name": name, "type": "cat",
                             "categories": list(dom.categories)})
            elif isinstance(dom, Randint):
                spec.append({"name": name, "type": "int",
                             "lb": dom.low, "ub": dom.high - 1})
            elif isinstance(dom, LogUniform):
                spec.append({"name": name, "type": "pow",
                             "lb": dom.low, "ub": dom.high})
            elif isinstance(dom, (Uniform, QUniform)):
                spec.append({"name": name, "type": "num",
                             "lb": dom.low, "ub": dom.high})
        space = self._ds_mod.DesignSpace().parse(spec)
        self._opt = self._hebo_mod.HEBO(space)

    def suggest(self, trial_id):
        self._ensure_opt()
        rec = self._opt.suggest(n_suggestions=1)
        flat = {k: rec[k].iloc[0] for k in rec.columns}
        # numpy scalars -> python for config cleanliness
        flat = {k: (v.item() if hasattr(v, "item") else v)
                for k, v in flat.items()}
        self._rows[trial_id] = rec
        return self._build_cfg(flat)

    def on_trial_complete(self, trial_id, result=None):
        import numpy as np

        rec = self._rows.pop(trial_id, None)
        if rec is None:
            return
        loss = self._objective(result, minimize=True)
        if loss is not None:
            self._opt.observe(rec, np.array([[loss]]))


# ------------------------------------------------------------------ skopt


class SkoptSearch(_ExternalSearcher):
    """Adapter over ``skopt.Optimizer`` (ask/tell; minimizes).

    Reference analog: ``python/ray/tune/search/skopt/skopt_search.py``.
    """

    _package = "scikit-optimize"

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._skopt = _import("skopt", "scikit-optimize")
        self._seed = seed
        self._opt = None
        self._names: List[str] = []
        self._points: Dict[str, list] = {}

    def _ensure_opt(self):
        if self._opt is not None:
            return
        space = []
        self._names = []
        sk = self._skopt.space
        for name, dom in self._flat_dims():
            self._names.append(name)
            if isinstance(dom, Categorical):
                space.append(sk.Categorical(dom.categories, name=name))
            elif isinstance(dom, Randint):
                space.append(sk.Integer(dom.low, dom.high - 1, name=name))
            elif isinstance(dom, LogUniform):
                space.append(sk.Real(dom.low, dom.high,
                                     prior="log-uniform", name=name))
            elif isinstance(dom, (Uniform, QUniform)):
                space.append(sk.Real(dom.low, dom.high, name=name))
        self._opt = self._skopt.Optimizer(space, random_state=self._seed)

    def suggest(self, trial_id):
        self._ensure_opt()
        point = self._opt.ask()
        self._points[trial_id] = point
        return self._build_cfg(dict(zip(self._names, point)))

    def on_trial_complete(self, trial_id, result=None):
        point = self._points.pop(trial_id, None)
        if point is None:
            return
        loss = self._objective(result, minimize=True)
        if loss is not None:
            self._opt.tell(point, loss)


# ------------------------------------------------------------------- bohb


class BOHBSearcher(TPESearcher):
    """Budget-stratified TPE — the model half of BOHB, natively.

    Reference analog: ``python/ray/tune/search/bohb/bohb_search.py`` (which
    wraps hpbandster's ConfigSpace KDE). BOHB's insight is that the TPE-style
    density model should be fit on observations from a single fidelity —
    the highest budget with enough points — rather than mixing cheap and
    expensive evaluations. Pair with ``HyperBandScheduler`` or
    ``ASHAScheduler``, which provide the other half (the successive-halving
    budget allocation): the scheduler stops trials at rung boundaries and
    this searcher models on whatever per-rung observations accumulate.

    ``budget_key`` names the result field used as the fidelity (default
    ``training_iteration``).
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 budget_key: str = "training_iteration",
                 n_initial: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        super().__init__(metric, mode, n_initial=n_initial, gamma=gamma,
                         n_candidates=n_candidates, seed=seed)
        self.budget_key = budget_key
        self._obs_by_budget: Dict[float, List[tuple]] = {}

    def on_trial_result(self, trial_id, result):
        cfg = self._live.get(trial_id)
        score = self._score(result)
        budget = (result or {}).get(self.budget_key)
        if cfg is None or score is None or budget is None:
            return
        self._obs_by_budget.setdefault(float(budget), []).append((cfg, score))

    def on_trial_complete(self, trial_id, result=None):
        # The final report was already recorded per-budget by
        # on_trial_result (the controller forwards every report); all that
        # remains is releasing the live slot. A result that carries no
        # budget key still contributes at fidelity 0.
        if result is not None:
            score = self._score(result)
            cfg = self._live.get(trial_id)
            if (cfg is not None and score is not None
                    and self.budget_key not in result):
                self._obs_by_budget.setdefault(0.0, []).append((cfg, score))
        self._live.pop(trial_id, None)

    def suggest(self, trial_id):
        pool: List[tuple] = []
        for budget in sorted(self._obs_by_budget, reverse=True):
            pool = self._obs_by_budget[budget]
            if len(pool) >= self.n_initial:
                break
        self._obs = list(pool)  # TPESearcher models over self._obs
        return super().suggest(trial_id)
