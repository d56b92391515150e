from ..train.session import get_checkpoint, get_context, report
from .schedulers import (ASHAScheduler, FIFOScheduler, HyperBandScheduler,
                         MedianStoppingRule, PB2,
                         PopulationBasedTraining,
                         ResourceChangingScheduler,
                         evenly_distribute_cpus)
from .search import (
    BasicVariantGenerator,
    BayesOptSearcher,
    ConcurrencyLimiter,
    Searcher,
    TPESearcher,
    choice,
    grid_search,
    lograndint,
    loguniform,
    qlograndint,
    qloguniform,
    qrandint,
    qrandn,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from .registry import register_env, register_trainable
from .reporters import (
    CLIReporter,
    JupyterNotebookReporter,
    ProgressReporter,
)
from .trainable import (
    PlacementGroupFactory,
    Trainable,
    with_parameters,
    with_resources,
)
from .external import (
    AxSearch,
    BOHBSearcher,
    HEBOSearch,
    HyperOptSearch,
    NevergradSearch,
    OptunaSearch,
    SkoptSearch,
)
from .callback import (
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
    LoggerCallback,
    TBXLoggerCallback,
)
from .integrations import MLflowLoggerCallback, WandbLoggerCallback
from .stopper import (
    CombinedStopper,
    DictStopper,
    ExperimentPlateauStopper,
    FunctionStopper,
    MaximumIterationStopper,
    NoopStopper,
    Stopper,
    TimeoutStopper,
    TrialPlateauStopper,
)
from .tuner import ResultGrid, TuneConfig, Tuner


def run(trainable, *, config=None, num_samples=1, metric=None, mode="max",
        scheduler=None, search_alg=None, name=None, storage_path=None,
        stop=None, callbacks=None, **kw):
    """``tune.run`` compatibility wrapper around ``Tuner`` (reference:
    ``python/ray/tune/tune.py:267``)."""
    from ..train.config import RunConfig

    tuner = Tuner(
        trainable, param_space=config or {},
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples, scheduler=scheduler,
                               search_alg=search_alg),
        run_config=RunConfig(name=name, storage_path=storage_path,
                             stop=stop, callbacks=callbacks))
    return tuner.fit()


class TuneError(Exception):
    """Tune-level failure (reference: ``ray.tune.TuneError``)."""


from dataclasses import dataclass as _dc


@_dc
class ResumeConfig:
    """What to do with unfinished/errored trials on ``Tuner.restore``
    (reference: ``tune.ResumeConfig``)."""

    resume_unfinished: bool = True
    resume_errored: bool = False
    restart_errored: bool = False


@_dc
class Experiment:
    """Declarative experiment spec for ``run_experiments`` (reference:
    ``tune.Experiment`` — the legacy multi-experiment front door)."""

    name: str
    run: object                  # trainable (callable/class/registry name)
    config: dict = None
    num_samples: int = 1
    stop: object = None
    storage_path: str = None


def run_experiments(experiments, **kw):
    """Run one or more Experiments sequentially; returns all results
    (reference: ``tune.run_experiments``)."""
    if isinstance(experiments, Experiment):
        experiments = [experiments]
    out = []
    for exp in experiments:
        grid = run(exp.run, config=exp.config or {},
                   num_samples=exp.num_samples, name=exp.name,
                   storage_path=exp.storage_path, stop=exp.stop, **kw)
        out.extend(list(grid))
    return out


class ExperimentAnalysis:
    """Legacy analysis facade over a ResultGrid (reference:
    ``tune.ExperimentAnalysis``)."""

    def __init__(self, result_grid: ResultGrid,
                 default_metric=None, default_mode="max"):
        self._grid = result_grid
        self.default_metric = default_metric
        self.default_mode = default_mode

    @property
    def trials(self):
        return list(self._grid)

    def get_best_result(self, metric=None, mode=None):
        return self._grid.get_best_result(
            metric or self.default_metric, mode or self.default_mode)

    def get_best_config(self, metric=None, mode=None) -> dict:
        return self.get_best_result(metric, mode).config

    def get_best_logdir(self, metric=None, mode=None):
        return self.get_best_result(metric, mode).path

    def dataframe(self):
        return self._grid.get_dataframe()


_SEARCHERS = {
    "random": lambda **kw: None,  # BasicVariantGenerator is the default
    "variant_generator": lambda **kw: None,
    "tpe": TPESearcher,
    "bayesopt": BayesOptSearcher,
    "optuna": OptunaSearch,
    "hyperopt": HyperOptSearch,
    "ax": AxSearch,
    "nevergrad": NevergradSearch,
    "hebo": HEBOSearch,
    "skopt": SkoptSearch,
    "bohb": BOHBSearcher,
}

_SCHEDULERS = {
    "fifo": FIFOScheduler,
    "asha": ASHAScheduler,
    "async_hyperband": ASHAScheduler,
    "hyperband": HyperBandScheduler,
    "median_stopping_rule": MedianStoppingRule,
    "pbt": PopulationBasedTraining,
    "pb2": PB2,
}


def create_searcher(search_alg: str, **kwargs):
    """Searcher by name (reference: ``tune.create_searcher``)."""
    try:
        factory = _SEARCHERS[search_alg.lower()]
    except KeyError:
        raise ValueError(f"unknown searcher {search_alg!r}; "
                         f"have {sorted(_SEARCHERS)}") from None
    return factory(**kwargs)


def create_scheduler(scheduler: str, **kwargs):
    """Scheduler by name (reference: ``tune.create_scheduler``)."""
    try:
        factory = _SCHEDULERS[scheduler.lower()]
    except KeyError:
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         f"have {sorted(_SCHEDULERS)}") from None
    return factory(**kwargs)


__all__ = [
    "ResourceChangingScheduler", "evenly_distribute_cpus",
    "Tuner", "TuneConfig", "ResultGrid", "run", "report", "get_context",
    "get_checkpoint", "choice", "uniform", "loguniform", "randint",
    "quniform", "sample_from", "grid_search", "FIFOScheduler",
    "ASHAScheduler", "PopulationBasedTraining", "PB2", "HyperBandScheduler",
    "MedianStoppingRule", "Searcher", "BasicVariantGenerator",
    "TPESearcher", "BayesOptSearcher", "ConcurrencyLimiter",
    "OptunaSearch", "HyperOptSearch", "AxSearch", "NevergradSearch",
    "HEBOSearch", "SkoptSearch", "BOHBSearcher",
    "Callback", "LoggerCallback", "JsonLoggerCallback",
    "CSVLoggerCallback", "TBXLoggerCallback",
    "WandbLoggerCallback", "MLflowLoggerCallback",
    "Stopper", "NoopStopper", "FunctionStopper", "DictStopper",
    "MaximumIterationStopper", "TimeoutStopper", "TrialPlateauStopper",
    "ExperimentPlateauStopper", "CombinedStopper",
    "Trainable", "with_parameters", "with_resources",
    "PlacementGroupFactory", "register_env", "register_trainable",
    "lograndint", "qrandint", "qlograndint", "randn", "qrandn",
    "qloguniform", "CLIReporter", "JupyterNotebookReporter",
    "ProgressReporter", "TuneError", "ResumeConfig", "Experiment",
    "run_experiments", "ExperimentAnalysis", "create_searcher",
    "create_scheduler",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('tune')
del _rlu
