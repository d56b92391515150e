"""Experiment-tracking integrations: Weights & Biases + MLflow.

Reference: ``python/ray/air/integrations/wandb.py`` (WandbLoggerCallback)
and ``python/ray/air/integrations/mlflow.py`` (MLflowLoggerCallback) — the
reference attaches one tracking run per Tune trial and streams reported
metrics into it.

Neither wandb nor mlflow ships in this cluster image, so both callbacks
import lazily at construction (actionable ImportError when absent) and the
translation logic — one run per trial, config as params, metrics streamed
with steps, terminal status mapping — is exercised against API-faithful
fakes in ``tests/test_tune_integrations.py`` (same testing pattern as the
external searchers in ``external.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .callback import LoggerCallback
from .external import _import


class WandbLoggerCallback(LoggerCallback):
    """One W&B run per trial; reported results stream via ``run.log``.

    ``project`` is required (reference behavior); ``group`` defaults to
    the experiment directory name so all trials of one experiment land in
    one W&B group.
    """

    def __init__(self, project: str, group: Optional[str] = None,
                 **init_kwargs: Any):
        self._wandb = _import("wandb", "wandb")
        self.project = project
        self.group = group
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def setup(self, experiment_path: str):
        import os

        if self.group is None:
            self.group = os.path.basename(experiment_path)

    def log_trial_start(self, trial):
        self._runs[trial.id] = self._wandb.init(
            project=self.project, group=self.group, name=trial.id,
            config=dict(trial.config), reinit=True, dir=trial.logdir,
            **self.init_kwargs)

    def log_trial_result(self, trial, result):
        run = self._runs.get(trial.id)
        if run is None:
            return
        metrics = {k: v for k, v in result.items()
                   if isinstance(v, (int, float, str, bool))}
        run.log(metrics, step=result.get("training_iteration"))

    def log_trial_end(self, trial, failed: bool):
        run = self._runs.pop(trial.id, None)
        if run is not None:
            run.finish(exit_code=1 if failed else 0)


class MLflowLoggerCallback(LoggerCallback):
    """One MLflow run per trial via the thread-safe ``MlflowClient`` API
    (the fluent ``mlflow.start_run`` allows one active run — unusable with
    concurrent trials, which is why the reference also drives the client
    API)."""

    def __init__(self, tracking_uri: Optional[str] = None,
                 experiment_name: Optional[str] = None,
                 tags: Optional[Dict[str, str]] = None):
        self._mlflow = _import("mlflow", "mlflow")
        self.tracking_uri = tracking_uri
        self.experiment_name = experiment_name
        self.tags = tags or {}
        self._client = None
        self._experiment_id = None
        self._runs: Dict[str, str] = {}  # trial id -> mlflow run id

    def setup(self, experiment_path: str):
        import os

        self._client = self._mlflow.tracking.MlflowClient(
            tracking_uri=self.tracking_uri)
        name = self.experiment_name or os.path.basename(experiment_path)
        exp = self._client.get_experiment_by_name(name)
        if exp is not None:
            self._experiment_id = exp.experiment_id
        else:
            self._experiment_id = self._client.create_experiment(name)

    def log_trial_start(self, trial):
        run = self._client.create_run(
            self._experiment_id,
            tags={**self.tags, "trial_id": trial.id})
        self._runs[trial.id] = run.info.run_id
        for k, v in trial.config.items():
            self._client.log_param(run.info.run_id, k, v)

    def log_trial_result(self, trial, result):
        run_id = self._runs.get(trial.id)
        if run_id is None:
            return
        step = int(result.get("training_iteration") or 0)
        for k, v in result.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._client.log_metric(run_id, k, float(v), step=step)

    def log_trial_end(self, trial, failed: bool):
        run_id = self._runs.pop(trial.id, None)
        if run_id is not None:
            self._client.set_terminated(
                run_id, status="FAILED" if failed else "FINISHED")
