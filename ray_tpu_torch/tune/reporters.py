"""Progress reporters: periodic trial-status tables during a run.

Reference: ``python/ray/tune/progress_reporter.py`` (``CLIReporter`` /
``JupyterNotebookReporter``). Implemented as experiment callbacks — the
Tune loop already fans results into callbacks, so reporters ride the
same hook surface instead of a second reporting channel.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional

from .callback import Callback


class ProgressReporter(Callback):
    """Base: collects per-trial state, renders every ``max_report_freq``
    seconds and at experiment end."""

    def __init__(self, *, metric_columns: Optional[List[str]] = None,
                 parameter_columns: Optional[List[str]] = None,
                 max_report_frequency: float = 5.0,
                 max_progress_rows: int = 20):
        self.metric_columns = list(metric_columns or [])
        self.parameter_columns = list(parameter_columns or [])
        self.max_report_frequency = max_report_frequency
        self.max_progress_rows = max_progress_rows
        self._trials: Dict[str, Any] = {}
        self._last = 0.0

    # -- Callback hooks -------------------------------------------------
    def setup(self, experiment_path: str):
        self._path = experiment_path

    def on_trial_start(self, trial):
        self._trials[trial.id] = trial
        self._maybe_report()

    def on_trial_result(self, trial, result: Dict[str, Any]):
        self._trials[trial.id] = trial
        self._maybe_report()

    def on_trial_complete(self, trial):
        self._trials[trial.id] = trial
        self._maybe_report()

    def on_trial_error(self, trial):
        self._trials[trial.id] = trial
        self._maybe_report()

    def on_experiment_end(self, trials):
        for t in trials:
            self._trials[t.id] = t
        self.report(force=True)

    # -- rendering ------------------------------------------------------
    def _maybe_report(self):
        now = time.time()
        if now - self._last >= self.max_report_frequency:
            self.report()

    def _columns(self) -> List[str]:
        if self.metric_columns:
            return self.metric_columns
        cols: List[str] = []
        for t in self._trials.values():
            for k, v in (t.last_result or {}).items():
                if isinstance(v, (int, float)) and k not in cols:
                    cols.append(k)
        return cols[:4]

    def render(self) -> str:
        states = {}
        for t in self._trials.values():
            states[t.state] = states.get(t.state, 0) + 1
        header = (f"== Status == {len(self._trials)} trials: "
                  + ", ".join(f"{n} {s}" for s, n in sorted(states.items())))
        cols = self._columns()
        pcols = self.parameter_columns
        names = ["trial", "status"] + pcols + cols
        rows = [names]
        for tid in sorted(self._trials)[:self.max_progress_rows]:
            t = self._trials[tid]
            res = t.last_result or {}
            row = [tid, t.state]
            row += [str(_dig(t.config, p)) for p in pcols]
            row += [_fmt(res.get(c)) for c in cols]
            rows.append(row)
        widths = [max(len(r[i]) for r in rows) for i in range(len(names))]
        lines = [header]
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("-" * (sum(widths) + 2 * (len(widths) - 1)))
        return "\n".join(lines)

    def report(self, force: bool = False):
        self._last = time.time()
        self._emit(self.render())

    def _emit(self, text: str):
        raise NotImplementedError


def _dig(config: dict, dotted: str):
    cur: Any = config
    for part in dotted.split("/"):
        if not isinstance(cur, dict):
            return ""
        cur = cur.get(part)
    return cur


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


class CLIReporter(ProgressReporter):
    """Table to stdout (reference: ``tune.CLIReporter``)."""

    def _emit(self, text: str):
        print(text, file=sys.stdout, flush=True)


class JupyterNotebookReporter(ProgressReporter):
    """Re-rendering display for notebooks; falls back to stdout when
    IPython is absent (reference: ``tune.JupyterNotebookReporter``)."""

    def _emit(self, text: str):
        try:
            from IPython.display import clear_output, display

            clear_output(wait=True)
            display({"text/plain": text}, raw=True)
        except ImportError:
            print(text, file=sys.stdout, flush=True)
