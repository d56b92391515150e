"""The port's ``tune`` against the JAX package's, on the CPU.

The plain parts run in this process on both packages with the same
inputs: ``generate_variants`` and the searchers draw the same configs from
the same seeds, every scheduler and stopper takes the same decisions (and
PBT and PB2 the same donors and mutations) on the same report stream, and
the JSON, CSV and TBX loggers write files that parse to the same records.
The modules copied as they are must be the reference's code but for the
package's name.

The rest runs on one module-scoped cluster of each package. An
interrupted experiment (an errored trial) resumes through
``Tuner.restore`` to the same grid on both. A trial given
``{"GPU": 0.5}``, or a ``TorchTrainer`` that uses the GPU, is leased the
port cluster's one GPU (declared as a resource: no card is probed) and
pinned to it, and refuses to train on the CPU. The slice as a whole: a
Tuner under ASHA sweeps an lr grid over ``TorchTrainer`` trials of
``LLAMA_DEBUG`` (fp32) and the same Tuner sweeps ``JaxTrainer`` trials on
the JAX package's cluster, from the same weights and tokens: the same
trials stop at the same iterations, every reported loss agrees within
1e-5 and the best config is the same. PBT over a small fp32 ViT
``Trainable`` on the port exploits a donor, and the clone's restored
parameters and AdamW state are the donor checkpoint's, bit for bit.

Trainables are defined inside the tests, so cloudpickle ships them by
value and no port worker imports this module (which imports JAX). The
fixture shuts both clusters down and removes the port's arenas and
session directory, failures included.
"""

import ast
import csv
import glob
import importlib
import json
import os
import pathlib
import re
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jllama

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtn", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(num_cpus=8, probe_tpu=False, ignore_reinit_error=True)
        # one GPU as a resource only (no card is probed): the GPU trials
        ray_tpu_torch.init(num_cpus=8, num_gpus=1, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield {"jax": ray_tpu, "port": ray_tpu_torch}
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in glob.glob("/dev/shm/rtpt*"):
                if session and session[-8:] in p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            shutil.rmtree(root, ignore_errors=True)


def _tune(name):
    return importlib.import_module(f"{name}.tune")


def _both(scenario):
    """``scenario(package name)`` on both packages: (jax, port)."""
    return tuple(scenario(n) for n in ("ray_tpu", "ray_tpu_torch"))


def _both_at_once(scenario):
    """``_both`` with the two packages' scenarios run at once, each on its
    own cluster."""
    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(scenario, n)
                         for n in ("ray_tpu", "ray_tpu_torch"))
        return jax_f.result(), port_f.result()


# ---------------------------------------------------------------- the copies

# Modules copied from the reference with only their names changed; the
# tuner and the trainables differ as CHANGES.md lists.
VERBATIM = ("tune/__init__.py", "tune/registry.py", "tune/search.py",
            "tune/schedulers.py", "tune/stopper.py", "tune/callback.py",
            "tune/reporters.py", "tune/external.py", "tune/integrations.py")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM)
def test_tune_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)


# ------------------------------------------------------------ search spaces


def _space(tune):
    return {"a": tune.grid_search([1, 2]),
            "b": tune.choice(["p", "q", "r"]),
            "c": tune.randint(0, 10),
            "d": tune.loguniform(1e-4, 1e-1),
            "e": tune.uniform(-1.0, 1.0),
            "f": tune.quniform(0, 1, 0.25),
            "g": tune.qrandint(0, 20, 5),
            "h": tune.randn(0.0, 2.0),
            "i": tune.lograndint(1, 100),
            "nested": {"j": tune.grid_search([10, 20]), "k": "const"}}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_variants_draw_the_same_configs(seed):
    def scenario(name):
        tune = _tune(name)
        search = importlib.import_module(f"{name}.tune.search")
        return search.generate_variants(_space(tune), num_samples=3,
                                        seed=seed)

    jax_out, port_out = _both(scenario)
    assert jax_out == port_out and len(port_out) == 2 * 2 * 3


def _objective(cfg):
    """A deterministic score of a config, for the searchers to learn."""
    return -(cfg["x"] - 0.3) ** 2 - 0.1 * (np.log10(cfg["lr"]) + 3) ** 2


SEARCHERS = ("basic", "tpe", "bayesopt", "limited_tpe")


@pytest.mark.parametrize("which", SEARCHERS)
def test_searchers_suggest_the_same_configs(which):
    def scenario(name):
        tune = _tune(name)
        space = {"x": tune.uniform(0.0, 1.0),
                 "lr": tune.loguniform(1e-5, 1e-1)}
        if which == "basic":
            s = tune.BasicVariantGenerator(num_samples=12, seed=3)
        elif which == "tpe":
            s = tune.TPESearcher(n_initial=4, seed=3)
        elif which == "bayesopt":
            s = tune.BayesOptSearcher(n_initial=3, n_candidates=64, seed=3)
        else:
            s = tune.ConcurrencyLimiter(tune.TPESearcher(n_initial=3,
                                                         seed=5), 2)
        s.set_search_properties("score", "max", space)
        out, live = [], []
        for i in range(12):
            tid = f"t{i}"
            cfg = s.suggest(tid)
            out.append(cfg)
            if cfg is not None:
                live.append((tid, cfg))
            if cfg is None or len(live) >= 2 or i % 3 == 2:
                for done, c in live:
                    s.on_trial_complete(done, {"score": _objective(c)})
                live = []
        return out

    jax_out, port_out = _both(scenario)
    assert jax_out == port_out
    assert sum(c is not None for c in port_out) >= 8


# --------------------------------------------------- schedulers and stoppers


def _report_stream(seed, n_trials=6, max_t=9):
    """Interleaved reports of ``n_trials`` trials: each trial's metric
    follows its own noisy curve; the order of arrival is shuffled within
    each iteration."""
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0.05, 0.6, n_trials)
    out = []
    for t in range(1, max_t + 1):
        for i in rng.permutation(n_trials):
            value = float(1.0 - np.exp(-rates[i] * t)
                          + rng.normal(0, 0.02))
            out.append((f"trial_{i:04d}", {"training_iteration": t,
                                           "score": value,
                                           "lr": float(rates[i])}))
    return out


def _schedulers(tune, which):
    if which == "asha":
        return tune.ASHAScheduler(metric="score", mode="max", max_t=9,
                                  grace_period=1, reduction_factor=2)
    if which == "asha_min":
        return tune.ASHAScheduler(metric="score", mode="min", max_t=8,
                                  grace_period=2, reduction_factor=3)
    if which == "hyperband":
        return tune.HyperBandScheduler(metric="score", mode="max", max_t=9,
                                       reduction_factor=3)
    if which == "median":
        return tune.MedianStoppingRule(metric="score", mode="max",
                                       grace_period=2,
                                       min_samples_required=2)
    if which == "pbt":
        return tune.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [0.1, 0.2, 0.3],
                                  "momentum": tune.uniform(0.8, 0.99)},
            seed=11)
    if which == "pb2":
        return tune.PB2(metric="score", mode="max", perturbation_interval=2,
                        hyperparam_bounds={"lr": [0.01, 1.0]}, seed=11)
    if which == "resource_changing":
        return tune.ResourceChangingScheduler(
            tune.ASHAScheduler(metric="score", mode="max", max_t=9),
            tune.evenly_distribute_cpus(8))
    raise ValueError(which)


SCHEDULERS = ("asha", "asha_min", "hyperband", "median", "pbt", "pb2",
              "resource_changing")


@pytest.mark.parametrize("which", SCHEDULERS)
@pytest.mark.parametrize("seed", [0, 5])
def test_schedulers_decide_the_same(which, seed):
    def scenario(name):
        sched = _schedulers(_tune(name), which)
        configs = {}
        out = []
        for tid, result in _report_stream(seed):
            cfg = configs.setdefault(tid, {"lr": result["lr"],
                                           "momentum": 0.9})
            if hasattr(sched, "record_config"):
                sched.record_config(tid, dict(cfg))
            if hasattr(sched, "set_trial_resources") and \
                    tid not in sched._current:
                sched.set_trial_resources(tid, {"CPU": 1.0})
            decision = sched.on_result(tid, result)
            row = [tid, result["training_iteration"], decision]
            if decision == "exploit":
                donor = sched.exploit_target(tid)
                row += [donor, sched.mutate(dict(configs[donor]))
                        if donor else None]
            if decision == "reallocate":
                row.append(sched.pending_resources.pop(tid))
            out.append(row)
        return out

    jax_out, port_out = _both(scenario)
    assert jax_out == port_out
    decisions = {row[2] for row in port_out}
    assert decisions - {"continue"}, f"{which}: no decision but continue"


STOPPERS = ("dict", "max_iter", "trial_plateau", "experiment_plateau",
            "combined", "function", "timeout")


@pytest.mark.parametrize("which", STOPPERS)
def test_stoppers_decide_the_same(which):
    def scenario(name):
        tune = _tune(name)
        make = {
            "dict": lambda: tune.DictStopper({"score": 0.8,
                                              "training_iteration": 7}),
            "max_iter": lambda: tune.MaximumIterationStopper(5),
            "trial_plateau": lambda: tune.TrialPlateauStopper(
                "score", std=0.05, num_results=3, grace_period=3),
            "experiment_plateau": lambda: tune.ExperimentPlateauStopper(
                "score", mode="max", patience=6, epsilon=0.01),
            "combined": lambda: tune.CombinedStopper(
                tune.MaximumIterationStopper(6),
                tune.TrialPlateauStopper("score", std=0.02,
                                         num_results=2, grace_period=2)),
            "function": lambda: tune.FunctionStopper(
                lambda tid, r: r["score"] > 0.5 and tid.endswith("1")),
            "timeout": lambda: tune.TimeoutStopper(3600),
        }[which]
        stopper = make()
        return [(tid, bool(stopper(tid, r)), bool(stopper.stop_all()))
                for tid, r in _report_stream(3)]

    jax_out, port_out = _both(scenario)
    assert jax_out == port_out
    if which != "timeout":
        assert any(s or a for _, s, a in port_out)


# ------------------------------------------------------------------ loggers


class _Trial:
    def __init__(self, tid, logdir, config):
        self.id, self.logdir, self.config = tid, logdir, config
        self.last_result = None


def _log_records(name, root):
    """The JSON, CSV and TBX loggers over two trials' reports; each file
    parsed back (event wall times left out)."""
    tune = _tune(name)
    callback = importlib.import_module(f"{name}.tune.callback")
    loggers = [tune.JsonLoggerCallback(), tune.CSVLoggerCallback(),
               tune.TBXLoggerCallback()]
    trials = [_Trial(f"trial_{i}", os.path.join(root, f"trial_{i}"),
                     {"lr": 0.1 * (i + 1), "tag": f"t{i}", "fn": len})
              for i in range(2)]
    for cb in loggers:
        cb.setup(root)
    for t in trials:
        for cb in loggers:
            cb.on_trial_start(t)
    for tid, result in _report_stream(2, n_trials=2, max_t=4):
        t = trials[int(tid[-1])]
        result = dict(result, note="x", flag=True)
        for cb in loggers:
            cb.on_trial_result(t, result)
    for cb in loggers:
        cb.on_trial_complete(trials[0])
        cb.on_trial_error(trials[1])
        cb.on_experiment_end(trials)
    out = {}
    for t in trials:
        with open(os.path.join(t.logdir, "params.json")) as f:
            params = json.load(f)
        params["fn"] = params["fn"].split(" at ")[0]
        with open(os.path.join(t.logdir, "result.json")) as f:
            results = [json.loads(line) for line in f]
        with open(os.path.join(t.logdir, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        (events,) = glob.glob(os.path.join(t.logdir, "events.out.tfevents.*"))
        scalars = [{k: v for k, v in ev.items() if k != "wall_time"}
                   for ev in callback.decode_scalar_events(events)]
        out[t.id] = (params, results, rows, scalars)
    return out


def test_loggers_write_the_same_records(tmp_path):
    jax_out = _log_records("ray_tpu", str(tmp_path / "jax"))
    port_out = _log_records("ray_tpu_torch", str(tmp_path / "port"))
    assert jax_out == port_out
    params, results, rows, scalars = port_out["trial_0"]
    assert len(results) == len(rows) == 4 and len(scalars) == 5
    assert scalars[1]["scalars"]["ray/tune/training_iteration"] == 1.0


# --------------------------------------------------- optional packages

OPTIONAL = {"MLflowLoggerCallback": {}, "WandbLoggerCallback":
            {"project": "p"}, "OptunaSearch": {}, "HyperOptSearch": {},
            "AxSearch": {}, "NevergradSearch": {}, "HEBOSearch": {},
            "SkoptSearch": {}}


@pytest.mark.parametrize("name", OPTIONAL)
def test_missing_packages_raise_the_same_actionable_errors(name):
    """The adapters and loggers import their package when they are built,
    and without it raise the reference's ImportError (pandas, optuna,
    mlflow and the like are not on the H100 machine)."""
    def scenario(pkg):
        try:
            getattr(_tune(pkg), name)(**OPTIONAL[name])
        except ImportError as e:
            return str(e)
        return None

    jax_out, port_out = _both(scenario)
    assert jax_out == port_out
    assert port_out is None or "install" in port_out


# ------------------------------------------------------------------ restore


def _restore_scenario(name, tmp_path):
    """The reference's interrupted experiment: two of four trials crash at
    iteration 3 on their first run; ``Tuner.restore(restart_errored=True)``
    re-runs them from their iteration-2 checkpoints.

    A finished trial's persisted last result is what the restore keeps.
    The JAX package's tuner records it from the reports it has drained
    when the trial's run returns, which under load can be an earlier
    iteration's. So on the JAX package's first run each trial waits,
    after its last report, until a callback has seen that report drained.
    The port's tuner drains a finished trial's reports first, and its
    trials run unaided (test_a_finished_trial_keeps_its_last_report
    holds that alone)."""
    tune = _tune(name)
    train = importlib.import_module(f"{name}.train")
    storage = tmp_path / name
    marker_dir = storage / "markers"
    marker_dir.mkdir(parents=True)

    class Drained(tune.Callback):
        def on_trial_result(self, trial, result):
            config = trial.config
            (marker_dir / f"drained_{config['idx']}_"
             f"{int(bool(config['crash']))}_{result['training_iteration']}"
             ).write_text("x")

    def trainable(config):
        import json
        import os
        import tempfile
        import time

        tune = __import__(f"{config['pkg']}.tune", fromlist=["tune"])
        Checkpoint = __import__(f"{config['pkg']}.train",
                                fromlist=["train"]).Checkpoint
        marker = (config["marker_dir"]
                  + f"/ran_{config['idx']}_{int(bool(config['crash']))}")
        with open(marker, "a") as f:
            f.write("x")
        attempts = os.path.getsize(marker)
        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["it"]
        for it in range(start + 1, 5):
            if config["crash"] and attempts == 1 and it == 3:
                raise RuntimeError("injected crash")
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"it": it}, f)
            tune.report({"score": it * (config["idx"] + 1),
                         "resumed_from": start, "training_iteration": it},
                        checkpoint=Checkpoint(d))
        drained = (config["marker_dir"] + f"/drained_{config['idx']}_"
                   f"{int(bool(config['crash']))}_4")
        deadline = time.time() + 60
        while config["pkg"] == "ray_tpu" and attempts == 1 \
                and not os.path.exists(drained) and time.time() < deadline:
            time.sleep(0.02)

    def summary(grid):
        return sorted((r.config["idx"], r.config["crash"],
                       r.error is None, (r.metrics or {}).get("score"),
                       (r.metrics or {}).get("resumed_from"),
                       os.path.basename(r.checkpoint.path)
                       if r.checkpoint else None) for r in grid)

    grid = tune.Tuner(
        trainable,
        param_space={"idx": tune.grid_search([0, 1]),
                     "crash": tune.grid_search([True, False]),
                     "marker_dir": str(marker_dir), "pkg": name},
        tune_config=tune.TuneConfig(metric="score", mode="max"),
        run_config=train.RunConfig(name="exp", storage_path=str(storage),
                                   callbacks=[Drained()])).fit()
    first = summary(grid)
    exp = str(storage / "exp")
    assert tune.Tuner.can_restore(exp)
    grid2 = tune.Tuner.restore(exp, restart_errored=True).fit()
    frame = grid2.get_dataframe().sort_values(["score", "resumed_from"])
    return (first, summary(grid2), grid2.get_best_result().config["idx"],
            list(frame.columns), frame[["score", "resumed_from"]].values
            .tolist())


def test_restore_resumes_to_the_same_grid(clusters, tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_DISABLE_DEFAULT_LOGGERS", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_DISABLE_DEFAULT_LOGGERS", "1")
    jax_out, port_out = _both_at_once(
        lambda n: _restore_scenario(n, tmp_path))
    assert jax_out == port_out
    first, second, best, _, frame = port_out
    assert [row[2] for row in first].count(False) == 2
    assert all(row[2] for row in second) and len(second) == 4
    assert sorted(row[4] for row in second) == [0, 0, 2, 2]
    assert best == 1 and len(frame) == 4


def test_a_finished_trial_keeps_its_last_report(clusters, tmp_path,
                                                monkeypatch):
    """The port's tuner persists a finished trial's last report where
    that report lands, and the trial's run returns, while the tuner is
    busy with the one before: a callback holds the tuner at iteration 3
    while the trial reports iteration 4 and returns. A restore keeps
    what was persisted."""
    monkeypatch.setenv("RAY_TPU_TORCH_DISABLE_DEFAULT_LOGGERS", "1")
    tune = _tune("ray_tpu_torch")

    class Busy(tune.Callback):
        def on_trial_result(self, trial, result):
            if result["training_iteration"] == 3:
                time.sleep(1.0)

    def trainable(config):
        import time

        from ray_tpu_torch import tune

        for it in range(1, 5):
            if it == 4:  # the tuner drains iteration 3 alone meanwhile
                time.sleep(0.2)
            tune.report({"score": it * (config["idx"] + 1),
                         "training_iteration": it})

    def summary(grid):
        return sorted((r.config["idx"], r.metrics["training_iteration"],
                       r.metrics["score"]) for r in grid)

    grid = tune.Tuner(
        trainable, param_space={"idx": tune.grid_search([0, 1])},
        # one at a time: the last trial's run ends the loop, with no later
        # drain to mend its record
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=1),
        run_config=importlib.import_module("ray_tpu_torch.train").RunConfig(
            name="last", storage_path=str(tmp_path),
            callbacks=[Busy()])).fit()
    # the grid reads the reports' history; a restore reads the persisted
    # last result of each finished trial
    restored = tune.Tuner.restore(str(tmp_path / "last")).fit()
    want = [(i, 4, 4 * (i + 1)) for i in range(2)]
    assert summary(grid) == want
    assert summary(restored) == want


def test_the_collector_hands_reports_over_in_arrival_order():
    """C10: the tuner's drains give the scheduler the reports in the order
    they came, so PBT ranks a trial's report beside the others' reports
    made before it. Trial b reports iteration 1, trial a then reports
    iteration 1, and b reports iteration 2 with a worse loss: in arrival
    order b is in the bottom quantile at its perturbation and is
    exploited; handed over trial by trial (b's two reports, then a's), b
    is alone at its perturbation and PBT keeps it."""
    from ray_tpu_torch.tune.schedulers import EXPLOIT
    from ray_tpu_torch.tune.tuner import _TuneCollector

    collector = _TuneCollector._cls()
    pushes = [("b", {"loss": 5.0, "training_iteration": 1}),
              ("a", {"loss": 1.0, "training_iteration": 1}),
              ("b", {"loss": 9.0, "training_iteration": 2})]
    for tid, metrics in pushes:
        collector.push(tid, metrics, None)
    drained = collector.new_reports()
    assert drained == pushes
    assert collector.new_reports() == []

    def decisions(order):
        pbt = _tune("ray_tpu_torch").PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-3]}, seed=3)
        return [(tid, m["training_iteration"], pbt.on_result(tid, m))
                for tid, m in order]

    assert decisions(drained)[-1] == ("b", 2, EXPLOIT)
    by_trial = sorted(pushes, key=lambda p: p[0] != "b")
    assert decisions(by_trial)[1][2] != EXPLOIT


def test_an_exploit_reached_after_the_trial_returned_still_clones(
        clusters, tmp_path, monkeypatch):
    """C10: a trial can run to its end while the tuner is busy: trial 1
    reports four iterations and returns while a callback holds the tuner
    on trial 0's first report. Its reports are drained while it still
    counts as running, so PBT's exploit at its iteration 2 (its loss the
    worse) clones it from trial 0."""
    monkeypatch.setenv("RAY_TPU_TORCH_DISABLE_DEFAULT_LOGGERS", "1")
    tune = _tune("ray_tpu_torch")

    class Busy(tune.Callback):
        def on_trial_result(self, trial, result):
            if trial.id == "trial_0000" and \
                    result["training_iteration"] == 1:
                time.sleep(1.5)

    def trainable(config):
        import time

        from ray_tpu_torch import tune

        if config["idx"] == 0:  # reports, then waits while trial 1 runs
            tune.report({"loss": 1.0, "training_iteration": 1})
            time.sleep(2.0)
            for it in range(2, 5):
                tune.report({"loss": 1.0 / it, "training_iteration": it})
        elif config["idx"] == 1:  # starts after trial 0's first report
            time.sleep(0.5)
            for it in range(1, 5):
                tune.report({"loss": 10.0 * it, "training_iteration": it})
        else:  # the clone
            tune.report({"loss": 0.1, "training_iteration": 1})

    pbt = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"idx": [2]}, seed=3)
    grid = tune.Tuner(
        trainable, param_space={"idx": tune.grid_search([0, 1])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=pbt, max_concurrent_trials=2),
        run_config=importlib.import_module("ray_tpu_torch.train").RunConfig(
            name="late", storage_path=str(tmp_path),
            callbacks=[Busy()])).fit()
    assert not grid.errors, grid.errors
    runs = {os.path.basename(r.path): (r.config["idx"],
                                       r.metrics["training_iteration"])
            for r in grid}
    # trial 1 ran on to iteration 4 before its exploit was drained; its
    # clone takes the donor's mutated config
    assert runs == {"trial_0000": (0, 4), "trial_0001": (1, 4),
                    "trial_0001r": (2, 1)}, runs


# --------------------------------------------------------------- GPU trials


def test_gpu_trials_are_leased_the_card_and_refuse_the_cpu(clusters,
                                                         tmp_path):
    """``{"GPU": 0.5}`` and a ``TorchTrainer`` with ``use_gpu`` and
    ``resources_per_worker={"GPU": 0.5}`` each lease the declared GPU
    (num_gpus, not a custom resource): the trial is pinned to "0" and,
    finding no CUDA here, raises before its loop runs."""
    from ray_tpu_torch import train, tune

    ran = tmp_path / "ran"

    def fn(config):
        ran.write_text("the loop ran")
        tune.report({"score": 1})

    def loop(config):
        ran.write_text("the loop ran")

    trainer = train.TorchTrainer(
        loop, scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=True, resources_per_worker={"GPU": 0.5}))
    for name, trainable in (("fn", tune.with_resources(fn, {"GPU": 0.5})),
                            ("trainer", trainer)):
        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=train.RunConfig(name=name,
                                       storage_path=str(tmp_path))).fit()
        (err,) = grid.errors
        assert "holds GPU ['0'] (CUDA_VISIBLE_DEVICES='0')" in str(err)
        assert "finds no CUDA device" in str(err)
        with open(tmp_path / name / "trials_state.pkl", "rb") as f:
            (state,) = cloudpickle.load(f).values()
        assert state["resources"] == {"GPU": 0.5}
    # restored, the errored trial asks for its share again
    (err,) = tune.Tuner.restore(str(tmp_path / "fn"),
                                restart_errored=True).fit().errors
    assert "holds GPU ['0'] (CUDA_VISIBLE_DEVICES='0')" in str(err)
    assert not ran.exists()
    deadline = time.time() + 30  # the trial actors' leases come back
    while ray_tpu_torch.available_resources().get("GPU") != 1.0:
        assert time.time() < deadline, ray_tpu_torch.available_resources()
        time.sleep(0.1)


# ------------------------------------------------------- the slice: ASHA


LRS = (1e-3, 1e-4)
MAX_T = 4
GRACE = 2


@pytest.fixture(scope="module")
def llama_inputs():
    """LLAMA_DEBUG's weights from JAX's init_params (seed 0) as numpy, and
    [2, 32] tokens from a numpy seed."""
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jllama.LLAMA_DEBUG,
                                       jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        0, jllama.LLAMA_DEBUG.vocab_size, (2, 32)).astype(np.int64)
    return params, tokens


def _loops():
    """The port's and JAX's train loops, nested so that cloudpickle ships
    them by value."""

    def _port_loop(cfg):
        import time

        import torch

        import ray_tpu_torch
        from ray_tpu_torch import models, train

        torch.set_num_threads(1)
        params = models.params_from_numpy(ray_tpu_torch.get(cfg["params"]),
                                          device="cpu")
        tokens = torch.as_tensor(ray_tpu_torch.get(cfg["tokens"]).copy())
        leaves = models.trainable(params)
        opt = torch.optim.AdamW(leaves, lr=cfg["lr"], betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.1)
        losses = []
        for step in range(cfg["max_t"]):
            opt.zero_grad(set_to_none=True)
            loss = models.loss_fn(params, {"tokens": tokens},
                                  models.LLAMA_DEBUG)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            train.report({"loss": losses[-1], "losses": list(losses)})
            if step + 1 == cfg["grace"]:
                time.sleep(1.5)  # the rung's decision lands before step 3

    def _jax_loop(cfg):
        import time

        import jax
        import jax.numpy as jnp
        import optax

        import ray_tpu
        from ray_tpu import train
        from ray_tpu.models import llama

        params = jax.tree_util.tree_map(jnp.asarray,
                                        ray_tpu.get(cfg["params"]))
        batch = {"tokens": jnp.asarray(ray_tpu.get(cfg["tokens"]),
                                       jnp.int32)}
        opt = optax.adamw(cfg["lr"], weight_decay=0.1)
        state = opt.init(params)
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, b: llama.loss_fn(p, b, llama.LLAMA_DEBUG)))
        losses = []
        for step in range(cfg["max_t"]):
            loss, grads = value_and_grad(params, batch)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
            train.report({"loss": losses[-1], "losses": list(losses)})
            if step + 1 == cfg["grace"]:
                time.sleep(1.5)

    return _port_loop, _jax_loop


def _asha_sweep(name, loop, trainer_cls, inputs, storage):
    rt = importlib.import_module(name)
    tune = _tune(name)
    train = importlib.import_module(f"{name}.train")
    params, tokens = inputs
    trainer = trainer_cls(
        loop, train_loop_config={"params": rt.put(params),
                                 "tokens": rt.put(tokens), "max_t": MAX_T,
                                 "grace": GRACE},
        scaling_config=train.ScalingConfig(num_workers=1))
    grid = tune.Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(
            list(LRS))}},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                         max_t=MAX_T, grace_period=GRACE,
                                         reduction_factor=2)),
        run_config=train.RunConfig(name="asha",
                                   storage_path=str(storage))).fit()
    assert not grid.errors, grid.errors
    rows = {r.config["train_loop_config"]["lr"]: (
        r.metrics["training_iteration"], r.metrics["losses"]) for r in grid}
    return rows, grid.get_best_result().config["train_loop_config"]["lr"]


def test_tuner_over_torch_trainer_matches_jax_trainer(clusters,
                                                      llama_inputs,
                                                      tmp_path,
                                                      monkeypatch):
    from ray_tpu.train import JaxTrainer
    from ray_tpu_torch.train import TorchTrainer

    monkeypatch.setenv("RAY_TPU_DISABLE_DEFAULT_LOGGERS", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_DISABLE_DEFAULT_LOGGERS", "1")
    loops = dict(zip(("ray_tpu_torch", "ray_tpu"), _loops()))
    trainers = {"ray_tpu": JaxTrainer, "ray_tpu_torch": TorchTrainer}
    (jrows, jbest), (prows, pbest) = _both_at_once(
        lambda n: _asha_sweep(n, loops[n], trainers[n], llama_inputs,
                              tmp_path / n))
    assert sorted(jrows) == sorted(prows) == sorted(LRS)
    for lr in LRS:
        (jt, jl), (pt, pl) = jrows[lr], prows[lr]
        assert jt == pt and len(jl) == len(pl) == pt
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL, atol=0)
    stops = {lr: prows[lr][0] for lr in LRS}
    assert stops == {LRS[0]: MAX_T, LRS[1]: GRACE}, stops
    assert jbest == pbest


def test_a_scheduler_without_a_metric_takes_the_tune_config_objective(
        clusters, tmp_path):
    """ASHA with neither metric nor mode under TuneConfig(metric="loss",
    mode="min") stops the trial whose loss is higher at the rung (the
    port gives the scheduler TuneConfig's mode with its metric)."""
    from ray_tpu_torch import train, tune

    def fn(config):
        import time

        for t in range(1, 5):
            tune.report({"loss": config["scale"] / t})
            if t == 2:
                time.sleep(1.0)

    grid = tune.Tuner(
        fn, param_space={"scale": tune.grid_search([1.0, 2.0])},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=tune.ASHAScheduler(max_t=4, grace_period=2,
                                         reduction_factor=2)),
        run_config=train.RunConfig(name="mode",
                                   storage_path=str(tmp_path))).fit()
    stops = {r.config["scale"]: r.metrics["training_iteration"]
             for r in grid}
    assert stops == {1.0: 4, 2.0: 2}
    assert grid.get_best_result().config["scale"] == 1.0


# --------------------------------------------------------- the slice: PBT


def test_pbt_clone_restores_the_donor_checkpoint_bit_for_bit(clusters,
                                                             tmp_path):
    """Three ViT trials (fp32, image 16, 2 layers), the worst last in the
    grid with an lr that sends its loss up: at iteration 2 it is in the
    bottom quantile and clones a donor's checkpoint. The clone's
    parameters and AdamW state right after ``load_checkpoint`` have the
    float64 sums the donor recorded as it saved them."""
    from ray_tpu_torch import train, tune

    class ViTTrainable(tune.Trainable):
        checkpoint_frequency = 1

        def setup(self, config):
            import torch

            from ray_tpu_torch import models
            from ray_tpu_torch.models import vit

            torch.set_num_threads(1)
            self.cfg = vit.ViTConfig(image_size=16, patch_size=4,
                                     num_classes=10, d_model=64, n_layers=2,
                                     n_heads=2, d_ff=128,
                                     dtype=torch.float32)
            gen = torch.Generator().manual_seed(0)
            self.params = vit.init_params(self.cfg, gen, device="cpu")
            self.batch = {"images": torch.randn(8, 16, 16, 3,
                                                generator=gen),
                          "labels": torch.randint(0, 10, (8,),
                                                  generator=gen)}
            self.leaves = models.trainable(self.params)
            self.opt = torch.optim.AdamW(self.leaves, lr=config["lr"])
            self.loaded = None

        def _sums(self):
            leaves = [t.detach() for t in self.leaves] + [
                v for st in self.opt.state.values() for v in st.values()]
            return [float(t.double().sum()) for t in leaves]

        def step(self):
            import time

            from ray_tpu_torch.models import vit

            self.opt.zero_grad(set_to_none=True)
            loss = vit.loss_fn(self.params, self.batch, self.cfg)
            loss.backward()
            self.opt.step()
            time.sleep(0.3)
            import ray_tpu_torch

            ctx = ray_tpu_torch.get_runtime_context()
            out = {"loss": float(loss), "lr": self.config["lr"],
                   "done": self.training_iteration + 1 >= 4,
                   "resources": ctx.get_assigned_resources()}
            if self.loaded is not None:
                out["loaded"], self.loaded = self.loaded, None
            return out

        def save_checkpoint(self, checkpoint_dir):
            import json
            import os

            from ray_tpu_torch import train

            train.save_pytree({"leaves": [t.detach() for t in self.leaves],
                               "opt": self.opt.state_dict()},
                              checkpoint_dir)
            with open(os.path.join(checkpoint_dir, "sums.json"), "w") as f:
                json.dump(self._sums(), f)
            return checkpoint_dir

        def load_checkpoint(self, checkpoint_dir):
            import json
            import os

            import torch

            from ray_tpu_torch import train

            state = train.load_pytree(checkpoint_dir)
            with torch.no_grad():
                for t, saved in zip(self.leaves, state["leaves"]):
                    t.copy_(saved)
            self.opt.load_state_dict(state["opt"])
            for group in self.opt.param_groups:
                group["lr"] = self.config["lr"]
            with open(os.path.join(checkpoint_dir, "sums.json")) as f:
                saved_sums = json.load(f)
            self.loaded = {"sums": self._sums(), "saved": saved_sums,
                           "from": checkpoint_dir}

    pbt = tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2,
        hyperparam_mutations={"lr": [1e-3, 3e-3]}, seed=3)
    grid = tune.Tuner(
        tune.with_resources(ViTTrainable, {"CPU": 1}),
        param_space={"lr": tune.grid_search([1e-3, 3e-3, 3.0])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=pbt),
        run_config=train.RunConfig(name="pbt",
                                   storage_path=str(tmp_path))).fit()
    assert not grid.errors, grid.errors
    clones = [r for r in grid if os.path.basename(r.path).endswith("r")]
    assert clones, [r.path for r in grid]
    for r in clones:
        with open(os.path.join(r.path, "result.json")) as f:
            first = json.loads(f.readline())
        loaded = first["loaded"]
        assert loaded["sums"] == loaded["saved"]
        with open(os.path.join(loaded["from"], "sums.json")) as f:
            assert json.load(f) == loaded["sums"]
        # the donor's own copy of that checkpoint
        donor = loaded["from"].split(os.sep)[-2]
        assert donor != os.path.basename(r.path)[:-1]
        assert first["lr"] in (1e-3, 3e-3)
        # the clone keeps the trainable's request
        assert first["resources"] == {"CPU": 1.0}
        # the donor's report k+1 saved checkpoint_k: the clone goes on
        assert first["training_iteration"] == int(loaded["from"][-6:]) + 2
