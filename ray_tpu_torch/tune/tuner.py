"""Tuner: the HPO controller driving trial actors.

Re-design of the reference's ``TuneController`` event loop
(``python/ray/tune/execution/tune_controller.py:68``; ``Tuner`` at
``tune/tuner.py:44``): trials are actors created on demand up to
``max_concurrent_trials``; every ``report`` streams to a collector actor;
the driver loop applies scheduler decisions (ASHA early-stop kills the
trial actor; PBT exploit clones a donor checkpoint and restarts with
mutated hyperparameters).

Port of ``ray_tpu/tune/tuner.py``. A ``TorchTrainer`` trainable runs its
loop in the trial actor, as the reference runs a ``JaxTrainer``'s; a
process sees a card only where the GCS leased it one, so such a trial
takes one worker's GPU share unless ``with_resources`` says otherwise, and
a trial's ``"GPU"`` is its actor's ``num_gpus``. A trial that holds a GPU
and finds no CUDA raises; it never trains on the CPU.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.trainer import Result, TorchTrainer

from .schedulers import (CONTINUE, EXPLOIT, REALLOCATE, STOP,
                         FIFOScheduler, PopulationBasedTraining)
from .search import generate_variants


class TuneConfig:
    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 num_samples: int = 1, scheduler=None, search_alg=None,
                 max_concurrent_trials: Optional[int] = None,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.scheduler = scheduler
        self.search_alg = search_alg  # Searcher (TPE/BayesOpt/...) or None
        self.max_concurrent_trials = max_concurrent_trials
        self.seed = seed


@ray_tpu_torch.remote
class _TuneCollector:
    def __init__(self):
        self.reports: Dict[str, List[dict]] = {}
        self.checkpoints: Dict[str, str] = {}
        self.cursor: Dict[str, int] = {}

    def push(self, trial_id: str, metrics: dict, checkpoint_path):
        self.reports.setdefault(trial_id, []).append(metrics)
        if checkpoint_path:
            self.checkpoints[trial_id] = checkpoint_path
        return True

    def new_reports(self):
        """Reports not yet seen by the controller."""
        out = []
        for tid, hist in self.reports.items():
            start = self.cursor.get(tid, 0)
            for r in hist[start:]:
                out.append((tid, r))
            self.cursor[tid] = len(hist)
        return out

    def state(self):
        return {"reports": self.reports, "checkpoints": self.checkpoints}


@ray_tpu_torch.remote
class _TrialActor:
    """Runs one trial's function with a tune session."""

    def run(self, fn_blob: bytes, config: dict, trial_id: str,
            storage_path: str, exp_name: str, collector,
            restore_path: Optional[str]):
        import traceback

        from ray_tpu_torch.train import session as session_mod

        fn = cloudpickle.loads(fn_blob)

        class _TuneReporter:
            def push(self, rank, metrics, ckpt_path):
                return collector.push.remote(trial_id, metrics, ckpt_path)

        sess = session_mod.init_session(
            world_rank=0, world_size=1, local_rank=0,
            run_name=os.path.join(exp_name, trial_id),
            storage_path=storage_path,
            result_actor=None, restore_path=restore_path)
        # tune-flavored report: inject training_iteration, push via collector
        orig_report = sess.report

        def tune_report(metrics, checkpoint=None):
            metrics = dict(metrics)
            metrics.setdefault("training_iteration", sess.iteration + 1)
            ckpt_path = None
            if checkpoint is not None:
                import shutil

                dest = os.path.join(storage_path, exp_name, trial_id,
                                    f"checkpoint_{sess.iteration:06d}")
                if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                    os.makedirs(os.path.dirname(dest), exist_ok=True)
                    if os.path.exists(dest):
                        shutil.rmtree(dest)
                    shutil.copytree(checkpoint.path, dest)
                ckpt_path = dest
            sess.iteration += 1
            ray_tpu_torch.get(collector.push.remote(trial_id, metrics, ckpt_path))

        sess.report = tune_report
        try:
            if ray_tpu_torch.get_gpu_ids():
                from ray_tpu_torch.train.torch import get_device

                get_device()  # a GPU lease without CUDA raises here
            fn(config)
            return {"ok": True}
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "err": str(e), "tb": traceback.format_exc()}
        finally:
            session_mod.shutdown_session()


class Trial:
    def __init__(self, trial_id: str, config: dict,
                 resources: Optional[dict] = None):
        self.id = trial_id
        self.config = config
        self.state = "PENDING"
        self.actor = None
        self.run_ref = None
        self.restore_path: Optional[str] = None
        # Per-trial actor resources; ResourceChangingScheduler rewrites
        # this between incarnations.
        self.resources: Optional[dict] = resources
        self.killed_by_scheduler = False
        self.pg = None  # live placement group (PlacementGroupFactory)
        self.error: Optional[str] = None
        self.last_result: Optional[dict] = None
        self.logdir: Optional[str] = None  # set at launch


class ResultGrid:
    def __init__(self, results: List[Result], metric=None, mode="max"):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        candidates = [r for r in self._results
                      if r.metrics and metric in r.metrics]
        if not candidates:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return (max if mode == "max" else min)(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])


class Tuner:
    def __init__(self, trainable, *, param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    # --------------------------------------------------- experiment resume

    @staticmethod
    def can_restore(path: str) -> bool:
        """True if ``path`` holds a restorable experiment (reference:
        ``Tuner.can_restore``)."""
        return os.path.isfile(os.path.join(path, "tuner.pkl")) and \
            os.path.isfile(os.path.join(path, "trials_state.pkl"))

    @classmethod
    def restore(cls, path: str, trainable=None, *,
                restart_errored: bool = False) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference:
        ``python/ray/tune/tuner.py:Tuner.restore``).

        Finished trials keep their recorded results and are NOT re-run;
        unfinished (interrupted) trials re-launch with their saved configs,
        restoring from their latest persisted checkpoint; errored trials
        re-launch only with ``restart_errored=True``. The resumed run
        executes exactly the recorded trial set — no new variants are
        generated. Pass ``trainable`` to supply fresh code; otherwise the
        persisted trainable is reused.
        """
        if not cls.can_restore(path):
            raise ValueError(f"no restorable experiment at {path}")
        with open(os.path.join(path, "tuner.pkl"), "rb") as f:
            meta = cloudpickle.load(f)
        with open(os.path.join(path, "trials_state.pkl"), "rb") as f:
            tstate = cloudpickle.load(f)
        path = os.path.abspath(path.rstrip(os.sep))
        self = cls(trainable,
                   tune_config=TuneConfig(metric=meta["metric"],
                                          mode=meta["mode"]),
                   run_config=RunConfig(name=os.path.basename(path),
                                        storage_path=os.path.dirname(path)))
        self._resume = {"meta": meta, "trials": tstate,
                        "restart_errored": restart_errored}
        return self

    @staticmethod
    def _latest_checkpoint(trial_dir: str) -> Optional[str]:
        import glob as _glob

        cks = sorted(_glob.glob(os.path.join(trial_dir, "checkpoint_*")))
        return cks[-1] if cks else None

    def _persist_trials(self, storage: str, exp_name: str, trials) -> None:
        # A resumed run re-launches only the unfinished trials; the
        # finished ones' records must survive into the rewritten state
        # file or a second restore would lose them entirely.
        state = dict(getattr(self, "_preserved_state", {}))
        state.update({t.id: {"config": t.config, "state": t.state,
                             "error": t.error,
                             "last_result": t.last_result,
                             "resources": t.resources}
                      for t in trials})
        tmp = os.path.join(storage, exp_name, ".trials_state.tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(state, f)
        os.replace(tmp, os.path.join(storage, exp_name, "trials_state.pkl"))

    def _resolve_trainable(self):
        """Registry names -> callables; Trainable subclasses -> their
        function-trainable adapter (class API, reference:
        ``tune/trainable/trainable.py``)."""
        t = self.trainable
        if isinstance(t, str):
            from .registry import get_trainable

            t = get_trainable(t)
        from .trainable import Trainable as _TrainableCls

        if isinstance(t, type) and issubclass(t, _TrainableCls):
            res = getattr(t, "_tune_resources", None)
            t = t._as_function_trainable()
            if res is not None:
                t._tune_resources = res
        return t

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        if self.trainable is not None:
            self.trainable = self._resolve_trainable()
        tc = self.tune_config
        resume = getattr(self, "_resume", None)
        exp_name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        storage = self.run_config.resolved_storage_path()
        os.makedirs(os.path.join(storage, exp_name), exist_ok=True)
        scheduler = tc.scheduler or FIFOScheduler()
        if getattr(scheduler, "metric", None) is None and hasattr(
                scheduler, "metric"):
            scheduler.metric = tc.metric
            if hasattr(scheduler, "mode"):
                # the objective is TuneConfig's: its direction too, or a
                # min-mode sweep would stop its best trials
                scheduler.mode = tc.mode
        # Trainable normalization: TorchTrainer -> run its loop via fit()
        wrap_key = None
        pre_results: List[Result] = []
        initial_pending: List[Trial] = []
        if resume is not None:
            meta = resume["meta"]
            wrap_key = meta["wrap_key"]
            search_space = cloudpickle.loads(meta["search_space"])
            if self.trainable is None:
                fn_blob = meta["fn_blob"]
            elif isinstance(self.trainable, TorchTrainer):
                # Same normalization as a fresh fit(): a TorchTrainer is not
                # itself callable — wrap its train loop.
                trainer = self.trainable

                def fn(config):
                    loop_cfg = dict(trainer.train_loop_config or {})
                    loop_cfg.update(config.get("train_loop_config", config))
                    trainer.train_loop(loop_cfg)

                fn_blob = cloudpickle.dumps(fn)
            else:
                fn_blob = cloudpickle.dumps(self.trainable)
            self._preserved_state = {}
            for tid in sorted(resume["trials"]):
                st = resume["trials"][tid]
                trial_dir = os.path.join(storage, exp_name, tid)
                rerun = st["state"] not in ("TERMINATED", "ERROR") or (
                    st["state"] == "ERROR" and resume["restart_errored"])
                if st["state"] == "PAUSED" and \
                        (tid + "r") in resume["trials"]:
                    # PAUSED + a persisted successor clone (exploit /
                    # reallocate id convention: tid + "r") means the
                    # scheduler superseded this trial; re-running it
                    # would duplicate work the clone continues. Its
                    # recorded results still join the grid below.
                    rerun = False
                if rerun:
                    t = Trial(tid, st["config"],
                              resources=st.get("resources"))
                    t.restore_path = self._latest_checkpoint(trial_dir)
                    initial_pending.append(t)
                else:
                    self._preserved_state[tid] = st
                    ckpt = self._latest_checkpoint(trial_dir)
                    pre_results.append(Result(
                        metrics=st["last_result"],
                        checkpoint=Checkpoint(ckpt) if ckpt else None,
                        path=trial_dir,
                        error=(RuntimeError(st["error"]) if st["error"]
                               else None),
                        config=dict(st["config"])))

            def next_config(trial_id):
                return "exhausted"  # resume runs the recorded set only
            searcher = None
        elif isinstance(self.trainable, TorchTrainer):
            trainer = self.trainable
            space = dict(self.param_space)
            search_space = space.get("train_loop_config", space)
            wrap_key = "train_loop_config"

            def fn(config):
                import ray_tpu_torch.train.session as sm

                loop_cfg = dict(trainer.train_loop_config or {})
                loop_cfg.update(config.get("train_loop_config", config))
                trainer.train_loop(loop_cfg)

            fn_blob = cloudpickle.dumps(fn)
        else:
            fn_blob = cloudpickle.dumps(self.trainable)
            search_space = self.param_space
        if resume is None:
            searcher = tc.search_alg
            if searcher is not None:
                searcher.set_search_properties(tc.metric, tc.mode,
                                               search_space)
                issued = [0]

                def next_config(trial_id):
                    # A sample slot is consumed only once the searcher
                    # actually yields a config — backpressure polls
                    # (ConcurrencyLimiter returning None) must not burn
                    # samples.
                    if issued[0] >= tc.num_samples:
                        return "exhausted"
                    cfg = searcher.suggest(trial_id)
                    if cfg is not None:
                        issued[0] += 1
                    return cfg
            else:
                queue = generate_variants(search_space, tc.num_samples,
                                          tc.seed)

                def next_config(trial_id):
                    return queue.pop(0) if queue else "exhausted"
            # Persist experiment metadata the moment the run starts so an
            # interrupted experiment is restorable (Tuner.restore).
            with open(os.path.join(storage, exp_name, "tuner.pkl"),
                      "wb") as f:
                cloudpickle.dump(
                    {"fn_blob": fn_blob, "wrap_key": wrap_key,
                     "search_space": cloudpickle.dumps(search_space),
                     "metric": tc.metric, "mode": tc.mode}, f)
        trials: List[Trial] = []
        collector = _TuneCollector.remote()
        try:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 2)
        except Exception:
            cpus = 2
        max_concurrent = tc.max_concurrent_trials or max(1, int(cpus))
        callbacks = list(self.run_config.callbacks or [])
        if os.environ.get("RAY_TPU_TORCH_DISABLE_DEFAULT_LOGGERS") != "1":
            from .callback import (CSVLoggerCallback, JsonLoggerCallback,
                                   TBXLoggerCallback)

            callbacks += [JsonLoggerCallback(), CSVLoggerCallback(),
                          TBXLoggerCallback()]
        for cb in callbacks:
            cb.setup(os.path.join(storage, exp_name))
        from .stopper import coerce_stopper

        stopper = coerce_stopper(self.run_config.stop)
        self._run_loop(trials, next_config, wrap_key, fn_blob, collector,
                       scheduler, searcher, exp_name, storage,
                       max_concurrent, callbacks, initial_pending, stopper)
        for cb in callbacks:
            cb.on_experiment_end(trials)
        self._persist_trials(storage, exp_name, trials)
        state = ray_tpu_torch.get(collector.state.remote())
        results = list(pre_results)
        for t in trials:
            hist = state["reports"].get(t.id, [])
            ckpt = state["checkpoints"].get(t.id)
            results.append(Result(
                metrics=hist[-1] if hist else None,
                checkpoint=Checkpoint(ckpt) if ckpt else None,
                path=os.path.join(storage, exp_name, t.id),
                error=RuntimeError(t.error) if t.error else None,
                config=dict(t.config)))
        try:
            ray_tpu_torch.kill(collector)
        except Exception:
            pass
        return ResultGrid(results, tc.metric, tc.mode)

    def _run_loop(self, trials, next_config, wrap_key, fn_blob, collector,
                  scheduler, searcher, exp_name, storage, max_concurrent,
                  callbacks=(), initial_pending=(), stopper=None):
        pending: List[Trial] = list(initial_pending)
        running: List[Trial] = []
        trial_by_id: Dict[str, Trial] = {t.id: t for t in pending}
        trials.extend(pending)
        exhausted = False
        stop_all_fired = [False]
        trial_counter = [0]

        def resolve_resources(cfg):
            """with_resources annotation -> per-trial request (dict,
            PlacementGroupFactory, or config->resources callable)."""
            from .trainable import PlacementGroupFactory

            req = getattr(self.trainable, "_tune_resources", None)
            if callable(req) and not isinstance(
                    req, PlacementGroupFactory):
                req = req(cfg)
            if req is None and isinstance(self.trainable, TorchTrainer) \
                    and self.trainable.scaling_config.use_gpu:
                # its loop runs here, and a process sees a card only
                # through a lease: one worker's GPU share
                req = {"GPU": self.trainable.scaling_config
                       .worker_resources()["GPU"]}
            return req

        def make_trial() -> Optional[Trial]:
            nonlocal exhausted
            if exhausted:
                return None
            tid = f"trial_{trial_counter[0]:04d}"
            cfg = next_config(tid)
            if cfg == "exhausted":
                exhausted = True
                return None
            if cfg is None:  # searcher backpressure (ConcurrencyLimiter)
                return None
            trial_counter[0] += 1
            if wrap_key is not None:
                cfg = {wrap_key: cfg}
            t = Trial(tid, cfg, resources=resolve_resources(cfg))
            trials.append(t)
            trial_by_id[tid] = t
            return t

        def launch(trial: Trial):
            from .trainable import PlacementGroupFactory

            cls = _TrialActor
            if isinstance(trial.resources, PlacementGroupFactory):
                from ray_tpu_torch.util.placement_group import placement_group
                from ray_tpu_torch.util.scheduling_strategies import (
                    PlacementGroupSchedulingStrategy,
                )

                pgf = trial.resources
                trial.pg = placement_group(pgf.bundles,
                                           strategy=pgf.strategy)
                trial.pg.wait(60)
                head = dict(pgf.head_resources())
                opts = {"num_cpus": head.pop("CPU", 0) or 0,
                        "num_gpus": head.pop("GPU", 0) or 0,
                        "scheduling_strategy":
                            PlacementGroupSchedulingStrategy(
                                trial.pg,
                                placement_group_bundle_index=0)}
                if head:
                    opts["resources"] = head
                cls = _TrialActor.options(**opts)
            elif trial.resources:
                res = dict(trial.resources)
                opts = {"num_cpus": res.pop("CPU", 0) or 0,
                        "num_gpus": res.pop("GPU", 0) or 0}
                if res:
                    opts["resources"] = res
                cls = _TrialActor.options(**opts)
            trial.actor = cls.remote()
            trial.run_ref = trial.actor.run.remote(
                fn_blob, trial.config, trial.id, storage, exp_name,
                collector, trial.restore_path)
            trial.state = "RUNNING"
            set_res = getattr(scheduler, "set_trial_resources", None)
            if set_res is not None:
                set_res(trial.id, trial.resources)
            if trial.logdir is None:
                trial.logdir = os.path.join(storage, exp_name, trial.id)
            for cb in callbacks:
                cb.on_trial_start(trial)
            running.append(trial)
            # Keep the on-disk experiment state current so an interrupt at
            # any point leaves a restorable record (Tuner.restore).
            self._persist_trials(storage, exp_name, trials)

        def drain_reports():
            # New reports -> searcher/callback observation + scheduler
            # decisions.
            for tid, result in ray_tpu_torch.get(collector.new_reports.remote()):
                trial = trial_by_id[tid]
                trial.last_result = result
                if searcher is not None:
                    searcher.on_trial_result(tid, result)
                for cb in callbacks:
                    cb.on_trial_result(trial, result)
                record = getattr(scheduler, "record_config", None)
                if record is not None:  # PB2 models (config -> delta)
                    record(tid, dict(trial.config))
                decision = scheduler.on_result(tid, result)
                if stopper is not None and stopper(tid, result) \
                        and trial.state == "RUNNING":
                    trial.killed_by_scheduler = True
                    trial.state = "PAUSED"  # off RUNNING: one kill only
                    ray_tpu_torch.kill(trial.actor)
                    continue
                if trial.state != "RUNNING":
                    # Schedulers observe every report (fast trials can
                    # finish before their reports drain), but decisions
                    # only apply to live trials.
                    continue
                if decision == STOP:
                    trial.killed_by_scheduler = True
                    ray_tpu_torch.kill(trial.actor)
                elif decision == REALLOCATE:
                    # ResourceChangingScheduler: checkpoint (the trial's
                    # latest pushed one), kill, relaunch the SAME config
                    # with the new resources, resuming from itself. State
                    # flips off RUNNING immediately so a second report of
                    # the same trial in this drain batch cannot spawn a
                    # duplicate clone.
                    new_res = getattr(scheduler, "pending_resources",
                                      {}).pop(tid, None)
                    # Sequential by design: the state read feeds the
                    # clone built in THIS iteration, and REALLOCATE
                    # decisions are rare scheduler events, not a hot
                    # loop.  # raylint: disable=RTL002
                    state = ray_tpu_torch.get(collector.state.remote())  # raylint: disable=RTL002
                    own_ckpt = state["checkpoints"].get(tid)
                    trial.killed_by_scheduler = True
                    trial.state = "PAUSED"
                    ray_tpu_torch.kill(trial.actor)
                    clone = Trial(tid + "r", dict(trial.config),
                                  resources=new_res)
                    clone.restore_path = own_ckpt
                    trial_by_id[clone.id] = clone
                    trials.append(clone)
                    pending.append(clone)
                elif decision == EXPLOIT and isinstance(
                        scheduler, PopulationBasedTraining):
                    donor_id = scheduler.exploit_target(tid)
                    if donor_id is not None:
                        donor = trial_by_id[donor_id]
                        # Sequential by design (same as REALLOCATE).
                        state = ray_tpu_torch.get(collector.state.remote())  # raylint: disable=RTL002
                        donor_ckpt = state["checkpoints"].get(donor_id)
                        trial.killed_by_scheduler = True
                        # Off RUNNING immediately (same reason as
                        # REALLOCATE above): a second report of this trial
                        # in the same drain batch must not exploit again —
                        # that spawned two clones under one id, the second
                        # stranded PENDING while receiving the first's
                        # reports.
                        trial.state = "PAUSED"
                        ray_tpu_torch.kill(trial.actor)
                        # Requeue: donor config mutated + donor checkpoint.
                        cfg = scheduler.mutate(dict(donor.config))
                        clone = Trial(tid + "r", cfg,
                                      resources=resolve_resources(cfg))
                        clone.restore_path = donor_ckpt
                        trial_by_id[clone.id] = clone
                        trials.append(clone)
                        pending.append(clone)

        while True:
            while pending and len(running) < max_concurrent:
                launch(pending.pop(0))
            while not exhausted and len(running) < max_concurrent:
                t = make_trial()
                if t is None:
                    break  # exhausted, or searcher backpressure
                launch(t)
            if not running and not pending:
                # With nothing in flight a searcher has no backpressure
                # reason to decline (ConcurrencyLimiter's live set is
                # empty), so a None here means it is out of suggestions.
                break
            drain_reports()
            if stopper is not None and not stop_all_fired[0] \
                    and stopper.stop_all():
                # Experiment-wide stop (TimeoutStopper / plateau): no new
                # trials, kill what's running; the done-processing below
                # records them TERMINATED as scheduler-stopped. Own flag —
                # `exhausted` only means the sample generator is drained,
                # which must not mask a later stop_all.
                stop_all_fired[0] = True
                exhausted = True
                pending.clear()
                for t in running:
                    t.killed_by_scheduler = True
                    try:
                        ray_tpu_torch.kill(t.actor)
                    except Exception:
                        pass
            if not running:
                continue
            refs = [t.run_ref for t in running]
            done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=0.05)
            for ref in done:
                trial = next(t for t in running if t.run_ref == ref)
                running.remove(trial)
                if getattr(trial, "pg", None) is not None:
                    from ray_tpu_torch.util.placement_group import (
                        remove_placement_group,
                    )

                    try:
                        remove_placement_group(trial.pg)
                    except Exception:
                        pass
                    trial.pg = None
                try:
                    out = ray_tpu_torch.get(ref)
                    if not out.get("ok"):
                        trial.state = "ERROR"
                        trial.error = out.get("tb") or out.get("err")
                    else:
                        trial.state = "TERMINATED"
                except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerCrashedError) as e:
                    if trial.killed_by_scheduler:
                        trial.state = "TERMINATED"  # early-stopped
                    else:
                        trial.state = "ERROR"
                        trial.error = str(e)
                if trial.state == "TERMINATED" and trial.last_result is None:
                    # A fast trial can return before its reports drain
                    # (report.remote and the run result ride different
                    # channels). Settle briefly so searchers observe the
                    # final metric and loggers write results BEFORE the
                    # completion hooks close the trial's files. Bounded:
                    # a trainable that never reported stalls this 1s.
                    deadline = time.time() + 1.0
                    while (trial.last_result is None
                           and time.time() < deadline):
                        drain_reports()
                        if trial.last_result is None:
                            time.sleep(0.02)
                if searcher is not None:
                    searcher.on_trial_complete(trial.id, trial.last_result)
                for cb in callbacks:
                    if trial.state == "ERROR":
                        cb.on_trial_error(trial)
                    else:
                        cb.on_trial_complete(trial)
                if trial.actor is not None:
                    try:
                        ray_tpu_torch.kill(trial.actor)
                    except Exception:
                        pass
                self._persist_trials(storage, exp_name, trials)

