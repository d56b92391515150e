"""TorchTrainer: data-parallel training orchestration on GPU worker groups.

The reference's ``TorchTrainer`` path (SURVEY.md §3.4: ``BaseTrainer.fit``
→ ``BackendExecutor`` → ``WorkerGroup`` of actors → process group → train
loop with ``ray.train.report``), the port's counterpart of ``ray_tpu``'s
``JaxTrainer``: each worker actor is pinned by the runtime to its share of
a GPU, the group meets in a ``torch.distributed`` rendezvous (NCCL on
CUDA, gloo when asked or on the CPU), the loop sums its gradients itself
(``parallel.allreduce_grads``) and checkpoints are ``torch.save`` trees.
``fit()`` drives the group, streams results, and restarts from the latest
checkpoint on worker failure (``FailureConfig``): at the same size, or with
``ScalingConfig.elastic_min_workers`` at the surviving size, growing back
when capacity returns or shrinking off a draining node at a report
boundary. A typed member loss (the gang fault plane) names the ranks lost.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch

from .checkpoint import Checkpoint
from .config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup


def classify_pipeline_loss(err, *, n_stages: int, submesh_world: int,
                           submesh_floor: int = 1):
    """Escalation policy for the pp×fsdp topology (each pipeline stage
    is itself an fsdp submesh of hosts): pick the MIN-COST recovery for
    a typed loss.

    * submesh-level loss — a ``WorkerGroupMemberLost`` tagged with a
      ``stage_idx`` losing FEWER than the submesh's world: only that
      stage's fsdp group re-forms at N−k (its params reshard from the
      stage's own checkpoint shard); the other pp−1 stages are
      untouched. Returns ``("reshape_submesh", stage_idx, new_world)``.
    * stage-level loss — a ``PipelineMemberLost`` (the stage actor/
      slice died) or a submesh loss that took the WHOLE submesh: the
      pipeline re-splits the merged checkpoint at pp−k. Returns
      ``("resplit_pipeline", new_stage_count)`` (floor 2 — below that
      it is a single-mesh run).
    * anything else returns ``None`` — not a pipeline-shaped loss.
    """
    from ray_tpu_torch.parallel.mpmd_pipeline import PipelineMemberLost

    from .worker_group import WorkerGroupMemberLost

    if isinstance(err, PipelineMemberLost):
        k = max(1, len(err.lost_stages))
        return ("resplit_pipeline", max(2, n_stages - k))
    if isinstance(err, WorkerGroupMemberLost):
        k = max(1, len(err.lost_ranks))
        if err.stage_idx is None:
            return None  # an unscoped (single-mesh) group loss
        if k >= submesh_world:
            return ("resplit_pipeline", max(2, n_stages - 1))
        return ("reshape_submesh", err.stage_idx,
                max(max(submesh_floor, 1), submesh_world - k))
    return None


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[Exception] = None
    metrics_dataframe: Any = None
    # rank -> that worker's last reported metrics (reference exposes
    # per-worker results through the session; handy for DDP assertions)
    metrics_all_workers: Optional[Dict[int, dict]] = None
    # the trial's hyperparameter config (tune results; reference
    # air.Result.config)
    config: Optional[Dict[str, Any]] = None
    # Set when the attempt ended in a cooperative rescale exit (elastic
    # scale-up): the size the next attempt should form at.
    rescaled_to: Optional[int] = None

    @property
    def best_checkpoints(self) -> List[Checkpoint]:
        if not os.path.isdir(self.path):
            return []
        out = []
        for d in sorted(os.listdir(self.path)):
            if d.startswith("checkpoint_"):
                out.append(Checkpoint(os.path.join(self.path, d)))
        return out


@ray_tpu_torch.remote
class _ResultCollector:
    """Aggregates per-worker reports (the reference's results queue →
    ``TrainingIterator``, ``train/trainer.py:36``); also the rescale
    mailbox — the capacity monitor posts a target world size here and
    every worker's next report carries it back (the checkpoint-boundary
    delivery point for elastic scale-up)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.history: List[dict] = []
        self.latest_checkpoint: Optional[str] = None
        self._pending: Dict[int, dict] = {}
        self._push_counts: Dict[int, int] = {}
        self._rescale_to: Optional[int] = None
        self._rescale_round: Optional[int] = None

    def push(self, rank: int, metrics: dict, checkpoint_path):
        self._push_counts[rank] = self._push_counts.get(rank, 0) + 1
        if checkpoint_path:
            self.latest_checkpoint = checkpoint_path
        self._pending[rank] = metrics
        if rank == 0:
            self.history.append(metrics)
        deliver = None
        if (self._rescale_to is not None
                and len(self._push_counts) >= self.world_size):
            # Round-synchronized delivery: arm the signal for the NEXT
            # full report round, so every rank raises at the same step
            # boundary — a mid-round delivery would strand the ranks that
            # already reported inside the next collective. If some rank
            # never reports (rank-0-only reporting), the signal is simply
            # never delivered: skipping a rescale is safe, a wedged
            # collective is not.
            if self._rescale_round is None:
                self._rescale_round = max(self._push_counts.values()) + 1
            if self._push_counts[rank] >= self._rescale_round:
                deliver = self._rescale_to
        return {"rescale_to": deliver}

    def request_rescale(self, target_world_size: int):
        self._rescale_to = int(target_world_size)
        return True

    def state(self):
        return {"history": list(self.history),
                "latest_checkpoint": self.latest_checkpoint,
                "last_per_rank": dict(self._pending)}


class TorchTrainer:
    """Run ``train_loop_per_worker`` on a gang of workers, each pinned to
    its share of a GPU.

    Example::

        def train_loop(config):
            ...  # build the model on "cuda": the worker's own card
            ray_tpu_torch.train.report({"loss": loss}, checkpoint=ckpt)

        trainer = TorchTrainer(
            train_loop,
            scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        )
        result = trainer.fit()

    ``torch_backend`` names the process group's backend: NCCL on CUDA and
    gloo on the CPU unless given (gloo lets workers share one card).
    """

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[dict] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 dataset_config: Optional[Any] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 torch_backend: Optional[str] = None):
        self.torch_backend = torch_backend
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        from .config import DataConfig

        self.dataset_config = dataset_config or DataConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        run_name = (self.run_config.name
                    or f"TorchTrainer_{uuid.uuid4().hex[:8]}")
        storage = self.run_config.resolved_storage_path()
        run_path = os.path.join(storage, run_name)
        os.makedirs(run_path, exist_ok=True)
        failure_cfg = self.run_config.failure_config or FailureConfig()
        max_failures = failure_cfg.max_failures
        restore_path = (self.resume_from_checkpoint.path
                        if self.resume_from_checkpoint else None)
        attempt = 0
        target = self.scaling_config.num_workers
        floor = self.scaling_config.elastic_min_workers
        workers = target
        # Last attempt that made real progress (a rescale exit OR a
        # failed attempt whose survivors reported/checkpointed): the
        # backfill source when the final attempt has nothing left to do.
        last_progress: Optional[Result] = None
        from .worker_group import WorkerGroupFormationError

        while True:
            result = self._run_attempt(run_name, storage, restore_path,
                                       num_workers=workers)
            if result.error is None:
                if result.rescaled_to is not None:
                    # Cooperative rescale exit: capacity returned — grow
                    # back toward the target at this checkpoint boundary
                    # (not a failure; attempt counter untouched).
                    workers = min(target, max(result.rescaled_to, 1))
                    if result.checkpoint is not None:
                        restore_path = result.checkpoint.path
                    last_progress = result
                    continue
                # A rescale — or a member loss whose survivors trained to
                # the end before the loss surfaced — on the run's FINAL
                # report leaves the follow-up attempt with zero steps to
                # train: it reports nothing. The prior attempt's
                # metrics/checkpoint ARE the run's outcome — backfill.
                if last_progress is not None:
                    if result.metrics is None:
                        result.metrics = last_progress.metrics
                    if result.checkpoint is None:
                        result.checkpoint = last_progress.checkpoint
                return result
            if (floor is not None
                    and isinstance(result.error, WorkerGroupFormationError)
                    and workers > max(floor, 1)):
                # Formation infeasible at this size: degrade toward the
                # floor WITHOUT burning a failure budget slot — nothing
                # trained, nothing was lost (the scale-up monitor grows
                # the run back once the capacity exists). Jump straight
                # to what the cluster reports it can fit rather than
                # paying a formation timeout per single decrement.
                workers = max(max(floor, 1),
                              min(workers - 1, self._feasible_workers()))
                continue
            attempt += 1
            if max_failures >= 0 and attempt > max_failures:
                # Out of budget: the error is returned TYPED — a
                # non-elastic run that lost a member surfaces
                # WorkerGroupMemberLost(lost_ranks, generation), not a
                # generic RuntimeError.
                return result
            # Restart from the latest persisted checkpoint (reference:
            # ``TuneController._schedule_trial_restore`` tune_controller.py:1791)
            if result.checkpoint is not None:
                restore_path = result.checkpoint.path
            if result.metrics is not None or result.checkpoint is not None:
                last_progress = result
            # Elastic restart (SURVEY §7 hard part 3): after a worker
            # death, assume the lost capacity is gone and re-form the
            # group smaller (never below the floor). A typed membership
            # loss names HOW MANY ranks died — re-form at N-k directly
            # instead of paying one formation per decrement. The loop
            # sees a smaller world, builds a reshaped mesh, and the
            # checkpoint restore reshards onto it.
            if floor is not None and workers > max(floor, 1):
                from .worker_group import WorkerGroupMemberLost

                k = (len(result.error.lost_ranks)
                     if isinstance(result.error, WorkerGroupMemberLost)
                     and result.error.lost_ranks else 1)
                workers = max(max(floor, 1), workers - k)

    def _classify_failure(self, group, outs, n_workers: int):
        """Escalation ladder over per-rank results: a typed member loss
        reported by any survivor wins; a collective TIMEOUT triggers a
        membership probe (a dropped push must not demote a real loss to
        a generic hang); anything else is a plain worker failure."""
        from .worker_group import WorkerGroupMemberLost

        lost = set()
        timed_out = False
        first_plain = None
        for rank, o in enumerate(outs):
            if o.get("ok"):
                continue
            et = o.get("err_type")
            if et in ("CollectiveMemberLost", "WorkerGroupMemberLost",
                      "PipelineMemberLost"):
                # PipelineMemberLost aliases lost_stages as lost_ranks:
                # in the stage gang, the stage index IS the rank.
                lost.update(o.get("lost_ranks") or [])
            elif et == "CollectiveTimeout":
                timed_out = True
            elif first_plain is None:
                first_plain = RuntimeError(
                    f"worker {rank} failed:\n{o.get('tb')}")
        if timed_out and not lost:
            probed = self._probe_member_loss(group, n_workers)
            if probed is not None:
                return probed
            return TimeoutError(
                "collective timed out with full gang membership — "
                "desynchronized program order or a wedged rank")
        if lost:
            return WorkerGroupMemberLost(sorted(lost), n_workers,
                                         "reported by survivors",
                                         generation=group.generation)
        return first_plain

    def _probe_member_loss(self, group, n_workers: int):
        """Membership probe (escalation step between 'a collective timed
        out / a ref died' and 'reshape'): returns the typed loss when
        the gang record shows lost ranks, else None."""
        from .worker_group import WorkerGroupMemberLost

        try:
            info = group.membership()
        except Exception:
            return None
        lost = info.get("lost") or []
        if info.get("registered") and lost:
            return WorkerGroupMemberLost(lost, n_workers,
                                         "membership probe",
                                         generation=group.generation)
        return None

    def _feasible_workers(self) -> int:
        """How many workers the cluster's AVAILABLE resources fit now —
        the first-retry size after an infeasible formation."""
        res = self.scaling_config.worker_resources()
        try:
            avail = ray_tpu_torch.available_resources()
        except Exception:
            return 1
        fits = [int(avail.get(k, 0.0) // v) for k, v in res.items() if v > 0]
        return max(1, min(fits) if fits else 1)

    def _start_capacity_monitor(self, collector, current: int, target: int):
        """While a run is degraded, watch for the missing capacity to
        return; when it does, post a rescale request that every worker's
        next ``report()`` observes (reference semantics being extended:
        ``storage.py:514`` restores at fixed size — growth mid-run is the
        preemptible-fleet addition)."""
        import threading

        stop = threading.Event()
        need = {k: v * (target - current)
                for k, v in self.scaling_config.worker_resources().items()}

        def watch():
            while not stop.is_set():
                time.sleep(0.5)
                try:
                    avail = ray_tpu_torch.available_resources()
                except Exception:
                    continue
                if all(avail.get(k, 0.0) >= v for k, v in need.items()):
                    try:
                        ray_tpu_torch.get(collector.request_rescale.remote(  # raylint: disable=RTL002 — one rescale request, then the watcher exits
                            target))
                    except Exception:
                        pass
                    return

        t = threading.Thread(target=watch, daemon=True,
                             name="elastic-capacity-monitor")
        t.start()
        return stop

    def _start_drain_monitor(self, collector, group, n_workers: int):
        """Treat a node DRAIN notice as a checkpoint-and-reshape trigger,
        not a surprise failure: when a node hosting one of the group's
        workers starts draining (a preemption notice, autoscaler
        scale-down), post a cooperative rescale so every rank exits at
        the same ``report()`` boundary with the checkpoint persisted; the
        trainer re-forms the group smaller — off the draining node —
        without burning the failure budget. Without this, the drain
        deadline kills a rank mid-step and recovery costs a full failure
        + restore cycle."""
        import threading

        stop = threading.Event()
        worker_ids = {w._id.hex() for w in group.workers}
        floor = max(self.scaling_config.elastic_min_workers or 1, 1)

        def watch():
            from ray_tpu_torch.util import state as state_api

            while not stop.is_set():
                time.sleep(1.0)
                try:
                    draining = {n["node_id"]
                                for n in state_api.list_nodes()
                                if n.get("draining") and n.get("alive")}
                    if not draining:
                        continue
                    actors = state_api.list_actors(limit=100000)
                except Exception:
                    continue
                doomed = sum(1 for a in actors
                             if a["actor_id"] in worker_ids
                             and a.get("node_id") in draining)
                if not doomed:
                    continue
                target = max(floor, n_workers - doomed)
                if target >= n_workers:
                    return  # already at/below the post-drain size
                try:
                    ray_tpu_torch.get(collector.request_rescale.remote(  # raylint: disable=RTL002 — one request per drain event, then the watcher exits
                        target))
                except Exception:
                    continue  # transient collector hiccup: retry next tick
                return

        t = threading.Thread(target=watch, daemon=True,
                             name="elastic-drain-monitor")
        t.start()
        return stop

    def _setup_backend(self, group: "WorkerGroup", num_workers: int):
        """Framework rendezvous hook (reference: ``Backend.on_start``,
        ``train/torch/config.py:153``): every worker takes its pinned card
        as its device and the group forms one ``torch.distributed``
        process group."""
        group.setup_torch(backend=self.torch_backend)

    def _run_attempt(self, run_name: str, storage: str,
                     restore_path: Optional[str],
                     num_workers: Optional[int] = None) -> Result:
        sc = self.scaling_config
        n_workers = num_workers if num_workers is not None else sc.num_workers
        run_path = os.path.join(storage, run_name)
        collector = _ResultCollector.remote(n_workers)
        group = None
        monitor_stop = None
        try:
            # Stable gang name (the run name): every re-formation of this
            # run's group registers under it, so generations stay
            # strictly monotonic across elastic reshapes and stale ranks
            # from attempt N can never complete a collective against
            # attempt N+1.
            group = WorkerGroup(n_workers, sc.worker_resources(),
                                sc.placement_strategy,
                                formation_timeout_s=sc.formation_timeout_s,
                                gang_name=f"train-{run_name}")
            self._setup_backend(group, n_workers)
        except Exception as e:  # noqa: BLE001 — e.g. infeasible resources
            try:
                ray_tpu_torch.kill(collector)
            except Exception:
                pass
            if group is not None:
                group.shutdown()
            return Result(metrics=None, checkpoint=None, path=run_path,
                          error=e)
        if (sc.elastic_min_workers is not None and sc.elastic_scale_up
                and n_workers < sc.num_workers):
            monitor_stop = self._start_capacity_monitor(
                collector, n_workers, sc.num_workers)
        drain_stop = None
        if (sc.elastic_min_workers is not None
                and n_workers > max(sc.elastic_min_workers, 1)):
            drain_stop = self._start_drain_monitor(collector, group,
                                                   n_workers)
        try:
            fn_blob = cloudpickle.dumps(self.train_loop)
            # Pre-split datasets into per-worker shards
            shard_refs: List[Dict[str, Any]] = [
                {} for _ in range(n_workers)]
            for name, ds in self.datasets.items():
                if hasattr(ds, "streaming_split") and \
                        self.dataset_config.should_split(name):
                    shards = ds.streaming_split(n_workers)
                    for i, sh in enumerate(shards):
                        shard_refs[i][name] = sh
                else:
                    for i in range(n_workers):
                        shard_refs[i][name] = ds
            futs = []
            for rank, w in enumerate(group.workers):
                session_kwargs = dict(
                    world_rank=rank, world_size=n_workers,
                    local_rank=0, run_name=run_name, storage_path=storage,
                    restore_path=restore_path)
                futs.append(w.run.remote(fn_blob, self.train_loop_config,
                                         session_kwargs, collector,
                                         shard_refs[rank]))
            outs = ray_tpu_torch.get(futs)
            state = ray_tpu_torch.get(collector.state.remote())
            err = self._classify_failure(group, outs, n_workers)
            rescaled_to = None
            for o in outs:
                if o.get("ok") and o.get("rescaled_to"):
                    rescaled_to = int(o["rescaled_to"])
            metrics = state["history"][-1] if state["history"] else None
            ckpt = (Checkpoint(state["latest_checkpoint"])
                    if state["latest_checkpoint"] else None)
            return Result(metrics=metrics, checkpoint=ckpt, path=run_path,
                          error=err,
                          metrics_all_workers=state.get("last_per_rank"),
                          rescaled_to=None if err else rescaled_to)
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerCrashedError,
                ConnectionError) as e:
            # A rank died hard enough that its run() ref errored: probe
            # the gang record so the typed loss (with its N-k reshape
            # semantics) survives even when no survivor reported one.
            err = self._probe_member_loss(group, n_workers) or e
            try:
                state = ray_tpu_torch.get(collector.state.remote())
            except Exception:
                state = {"history": [], "latest_checkpoint": None}
            ckpt = (Checkpoint(state["latest_checkpoint"])
                    if state["latest_checkpoint"] else None)
            # Keep what the attempt DID report: survivors may have
            # trained well past the victim's death before the loss
            # surfaced, and the retry (restoring at their last
            # checkpoint) may have nothing left to do — these metrics
            # are then the run's real outcome.
            metrics = state["history"][-1] if state["history"] else None
            return Result(metrics=metrics, checkpoint=ckpt, path=run_path,
                          error=err)
        finally:
            if monitor_stop is not None:
                monitor_stop.set()
            if drain_stop is not None:
                drain_stop.set()
            group.shutdown()
            try:
                ray_tpu_torch.kill(collector)
            except Exception:
                pass
