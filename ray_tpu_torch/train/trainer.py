"""TorchTrainer: data-parallel training orchestration on GPU worker groups.

The reference's ``TorchTrainer`` path (SURVEY.md §3.4: ``BaseTrainer.fit``
→ ``BackendExecutor`` → ``WorkerGroup`` of actors → process group → train
loop with ``ray.train.report``), the port's counterpart of ``ray_tpu``'s
``JaxTrainer``: each worker actor is pinned by the runtime to its share of
a GPU, the group meets in a ``torch.distributed`` rendezvous (NCCL on
CUDA, gloo when asked or on the CPU), the loop sums its gradients itself
(``parallel.allreduce_grads``) and checkpoints are ``torch.save`` trees.
``fit()`` drives the group, streams results, and restarts at the same size
from the latest checkpoint on worker failure (``FailureConfig``).
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch

from .checkpoint import Checkpoint
from .config import FailureConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup


def classify_pipeline_loss(err, *, n_stages: int, submesh_world: int,
                           submesh_floor: int = 1):
    """The pp×fsdp escalation policy of the gang fault plane: not ported."""
    from .._private.roadmap import not_ported

    raise not_ported("classify_pipeline_loss", "gang")


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
    ``TrainingIterator``, ``train/trainer.py:36``). The reference's
    rescale mailbox belongs to elastic restarts (ROADMAP A9)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self.history: List[dict] = []
        self.latest_checkpoint: Optional[str] = None
        self._pending: Dict[int, dict] = {}

    def push(self, rank: int, metrics: dict, checkpoint_path):
        if checkpoint_path:
            self.latest_checkpoint = checkpoint_path
        self._pending[rank] = metrics
        if rank == 0:
            self.history.append(metrics)

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
        while True:
            result = self._run_attempt(run_name, storage, restore_path)
            if result.error is None:
                return result
            attempt += 1
            if max_failures >= 0 and attempt > max_failures:
                return result
            # Restart at the same size from the latest persisted
            # checkpoint (reference: ``TuneController.
            # _schedule_trial_restore`` tune_controller.py:1791)
            if result.checkpoint is not None:
                restore_path = result.checkpoint.path

    @staticmethod
    def _first_failure(outs) -> Optional[Exception]:
        """The first failed rank's error, or None when every rank
        finished."""
        for rank, o in enumerate(outs):
            if not o.get("ok"):
                return RuntimeError(f"worker {rank} failed:\n{o.get('tb')}")
        return None

    def _setup_backend(self, group: "WorkerGroup", num_workers: int):
        """Framework rendezvous hook (reference: ``Backend.on_start``,
        ``train/torch/config.py:153``): every worker takes its pinned card
        as its device and the group forms one ``torch.distributed``
        process group."""
        group.setup_torch(backend=self.torch_backend)

    def _run_attempt(self, run_name: str, storage: str,
                     restore_path: Optional[str]) -> Result:
        sc = self.scaling_config
        n_workers = sc.num_workers
        run_path = os.path.join(storage, run_name)
        collector = _ResultCollector.remote(n_workers)
        group = None
        try:
            group = WorkerGroup(n_workers, sc.worker_resources(),
                                sc.placement_strategy,
                                formation_timeout_s=sc.formation_timeout_s)
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
            err = self._first_failure(outs)
            metrics = state["history"][-1] if state["history"] else None
            ckpt = (Checkpoint(state["latest_checkpoint"])
                    if state["latest_checkpoint"] else None)
            return Result(metrics=metrics, checkpoint=ckpt, path=run_path,
                          error=err,
                          metrics_all_workers=state.get("last_per_rank"))
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerCrashedError,
                ConnectionError) as e:
            # A rank died hard enough that its run() ref errored.
            err = e
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
            group.shutdown()
            try:
                ray_tpu_torch.kill(collector)
            except Exception:
                pass
