"""Per-worker training session: report(), rank info, dataset shards.

Analog of the reference's ``_TrainSession``
(``python/ray/train/_internal/session.py:111``; ``report`` at ``:667``):
each train-loop worker reports metrics + optional checkpoint; results stream
back to the trainer which persists checkpoints and drives failure handling.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.util import events as plane_events

from .checkpoint import Checkpoint

_session: Optional["TrainSession"] = None
_lock = threading.Lock()


class RescaleSignal(BaseException):
    """Raised OUT of a train loop at a ``report()`` boundary when the
    trainer wants the group to re-form at a different world size (elastic
    scale-up: lost capacity returned). BaseException so a user loop's
    ``except Exception`` cannot swallow the control transfer; the worker
    harness catches it and reports a clean rescale exit. Because every
    rank reports each step in a lockstep SPMD loop, all ranks observe the
    signal at the same step boundary — no rank is left inside a
    collective."""

    def __init__(self, target_world_size: int):
        self.target_world_size = target_world_size
        super().__init__(f"rescale to {target_world_size} workers")


class TrainContext:
    """What ``ray_tpu_torch.train.get_context()`` returns inside a train loop."""

    def __init__(self, session: "TrainSession"):
        self._s = session

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_world_rank(self) -> int:
        return self._s.world_rank

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_trial_name(self) -> str:
        return self._s.run_name

    def get_storage_path(self) -> str:
        return self._s.storage_path

    def get_mesh(self):
        """The device mesh for this worker's local (or global) devices."""
        return self._s.mesh


class TrainSession:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 run_name: str, storage_path: str,
                 result_actor=None, mesh=None, dataset_shards=None,
                 restore_path: str | None = None):
        self.restore_path = restore_path
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.run_name = run_name
        self.storage_path = storage_path
        self.result_actor = result_actor
        self.mesh = mesh
        self.dataset_shards = dataset_shards or {}
        self.iteration = 0
        self._last_report_ts: Optional[float] = None

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None):
        # Step-boundary telemetry: report() is the train loop's step
        # clock, and the report-to-report wall time IS the step time a
        # train tenant's SLO gates on (slo.register(..,
        # event="pipe.step.report", field="dur")). Tenant tag rides
        # process_tenant() — the worker's namespace.
        now = time.time()
        if self._last_report_ts is not None:
            plane_events.emit("pipe.step.report", plane="pipe",
                              tenant=plane_events.process_tenant(),
                              dur=now - self._last_report_ts,
                              iteration=self.iteration)
        self._last_report_ts = now
        ckpt_path = None
        if checkpoint is not None and self.world_rank == 0:
            # Persist into run storage (reference:
            # ``StorageContext.persist_current_checkpoint`` storage.py:514).
            dest = os.path.join(self.storage_path, self.run_name,
                                f"checkpoint_{self.iteration:06d}")
            if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                if os.path.exists(dest):
                    shutil.rmtree(dest)
                shutil.copytree(checkpoint.path, dest)
            ckpt_path = dest
        self.iteration += 1
        if self.result_actor is not None:
            import ray_tpu_torch

            reply = ray_tpu_torch.get(self.result_actor.push.remote(
                self.world_rank, dict(metrics), ckpt_path))
            rescale_to = (reply.get("rescale_to")
                          if isinstance(reply, dict) else None)
            if rescale_to and rescale_to != self.world_size:
                raise RescaleSignal(int(rescale_to))


def init_session(**kwargs) -> TrainSession:
    global _session
    with _lock:
        _session = TrainSession(**kwargs)
    return _session


def shutdown_session():
    global _session
    with _lock:
        _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active; this API must be called inside a "
            "train_loop_per_worker.")
    return _session


def get_context() -> TrainContext:
    return TrainContext(get_session())


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    s = get_session()
    restore = getattr(s, "restore_path", None)
    return Checkpoint(restore) if restore else None


def get_dataset_shard(name: str = "train"):
    s = get_session()
    shard = s.dataset_shards.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r}; available: "
                       f"{sorted(s.dataset_shards)}")
    return shard
