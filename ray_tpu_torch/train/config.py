"""Train/AIR config dataclasses.

Analogs of the reference's ``python/ray/air/config.py`` (``ScalingConfig``,
``RunConfig``, ``FailureConfig``, ``CheckpointConfig``). In the port a
worker is one process pinned to its share of a GPU (``use_gpu``, the
reference's name; ``GPU`` is the worker resource), and the group meets in
a ``torch.distributed`` rendezvous.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each needs.

    ``num_workers`` and ``use_gpu`` mirror the reference's fields
    (``air/config.py`` ScalingConfig); ``gpus_per_worker`` is each
    worker's share of a card (1 by default; 0.5 puts two workers on one
    card, each pinned to it).
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 0.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic restart floor: when a restart attempt follows a worker
    # death, the group may re-form SMALLER (down to this floor) instead
    # of failing — the training loop sees the new world size, builds its
    # process group and mesh at that size, and restores the checkpoint
    # onto it. None = fixed-size restarts (the reference's Train
    # semantics: worker groups are fixed-size per restart).
    #
    # The floor also arms elastic scale-UP: while a run is degraded below
    # ``num_workers``, a capacity monitor watches the cluster; when the
    # missing capacity returns, workers are signalled at their next
    # ``report()`` (a checkpoint boundary), the group re-forms LARGER,
    # and the loop restores onto the bigger group.
    elastic_min_workers: Optional[int] = None
    # Arm the capacity monitor / mid-run regrowth when degraded below
    # num_workers (only meaningful with elastic_min_workers set). False =
    # shrink-only elasticity: a degraded run stays at its reduced size.
    elastic_scale_up: bool = True
    # Placement-group formation wait before an attempt is declared
    # infeasible. With an elastic floor set, an infeasible TARGET size
    # degrades to what fits instead of failing the run.
    formation_timeout_s: float = 120.0

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker or 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    """max_failures: -1 = infinite retries (reference: air/config.py)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    # Experiment callbacks (reference: ``ray.tune.Callback`` /
    # ``air.RunConfig.callbacks``), invoked by the Tune loop.
    callbacks: Optional[list] = None
    # Stop criterion (reference: ``air.RunConfig.stop``), read by tune
    # (ROADMAP A10).
    stop: Optional[object] = None

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(
            self.storage_path or "~/ray_tpu_torch_results")


TRAIN_DATASET_KEY = "train"


@dataclasses.dataclass
class DataConfig:
    """Which ``datasets=`` entries shard across workers vs replicate
    (reference: ``ray.train.DataConfig``): ``datasets_to_split="all"``
    streaming-splits every dataset; a list names the subset to split,
    the rest pass whole to every worker."""

    datasets_to_split: object = "all"  # "all" | list of names

    def should_split(self, name: str) -> bool:
        if self.datasets_to_split == "all":
            return True
        return name in (self.datasets_to_split or [])


@dataclasses.dataclass
class SyncConfig:
    """Artifact/checkpoint sync cadence (reference: ``train.SyncConfig``).
    Storage here is a filesystem path written directly by workers, so
    there is no background sync process — the knobs are accepted for
    source compatibility and ``sync_artifacts`` still controls whether
    per-trial working-dir artifacts are copied into storage."""

    sync_period: int = 300
    sync_timeout: int = 1800
    sync_artifacts: bool = False


class BackendConfig:
    """Base for worker-group backend setup hooks (reference:
    ``ray.train.backend.BackendConfig``). Subclasses customize
    per-worker process setup before the train loop runs."""

    def backend_setup_fn(self):
        """Optional callable run on every worker before the loop."""
        return None
