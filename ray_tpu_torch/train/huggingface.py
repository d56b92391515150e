"""HuggingFace Transformers integration for Train.

Reference: ``python/ray/train/huggingface/transformers`` —
``RayTrainReportCallback`` (a ``transformers.TrainerCallback`` that
feeds HF checkpoints + metrics into the Train session) and
``prepare_trainer`` (routes a Train dataset shard into the HF Trainer's
dataloaders). ``transformers`` is imported on first use, not with
``ray_tpu_torch.train``: a worker that never builds an HF ``Trainer``
does not load it, and where it is not installed both names raise an
``ImportError`` naming it.
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["RayTrainReportCallback", "prepare_trainer"]


def _transformers_callback_base():
    try:
        from transformers.trainer_callback import TrainerCallback
    except ImportError as e:
        raise ImportError(
            "transformers is not installed in this image; install "
            "`transformers` to use ray_tpu_torch.train.huggingface") from e
    return TrainerCallback


def _make_report_callback():
    class RayTrainReportCallback(_transformers_callback_base()):
        """Report HF Trainer progress into the Train session (reference:
        ``ray.train.huggingface.transformers.RayTrainReportCallback``).

        ``on_log`` reports the latest metric dict; ``on_save`` additionally
        attaches the just-written HF checkpoint directory, so Tune
        schedulers / fault tolerance see the same stream a native loop
        produces.
        """

        CHECKPOINT_NAME = "checkpoint"

        def __init__(self):
            self._latest_metrics: dict = {}

        def on_log(self, args, state, control, logs=None, **kwargs):
            import ray_tpu_torch.train as train

            logs = dict(logs or {})
            logs.setdefault("step", state.global_step)
            logs.setdefault("epoch", state.epoch)
            self._latest_metrics = logs
            train.report(logs)

        def on_save(self, args, state, control, **kwargs):
            import ray_tpu_torch.train as train
            from ray_tpu_torch.train import Checkpoint

            src = os.path.join(args.output_dir,
                               f"checkpoint-{state.global_step}")
            if not os.path.isdir(src):
                return
            metrics = dict(self._latest_metrics)
            metrics.setdefault("step", state.global_step)
            train.report(metrics, checkpoint=Checkpoint.from_directory(src))

    RayTrainReportCallback.__module__ = __name__
    return RayTrainReportCallback


def _report_callback():
    # the callback subclasses transformers' TrainerCallback, so it is
    # made (once) when first asked for
    cls = globals().get("RayTrainReportCallback")
    if cls is None:
        cls = globals()["RayTrainReportCallback"] = _make_report_callback()
    return cls


def __getattr__(name: str):
    if name == "RayTrainReportCallback":
        return _report_callback()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def prepare_trainer(trainer: Any) -> Any:
    """Adapt an HF ``Trainer`` built inside a Train worker (reference:
    ``transformers.prepare_trainer``): dataset shards from
    ``get_dataset_shard`` (ray_tpu_torch datasets / iterators) become torch
    iterables the HF dataloader accepts, and the report callback is
    installed if the user forgot it."""
    callback = _report_callback()
    for attr in ("train_dataset", "eval_dataset"):
        ds = getattr(trainer, attr, None)
        if ds is not None and hasattr(ds, "iter_batches"):
            # Dataset or DataIterator (what get_dataset_shard hands out)
            setattr(trainer, attr, _as_torch_iterable(ds))
    has_report = any(isinstance(cb, callback)
                     for cb in getattr(
                         trainer, "callback_handler").callbacks)
    if not has_report:
        trainer.add_callback(callback())
    return trainer


def _as_torch_iterable(ds):
    import numpy as np
    import torch

    class _Shard(torch.utils.data.IterableDataset):
        def __iter__(self):
            for batch in ds.iter_batches(batch_size=1,
                                         batch_format="numpy"):
                # HF collates rows itself: yield row dicts of tensors,
                # each copied off the (read-only) store view
                yield {k: torch.as_tensor(np.array(v[0]))
                       for k, v in batch.items()}

    return _Shard()
