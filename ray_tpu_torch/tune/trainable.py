"""Class-based trainables + trainable wrappers.

Reference: ``python/ray/tune/trainable/trainable.py`` (the ``Trainable``
class API: setup/step/save_checkpoint/load_checkpoint lifecycle) and
``trainable/util.py`` (``with_parameters``, ``with_resources``).

A ``Trainable`` subclass runs inside the same trial actor a function
trainable does: the adapter below drives the lifecycle and reports one
result per ``step()``, so every scheduler/searcher/stopper sees the
identical stream either way.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, Dict, Optional, Union


class Trainable:
    """Subclass API: override ``setup``/``step`` (required) and
    ``save_checkpoint``/``load_checkpoint`` (for fault tolerance /
    PBT exploits)."""

    # Steps between automatic checkpoints (0 = only at exploit/restore
    # boundaries). Mirrors the reference's ``CHECKPOINT_FREQ`` behavior.
    checkpoint_frequency: int = 0

    def __init__(self, config: Optional[dict] = None):
        self.config = dict(config or {})
        self.training_iteration = 0
        self.setup(self.config)

    # -- lifecycle hooks ------------------------------------------------
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError("Trainable subclasses must define step()")

    def save_checkpoint(self, checkpoint_dir: str
                        ) -> Union[str, dict, None]:
        return None

    def load_checkpoint(self, checkpoint: Union[str, dict]) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        return False

    # -- driver (runs inside the trial actor) ---------------------------
    @classmethod
    def _as_function_trainable(cls) -> Callable[[dict], None]:
        def run(config: dict):
            import cloudpickle

            from ray_tpu_torch.train import Checkpoint
            from ray_tpu_torch.tune import get_checkpoint, report

            self = cls(config)
            start = get_checkpoint()
            if start is not None:
                with open(os.path.join(start.path, "_trainable.ckpt"),
                          "rb") as f:
                    saved = cloudpickle.load(f)
                self.training_iteration = saved["iteration"]
                user, made_in = saved["user"], saved.get("dir")
                if isinstance(user, str) and made_in and (
                        user == made_in
                        or user.startswith(made_in + os.sep)):
                    # the directory save_checkpoint wrote into is gone:
                    # its copy is the checkpoint restored here
                    user = start.path + user[len(made_in):]
                self.load_checkpoint(user)
            try:
                while True:
                    result = self.step() or {}
                    self.training_iteration += 1
                    result.setdefault("training_iteration",
                                      self.training_iteration)
                    ckpt = None
                    freq = self.checkpoint_frequency
                    if (freq and self.training_iteration % freq == 0) \
                            or result.get("should_checkpoint"):
                        d = tempfile.mkdtemp()
                        user = self.save_checkpoint(d)
                        with open(os.path.join(d, "_trainable.ckpt"),
                                  "wb") as f:
                            cloudpickle.dump(
                                {"iteration": self.training_iteration,
                                 "user": user if user is not None else d,
                                 "dir": d},
                                f)
                        ckpt = Checkpoint.from_directory(d)
                    report(result, checkpoint=ckpt)
                    if ckpt is not None:
                        # report copied it into the trial's storage
                        shutil.rmtree(ckpt.path, ignore_errors=True)
                    if result.get("done"):
                        return
            finally:
                self.cleanup()

        run.__name__ = cls.__name__
        return run


def with_parameters(trainable: Callable, **kwargs) -> Callable:
    """Bind large objects to a trainable via the object store
    (reference: ``tune.with_parameters``): each parameter is ``put()``
    once; every trial gets it from shared memory instead of re-pickling
    it into each trial's function blob."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        captured = dict(refs)

        class _Parameterized(trainable):
            def setup(self, config):
                resolved = {k: ray_tpu_torch.get(r) for k, r in captured.items()}
                super().setup(config, **resolved)

        _Parameterized.__name__ = trainable.__name__
        return _Parameterized

    def wrapped(config):
        resolved = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    # Keep resource annotations through the wrap.
    if hasattr(trainable, "_tune_resources"):
        wrapped._tune_resources = trainable._tune_resources
    return wrapped


class PlacementGroupFactory:
    """Per-trial resource request as placement-group bundles (reference:
    ``tune.PlacementGroupFactory``). The first bundle hosts the trial
    actor; extra bundles reserve room for what it spawns."""

    def __init__(self, bundles, strategy: str = "PACK"):
        if not bundles:
            raise ValueError("PlacementGroupFactory needs >= 1 bundle")
        self.bundles = [dict(b) for b in bundles]
        self.strategy = strategy

    def head_resources(self) -> dict:
        return dict(self.bundles[0])

    def __repr__(self):
        return (f"PlacementGroupFactory({self.bundles}, "
                f"strategy={self.strategy!r})")


def with_resources(trainable: Any,
                   resources: Union[dict, PlacementGroupFactory,
                                    Callable]) -> Any:
    """Attach a per-trial resource request (reference:
    ``tune.with_resources``). ``resources`` is a dict like
    ``{"CPU": 2, "GPU": 1}``, a :class:`PlacementGroupFactory`, or a
    ``config -> resources`` callable."""
    trainable._tune_resources = resources
    return trainable
