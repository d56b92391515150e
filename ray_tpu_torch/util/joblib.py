"""joblib parallel backend over cluster tasks.

Analog of the reference's ``ray.util.joblib`` (``python/ray/util/joblib/``):
``register_ray()`` registers a backend so existing joblib/scikit-learn code
— ``Parallel(n_jobs=..., backend="ray")`` or
``parallel_backend("ray")`` — fans its batches out as cluster tasks.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _run_batch(batch):
    # ``batch`` is joblib's BatchedCalls: calling it runs the whole batch.
    return batch()


class _RayFuture:
    """joblib-shaped async result: .get(timeout) + completion callback."""

    def __init__(self, ref, callback: Optional[Callable]):
        self._ref = ref
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        if callback is not None:
            threading.Thread(target=self._wait_and_call,
                             args=(callback,), daemon=True).start()

    def _resolve(self, timeout=None):
        try:
            self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
        except BaseException as e:  # noqa: BLE001
            self._error = e
        self._event.set()

    def _wait_and_call(self, callback):
        self._resolve()
        if self._error is None:
            callback(self._value)

    def get(self, timeout=None):
        if not self._event.is_set():
            self._resolve(timeout)
        if self._error is not None:
            raise self._error
        return self._value


def _make_backend():
    from joblib._parallel_backends import (AutoBatchingMixin,
                                           ParallelBackendBase)

    class RayBackend(AutoBatchingMixin, ParallelBackendBase):
        """Batches execute as ``@remote`` tasks; n_jobs=-1 uses the
        cluster's CPU total."""

        supports_timeout = True

        def configure(self, n_jobs=1, parallel=None, **kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                return 1
            if n_jobs < 0:
                try:
                    return max(1, int(
                        ray_tpu_torch.cluster_resources().get("CPU", 1)))
                except Exception:
                    return 1
            return n_jobs

        def apply_async(self, func, callback=None):
            return _RayFuture(_run_batch.remote(func), callback)

        def abort_everything(self, ensure_ready=True):
            if ensure_ready:
                self.configure(n_jobs=self.parallel.n_jobs,
                               parallel=self.parallel)

    return RayBackend


def register_ray():
    """Register the 'ray' joblib backend (idempotent)."""
    import joblib

    joblib.register_parallel_backend("ray", _make_backend())
