"""``multiprocessing.Pool`` drop-in over cluster tasks.

Analog of the reference's ``ray.util.multiprocessing.Pool``
(``python/ray/util/multiprocessing/pool.py``): the stdlib Pool API —
``map/starmap/apply/apply_async/imap/imap_unordered`` — where each chunk
executes as a cluster task, so a Pool-based program scales past one host
without code changes.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _run_chunk(fn, chunk, star: bool):
    if star:
        return [fn(*args) for args in chunk]
    return [fn(a) for a in chunk]


@ray_tpu_torch.remote
def _run_call(fn, args, kwargs):
    return fn(*args, **(kwargs or {}))


class AsyncResult:
    """stdlib-shaped handle over one task ref."""

    def __init__(self, ref, callback=None, error_callback=None):
        self._ref = ref
        self._callback = callback
        self._error_callback = error_callback
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None

    def _resolve(self, timeout=None):
        if self._done:
            return
        try:
            self._value = ray_tpu_torch.get(self._ref, timeout=timeout)
            self._done = True
            if self._callback is not None:
                self._callback(self._value)
        except ray_tpu_torch.GetTimeoutError:
            raise
        except BaseException as e:  # noqa: BLE001
            self._error = e
            self._done = True
            if self._error_callback is not None:
                self._error_callback(e)

    def get(self, timeout: Optional[float] = None):
        self._resolve(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout: Optional[float] = None):
        try:
            self._resolve(timeout)
        except ray_tpu_torch.GetTimeoutError:
            pass

    def ready(self) -> bool:
        if self._done:
            return True
        done, _ = ray_tpu_torch.wait([self._ref], num_returns=1, timeout=0)
        return bool(done)

    def successful(self) -> bool:
        if not self._done:
            raise ValueError("result is not ready")
        return self._error is None


class Pool:
    """Task-backed process pool. ``processes`` bounds concurrent chunks
    (defaults to the cluster's CPU count)."""

    def __init__(self, processes: Optional[int] = None):
        self._closed = False
        if processes is None:
            try:
                processes = int(ray_tpu_torch.cluster_resources().get("CPU", 4))
            except Exception:
                processes = 4
        self._processes = max(1, processes)

    # ------------------------------------------------------------ helpers

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, math.ceil(len(items) /
                                         (self._processes * 4)))
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], len(items)

    def _map_refs(self, fn, iterable, chunksize, star: bool):
        chunks, _ = self._chunks(iterable, chunksize)
        return [_run_chunk.remote(fn, c, star) for c in chunks]

    # ------------------------------------------------------------- stdlib

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        out = ray_tpu_torch.get(self._map_refs(fn, iterable, chunksize, False))
        return list(itertools.chain.from_iterable(out))

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        out = ray_tpu_torch.get(self._map_refs(fn, iterable, chunksize, True))
        return list(itertools.chain.from_iterable(out))

    def map_async(self, fn, iterable, chunksize=None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_open()
        refs = self._map_refs(fn, iterable, chunksize, False)

        @ray_tpu_torch.remote
        def _gather(*parts):
            return [x for p in parts for x in p]

        return AsyncResult(_gather.remote(*refs), callback, error_callback)

    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        self._check_open()
        return ray_tpu_torch.get(_run_call.remote(fn, args, kwds))

    def apply_async(self, fn: Callable, args: tuple = (), kwds: dict = None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_open()
        return AsyncResult(_run_call.remote(fn, args, kwds), callback,
                           error_callback)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        self._check_open()
        for ref in self._map_refs(fn, iterable, chunksize, False):
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        self._check_open()
        pending = self._map_refs(fn, iterable, chunksize, False)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in done:
                yield from ray_tpu_torch.get(ref)

    # ---------------------------------------------------------- lifecycle

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
