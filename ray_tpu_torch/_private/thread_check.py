"""Thread-affinity assertions + event-loop lag instrumentation.

Reference: ``src/ray/util/thread_checker.h`` (assert single-thread
affinity of components the design says are single-threaded) and
``src/ray/common/event_stats.h`` (event-loop lag stats, flag
``ray_config_def.h:25``). Python has no TSAN, so the race-detection story
here is (a) runtime affinity assertions on the boundaries the design
declares — the worker's IO loop owns every Connection, handler state is
loop-only — and (b) continuous loop-lag measurement that makes "something
blocked the loop" visible instead of a mystery stall.

Assertions are gated on ``RAY_TPU_TORCH_THREAD_CHECKS=1`` (the CI suite turns
them on; production pays zero cost).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from typing import Dict, Optional


def checks_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_THREAD_CHECKS", "") == "1"


class ThreadChecker:
    """Binds to the first thread that calls ``check`` and raises if any
    other thread ever does (``thread_checker.h`` semantics)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._ident: Optional[int] = None
        self._lock = threading.Lock()

    def check(self):
        if not checks_enabled():
            return
        ident = threading.get_ident()
        # Fast path: once bound, read lock-free. A stale None just falls
        # through to the locked bind below; a stale non-None can only be
        # a PREVIOUS binding (reset+rebind race), which the locked path
        # would have raced identically — checks run on every hot-path
        # call, so the uncontended-lock cost was pure overhead.
        bound = self._ident
        if bound is not None:
            if bound != ident:
                self._raise(ident, bound)
            return
        with self._lock:
            if self._ident is None:
                self._ident = ident
            elif self._ident != ident:
                self._raise(ident, self._ident)

    def _raise(self, ident: int, bound: int):
        raise RuntimeError(
            f"ThreadChecker[{self.name}]: accessed from thread "
            f"{ident}, bound to {bound} — single-thread "
            f"affinity violated")

    def reset(self):
        with self._lock:
            self._ident = None


def assert_on_loop(loop: Optional[asyncio.AbstractEventLoop],
                   what: str = ""):
    """Raise when called off the given event loop (gated)."""
    if not checks_enabled() or loop is None:
        return
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is not loop:
        raise RuntimeError(
            f"{what or 'operation'} must run on its owning IO loop "
            f"(on {running!r}, owner {loop!r})")


class LoopMonitor:
    """Measures event-loop responsiveness: schedules a tick every
    ``interval`` and records how late it fires. Big lag = something
    synchronous blocked the loop (the bug class TSAN can't see but users
    feel as mystery latency)."""

    def __init__(self, interval: float = 0.1, name: str = "loop"):
        self.interval = interval
        self.name = name
        self.samples = 0
        self.max_lag = 0.0
        self.total_lag = 0.0
        self.last_lag = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self):
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self):
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(self.interval)
            lag = max(0.0, (time.perf_counter() - t0) - self.interval)
            self.samples += 1
            self.last_lag = lag
            self.total_lag += lag
            if lag > self.max_lag:
                self.max_lag = lag

    def stop(self):
        """Idempotent: safe to call twice, after the loop closed, or when
        the monitor task already finished/was cancelled externally."""
        task, self._task = self._task, None
        if task is not None and not task.done():
            task.cancel()

    def stats(self) -> Dict[str, float]:
        return {
            "samples": self.samples,
            "mean_lag_ms": round(
                self.total_lag / self.samples * 1000, 3) if self.samples
            else 0.0,
            "max_lag_ms": round(self.max_lag * 1000, 3),
            "last_lag_ms": round(self.last_lag * 1000, 3),
        }
