"""Dynamic request batching (reference: ``python/ray/serve/batching.py``).

``@serve.batch`` wraps an async method taking a list of inputs; concurrent
callers are queued and flushed as one call when the batch fills or the wait
timeout expires — the standard trick for feeding TPU inference with full
batches (MXU wants large batched matmuls, not single requests).
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self.queue: List = []  # (item, future)
        self._flush_task: Optional[asyncio.Task] = None

    async def submit(self, instance, item):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.queue.append((item, fut))
        if len(self.queue) >= self.max_batch_size:
            self._do_flush(instance)
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(self._delayed_flush(instance))
        return await fut

    async def _delayed_flush(self, instance):
        await asyncio.sleep(self.timeout_s)
        self._do_flush(instance)

    def _do_flush(self, instance):
        if not self.queue:
            return
        batch, self.queue = self.queue, []
        asyncio.get_running_loop().create_task(self._run(instance, batch))

    async def _run(self, instance, batch):
        items = [b[0] for b in batch]
        futs = [b[1] for b in batch]
        try:
            if instance is not None:
                outs = await self.fn(instance, items)
            else:
                outs = await self.fn(items)
            if len(outs) != len(items):
                raise ValueError(
                    f"batched function returned {len(outs)} results for "
                    f"{len(items)} inputs")
            for f, o in zip(futs, outs):
                if not f.done():
                    f.set_result(o)
        except Exception as e:  # noqa: BLE001
            for f in futs:
                if not f.done():
                    f.set_exception(e)


def batch(fn=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for dynamic batching of async methods."""

    def wrap(f):
        queues = {}

        @functools.wraps(f)
        async def wrapper(*args):
            if len(args) == 2:  # bound method (self, item)
                instance, item = args
            else:
                instance, item = None, args[0]
            key = id(instance)
            q = queues.get(key)
            if q is None:
                q = _BatchQueue(f, max_batch_size, batch_wait_timeout_s)
                queues[key] = q
            return await q.submit(instance, item)

        wrapper._is_serve_batch = True
        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap
