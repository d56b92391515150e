"""Distributed FIFO queue (actor-backed).

Reference: ``python/ray/util/queue.py`` — a bounded asyncio.Queue inside
an actor, with blocking/non-blocking put/get and batch variants, shared
by any number of producers/consumers across the cluster.
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio

        self.q: "asyncio.Queue" = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        import asyncio

        if timeout is None:
            await self.q.put(item)
            return True
        try:
            await asyncio.wait_for(self.q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put_nowait(self, item) -> bool:
        import asyncio

        try:
            self.q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        if timeout is None:
            return (True, await self.q.get())
        try:
            return (True, await asyncio.wait_for(self.q.get(), timeout))
        except asyncio.TimeoutError:
            return (False, None)

    def get_nowait(self):
        import asyncio

        try:
            return (True, self.q.get_nowait())
        except asyncio.QueueEmpty:
            return (False, None)

    def get_nowait_batch(self, n: int) -> List[Any]:
        import asyncio

        out = []
        for _ in range(n):
            try:
                out.append(self.q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    def qsize(self) -> int:
        return self.q.qsize()

    def empty(self) -> bool:
        return self.q.empty()

    def full(self) -> bool:
        return self.q.full()


class Queue:
    """Cluster-wide FIFO queue handle (reference ``ray.util.queue.Queue``).

    Handles are picklable: pass them into tasks/actors freely.
    """

    def __init__(self, maxsize: int = 0, *, actor_options: Optional[dict]
                 = None, _actor=None):
        if _actor is not None:
            self.actor = _actor
            return
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        opts.setdefault("max_concurrency", 100)
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full()
            return
        if not ray_tpu_torch.get(self.actor.put.remote(item, timeout)):
            raise Full()

    async def put_async(self, item, timeout: Optional[float] = None):
        if not await self.actor.put.remote(item, timeout):
            raise Full()

    def get(self, block: bool = True, timeout: Optional[float] = None):
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
        else:
            ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty()
        return item

    async def get_async(self, timeout: Optional[float] = None):
        ok, item = await self.actor.get.remote(timeout)
        if not ok:
            raise Empty()
        return item

    def get_nowait_batch(self, n: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(n))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self):
        try:
            ray_tpu_torch.kill(self.actor)
        except Exception:
            pass

    def __reduce__(self):
        return (_rebuild_queue, (self.actor,))


def _rebuild_queue(actor):
    """Unpickle path: wrap the EXISTING actor (constructing Queue() here
    would spawn an orphan queue actor per deserialization)."""
    return Queue(_actor=actor)
