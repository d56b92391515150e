"""ActorPool: load-balanced map over a fixed set of actors.

Reference: ``python/ray/util/actor_pool.py`` — submit work to whichever
actor is free, get results in completion or submission order, grow the
pool at runtime.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}     # ref -> actor
        self._index_of = {}            # ref -> submission index
        self._pending = []             # (fn, value, index) awaiting an actor
        self._ready = {}               # index -> completed ref
        self._next_task = 0
        self._next_return = 0
        self._mode = None  # "ordered" | "unordered" (mixing is an error)

    # ------------------------------------------------------- submission

    def submit(self, fn: Callable[[Any, Any], Any], value: Any):
        """``fn(actor, value) -> ObjectRef``; runs once an actor is free."""
        self._pending.append((fn, value, self._next_task))
        self._next_task += 1
        self._dispatch()

    def _dispatch(self):
        while self._pending and self._idle:
            fn, value, idx = self._pending.pop(0)
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_of[ref] = idx

    # --------------------------------------------------------- results

    def has_next(self) -> bool:
        return (self._next_return < self._next_task)

    def _complete_one(self, timeout=None):
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1,
                               timeout=timeout)
        if not done:
            raise TimeoutError("no result within timeout")
        ref = done[0]
        self._idle.append(self._future_to_actor.pop(ref))
        self._dispatch()
        return ref, self._index_of.pop(ref)

    def get_next_unordered(self, timeout=None):
        """Next COMPLETED result (any order)."""
        if self._mode == "ordered":
            raise ValueError(
                "cannot mix get_next() and get_next_unordered() on one "
                "ActorPool (the ordered cursor would skip consumed "
                "results)")
        self._mode = "unordered"
        if self._ready:
            idx = next(iter(self._ready))
            self._next_return += 1
            self._maybe_reset_mode()
            return ray_tpu_torch.get(self._ready.pop(idx))
        if not self.has_next():
            raise StopIteration("no pending work")
        ref, _ = self._complete_one(timeout)
        self._next_return += 1
        self._maybe_reset_mode()
        return ray_tpu_torch.get(ref)

    def get_next(self, timeout=None):
        """Next result in SUBMISSION order."""
        if self._mode == "unordered":
            raise ValueError(
                "cannot mix get_next() and get_next_unordered() on one "
                "ActorPool (the ordered cursor would skip consumed "
                "results)")
        self._mode = "ordered"
        if not self.has_next():
            raise StopIteration("no pending work")
        want = self._next_return
        while want not in self._ready:
            ref, idx = self._complete_one(timeout)
            self._ready[idx] = ref
        self._next_return += 1
        self._maybe_reset_mode()
        return ray_tpu_torch.get(self._ready.pop(want))

    def _maybe_reset_mode(self):
        # A drained pool may switch between ordered/unordered consumption.
        if not self.has_next():
            self._mode = None

    def map(self, fn: Callable, values: Iterable[Any]):
        """Ordered results iterator (reference ``ActorPool.map``)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ------------------------------------------------------- pool admin

    def push(self, actor):
        """Add an idle actor to the pool."""
        self._idle.append(actor)
        self._dispatch()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def has_free(self) -> bool:
        return bool(self._idle)
