"""Model multiplexing: many models per deployment, LRU-cached per replica.

Reference: ``python/ray/serve/multiplex.py`` (``@serve.multiplexed`` +
``serve.get_multiplexed_model_id``): a replica lazily loads the model a
request addresses (``handle.options(multiplexed_model_id=...)``) and keeps
an LRU of at most ``max_num_models_per_replica`` loaded models — the
standard pattern for serving fleets of LoRA adapters or per-tenant
checkpoints off one TPU deployment.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
from collections import OrderedDict
from typing import Any, Callable, Optional

_model_id_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Model id of the current request (empty if not multiplexed)."""
    return _model_id_ctx.get()


def _set_multiplexed_model_id(model_id: str):
    return _model_id_ctx.set(model_id or "")


def _reset_multiplexed_model_id(token) -> None:
    _model_id_ctx.reset(token)


class _MultiplexWrapper:
    # State lives on the OWNER instance (not keyed by id(): ids recycle and
    # a module-level map would pin dead instances' models forever).
    _CACHE_ATTR = "__serve_mux_cache__"
    _LOADING_ATTR = "__serve_mux_loading__"

    def __init__(self, func: Callable, max_models: int):
        self.func = func
        self.max_models = max_models

    def _state(self, owner, attr, factory):
        state = getattr(owner, attr, None)
        if state is None:
            state = factory()
            setattr(owner, attr, state)
        return state

    async def load(self, owner, model_id: str) -> Any:
        cache: OrderedDict = self._state(owner, self._CACHE_ATTR,
                                         OrderedDict)
        if model_id in cache:
            cache.move_to_end(model_id)
            return cache[model_id]
        # Concurrent requests for the same uncached model share one load.
        loading: dict = self._state(owner, self._LOADING_ATTR, dict)
        if model_id in loading:
            return await asyncio.shield(loading[model_id])
        fut = asyncio.get_running_loop().create_future()
        fut.add_done_callback(lambda f: f.exception())  # consumed below
        loading[model_id] = fut
        try:
            model = self.func(owner, model_id)
            if asyncio.iscoroutine(model):
                model = await model
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)
            raise
        finally:
            loading.pop(model_id, None)
        cache[model_id] = model
        fut.set_result(model)
        while len(cache) > self.max_models:
            _, evicted = cache.popitem(last=False)
            unload = getattr(evicted, "__serve_unload__", None)
            if callable(unload):
                try:
                    unload()
                except Exception:
                    pass
        return model


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for the replica's model loader method."""

    def wrap(f):
        wrapper = _MultiplexWrapper(f, max_num_models_per_replica)

        @functools.wraps(f)
        async def loader(self, model_id: Optional[str] = None):
            model_id = model_id or get_multiplexed_model_id()
            if not model_id:
                raise ValueError(
                    "no model id: call through "
                    "handle.options(multiplexed_model_id=...) or pass one")
            return await wrapper.load(self, model_id)

        loader.__serve_multiplex_wrapper__ = wrapper
        return loader

    if func is not None:
        return wrap(func)
    return wrap
