"""RuntimeEnv dataclass + driver/worker entry points.

Driver side ``prepare_runtime_env`` validates the dict and uploads any
local packages (working_dir / py_modules) to the cluster KV as
content-addressed zips, returning the wire form. Worker side
``setup_runtime_env`` runs every plugin to build and apply a
``RuntimeEnvContext``. Analog of the reference's ``RuntimeEnv`` class
(``python/ray/runtime_env/runtime_env.py``) + the runtime-env agent's
``CreateRuntimeEnv`` path — minus the agent process (see package docstring).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .context import RuntimeEnvContext
from .plugin import _REGISTRY, get_plugins

_PASSTHROUGH_KEYS = {"config"}  # opaque knobs (setup_timeout etc.)


class RuntimeEnv(dict):
    """Dict subclass so user code can pass either a plain dict or this."""

    def __init__(self, **kwargs):
        validate_runtime_env(kwargs)
        super().__init__(**kwargs)


def validate_runtime_env(renv: Dict[str, Any]) -> None:
    # Interpreter-level env types are mutually exclusive: a worker runs in
    # ONE venv or ONE container — combining them would silently satisfy
    # only the first in spawn_spec_from_renv's dispatch order.
    exclusive = [k for k in ("image_uri", "uv", "pip") if renv.get(k)
                 is not None]
    if len(exclusive) > 1:
        raise ValueError(
            f"runtime_env fields {exclusive} cannot be combined: each "
            "selects the worker's interpreter environment. Bake pip "
            "packages into the image, or use py_modules alongside one "
            "of them.")
    for key, value in renv.items():
        if key in _PASSTHROUGH_KEYS:
            continue
        plugin = _REGISTRY.get(key)
        if plugin is None:
            raise ValueError(
                f"unknown runtime_env field {key!r}; known: "
                f"{sorted(_REGISTRY) + sorted(_PASSTHROUGH_KEYS)}")
        plugin.validate(value)


def prepare_runtime_env(renv: Dict[str, Any],
                        kv_put: Optional[Callable[[str, bytes], None]] = None
                        ) -> Dict[str, Any]:
    """Driver-side: validate + upload local packages, return wire form."""
    if not renv:
        return {}
    validate_runtime_env(renv)
    if kv_put is None:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()

        def kv_put(uri: str, data: bytes) -> None:  # noqa: F811
            if w.kv_get(uri, ns="pkg") is None:
                w.kv_put(uri, data, ns="pkg")

    out = {}
    for key, value in renv.items():
        if key in _PASSTHROUGH_KEYS:
            out[key] = value
            continue
        out[key] = _REGISTRY[key].prepare(value, kv_put)
    return out


def setup_runtime_env(renv: Dict[str, Any],
                      fetch: Callable[[str], Optional[bytes]],
                      apply: bool = True) -> RuntimeEnvContext:
    """Worker-side: run plugins, build the context, optionally apply it."""
    ctx = RuntimeEnvContext()
    if renv:
        for plugin in get_plugins():
            if plugin.name in renv:
                plugin.create(renv[plugin.name], ctx, fetch)
    if apply:
        ctx.apply()
    return ctx
