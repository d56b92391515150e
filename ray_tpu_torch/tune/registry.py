"""Name registries for trainables and RL environments.

Reference: ``python/ray/tune/registry.py`` (``register_trainable`` /
``register_env``; the reference persists entries in the GCS KV so any
process resolves them — here the driver resolves names BEFORE anything
ships to workers: trainables become blobs at Tuner launch and env
creators ship as ``env_fn`` closures, so a process-local registry plus
the existing blob plumbing covers the same uses).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_TRAINABLES: Dict[str, Any] = {}
_ENVS: Dict[str, Callable] = {}


def register_trainable(name: str, trainable: Any) -> None:
    """Make ``Tuner("name", ...)`` / ``tune.run("name")`` work
    (reference: ``tune.register_trainable``)."""
    if not callable(trainable) and not isinstance(trainable, type):
        raise TypeError(f"trainable must be callable, got {trainable!r}")
    _TRAINABLES[name] = trainable


def get_trainable(name: str) -> Any:
    try:
        return _TRAINABLES[name]
    except KeyError:
        raise ValueError(
            f"unknown trainable {name!r}; register it first with "
            f"tune.register_trainable (have: {sorted(_TRAINABLES)})"
        ) from None


def register_env(name: str, env_creator: Callable) -> None:
    """Make ``.environment("name")`` resolve to a custom env factory
    (reference: ``tune.register_env``). The creator ships to env-runner
    workers as an ``env_fn`` closure."""
    if not callable(env_creator):
        raise TypeError("env_creator must be callable")
    _ENVS[name] = env_creator


def get_env_creator(name: str):
    return _ENVS.get(name)
