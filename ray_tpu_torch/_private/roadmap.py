"""Features of the reference runtime that the port has not copied yet.

Each place that would reach one raises :func:`not_ported`, naming the
``ROADMAP.md`` item (queue A) that brings it, so nothing is faked.
"""

from __future__ import annotations

ITEMS = {
    "runtime_env": "A12 (runtime_env: pip, conda, container)",
    "tooling": "A13 (autoscaler, dashboard, job, client, static checks)",
    "rl": "A14 (rl/)",
}


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a feature that waits for ROADMAP item ``item``."""
    return NotImplementedError(
        f"{feature} is not in ray_tpu_torch yet: ROADMAP {ITEMS[item]}")
