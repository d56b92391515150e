"""Features of the reference runtime that the port has not copied yet.

Each place that would reach one raises :func:`not_ported`, naming the
``ROADMAP.md`` item (queue A) that brings it, so nothing is faked.
"""

from __future__ import annotations

ITEMS = {
    "tooling": "A13 (autoscaler, static checks, ray:// client, "
               "cross-language calls)",
    "rl": "A14 (rl/)",
}


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a feature that waits for ROADMAP item ``item``."""
    return NotImplementedError(
        f"{feature} is not in ray_tpu_torch yet: ROADMAP {ITEMS[item]}")
