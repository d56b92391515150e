"""Features of the reference runtime that the port has not copied yet.

Each place that would reach one raises :func:`not_ported`, naming the
``ROADMAP.md`` item (queue A) that brings it, so nothing is faked.
"""

from __future__ import annotations

ITEMS = {
    "tooling": "A13b (the static checks: analysis/, scripts.py check, "
               "RAY_TPU_TORCH_STATIC_CHECKS at remote decoration)",
    "rl": "A14b (rl/'s second half: dqn.py, sac.py, continuous.py, "
          "cql.py, offline.py, dreamerv3.py)",
}


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a feature that waits for ROADMAP item ``item``."""
    return NotImplementedError(
        f"{feature} is not in ray_tpu_torch yet: ROADMAP {ITEMS[item]}")
