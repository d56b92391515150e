"""Accelerator manager interface.

Mirrors the reference ABC (``python/ray/_private/accelerators/accelerator.py``):
each accelerator family answers "how many are on this node", "what type are
they", and "how do I pin a worker process to a subset".
"""

from __future__ import annotations

from typing import Dict, List, Optional


class AcceleratorManager:
    """One per accelerator family (TPU here; the reference also ships
    NVIDIA/AMD/Intel GPU, HPU, NPU, Neuron)."""

    resource_name: str = "ACCEL"

    def get_current_node_num_accelerators(self) -> int:
        """Number of schedulable accelerator units on this host."""
        raise NotImplementedError

    def get_current_node_accelerator_type(self) -> Optional[str]:
        """Family/generation string (e.g. ``v5p``), if detectable."""
        raise NotImplementedError

    def get_current_node_extra_resources(self) -> Dict[str, float]:
        """Additional marker resources (e.g. the TPU pod-head resource)."""
        return {}

    def get_visible_accelerator_ids_env_var(self) -> str:
        """Env var used to restrict a worker to specific units."""
        raise NotImplementedError

    def set_visible_accelerators(self, env: Dict[str, str],
                                 ids: List[str]) -> None:
        """Mutate a worker's env so it sees exactly ``ids``."""
        env[self.get_visible_accelerator_ids_env_var()] = ",".join(ids)
