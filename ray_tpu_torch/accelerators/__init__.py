"""Pluggable accelerator managers.

Analog of the reference's ``python/ray/_private/accelerators/`` (ABC in
``accelerator.py``). The GPU manager is the load-bearing one here: the
worker pins itself to the card ids the GCS assigned through
``GPUAcceleratorManager.set_visible_accelerators`` before its first CUDA
call.
"""

from .accelerator import AcceleratorManager
from .gpu import GPUAcceleratorManager, NeuronAcceleratorManager

_MANAGERS = {"GPU": GPUAcceleratorManager(),
             "neuron_cores": NeuronAcceleratorManager()}


def get_accelerator_manager(resource_name: str = "GPU") -> AcceleratorManager:
    return _MANAGERS[resource_name]


def get_all_accelerator_managers():
    return dict(_MANAGERS)


def detect_accelerator_resources() -> dict:
    """Schedulable resources contributed by every accelerator on this host."""
    out: dict = {}
    for mgr in _MANAGERS.values():
        n = mgr.get_current_node_num_accelerators()
        if n > 0:
            out[mgr.resource_name] = float(n)
        out.update(mgr.get_current_node_extra_resources())
    return out


__all__ = [
    "AcceleratorManager",
    "GPUAcceleratorManager",
    "NeuronAcceleratorManager",
    "get_accelerator_manager",
    "get_all_accelerator_managers",
    "detect_accelerator_resources",
]
