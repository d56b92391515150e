from .placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
    placement_group_table,
)
from .scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

from . import metrics, pubsub, state, tracing


def __getattr__(name):
    # queue/ActorPool define actors at import (need
    # ray_tpu_torch.remote), so they must load lazily — ray_tpu_torch/
    # __init__ imports util before the public API exists.
    if name in ("queue", "actor_pool"):
        # import_module, not ``from . import``: the latter asks this
        # module for the name first and so recurses into __getattr__
        import importlib

        return importlib.import_module(f".{name}", __name__)
    if name == "ActorPool":
        from .actor_pool import ActorPool as _AP

        return _AP
    if name == "accelerators":
        import importlib

        return importlib.import_module(".accelerators", __name__)
    if name == "inspect_serializability":
        from .check_serialize import inspect_serializability as _is

        return _is
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")


__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "placement_group_table", "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy", "metrics", "state",
]
