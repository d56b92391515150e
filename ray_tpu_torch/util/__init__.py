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

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "placement_group_table", "NodeAffinitySchedulingStrategy",
    "PlacementGroupSchedulingStrategy", "metrics", "state",
]
