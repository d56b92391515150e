"""Scheduling strategies (reference: ``python/ray/util/scheduling_strategies.py``)."""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group, placement_group_bundle_index: int = 0,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: bytes, soft: bool = False):
        if isinstance(node_id, str):
            node_id = bytes.fromhex(node_id)
        self.node_id = node_id
        self.soft = soft
