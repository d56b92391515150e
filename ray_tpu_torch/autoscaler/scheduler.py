"""Demand-based bin-packing: which nodes to launch for pending work.

Analog of the reference's ``ResourceDemandScheduler``
(``autoscaler/_private/resource_demand_scheduler.py:102``, v2
``autoscaler/v2/scheduler.py:624``): first-fit-decreasing packing of
unfulfilled demands onto existing free capacity, then onto hypothetical
nodes of configured types, respecting per-type max_workers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


def _sub(avail: Dict[str, float], req: Dict[str, float]):
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


class ResourceDemandScheduler:
    def __init__(self, node_types: Dict[str, dict]):
        """``node_types``: name -> {"resources": {...}, "min_workers": int,
        "max_workers": int}."""
        self.node_types = node_types

    def get_nodes_to_launch(
        self,
        demands: List[Dict[str, float]],
        node_avail: List[Dict[str, float]],
        current_counts: Dict[str, int],
    ) -> Dict[str, int]:
        """Plan launches. ``demands`` are pending resource requests;
        ``node_avail`` the free capacity of live nodes; ``current_counts``
        live+pending instances per node type."""
        free = [dict(a) for a in node_avail]
        planned: Dict[str, int] = {}
        planned_free: List[Tuple[str, Dict[str, float]]] = []
        # Biggest demands first: FFD keeps fragmentation low.
        for demand in sorted(demands,
                             key=lambda d: (-sum(d.values()), sorted(d))):
            placed = False
            for a in free:
                if _fits(a, demand):
                    _sub(a, demand)
                    placed = True
                    break
            if placed:
                continue
            for _, a in planned_free:
                if _fits(a, demand):
                    _sub(a, demand)
                    placed = True
                    break
            if placed:
                continue
            # Launch the cheapest (fewest total resources) feasible type.
            candidates = []
            for name, cfg in self.node_types.items():
                total = (current_counts.get(name, 0)
                         + planned.get(name, 0))
                if total >= cfg.get("max_workers", 0):
                    continue
                if _fits(cfg["resources"], demand):
                    candidates.append((sum(cfg["resources"].values()), name))
            if not candidates:
                continue  # infeasible demand — nothing can host it
            _, name = min(candidates)
            planned[name] = planned.get(name, 0) + 1
            a = dict(self.node_types[name]["resources"])
            _sub(a, demand)
            planned_free.append((name, a))
        # Honor min_workers regardless of demand.
        for name, cfg in self.node_types.items():
            need = cfg.get("min_workers", 0) - (
                current_counts.get(name, 0) + planned.get(name, 0))
            if need > 0:
                planned[name] = planned.get(name, 0) + need
        return planned
