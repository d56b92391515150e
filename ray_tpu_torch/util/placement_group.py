"""Placement groups: gang-reserved resource bundles.

API analog of ``python/ray/util/placement_group.py:211``; strategies
PACK / SPREAD / STRICT_PACK / STRICT_SPREAD mirror the reference's bundle
scheduling policies (``raylet/scheduling/policy/bundle_scheduling_policy.cc``).
A bundle that asks for GPUs reserves its cards on its node, and the tasks
and actors placed in it are pinned to those cards.
"""

from __future__ import annotations

from concurrent import futures
from concurrent.futures import Future as SyncFuture
from typing import Dict, List, Optional

from .._private.ids import PlacementGroupID
from .._private.worker import global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str,
                 ready_future: Optional[SyncFuture] = None):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy
        self._ready_future = ready_future

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        """Block until all bundles are reserved; True on success."""
        if self._ready_future is None:
            return True
        try:
            reply = self._ready_future.result(timeout_seconds)
        except futures.TimeoutError:
            # On py<3.11 concurrent.futures.TimeoutError is NOT the
            # builtin TimeoutError — catching only the builtin let a
            # reservation timeout escape as an exception.
            return False
        except TimeoutError:
            return False
        return bool(reply.get("ready"))

    def ready(self):
        """Return an ObjectRef that resolves when the group is placed
        (submits a trivial task into bundle 0, like the reference)."""
        from .. import remote
        from .scheduling_strategies import PlacementGroupSchedulingStrategy

        @remote
        def _pg_ready():
            return True

        self.wait()
        return _pg_ready.options(
            num_cpus=0,
            scheduling_strategy=PlacementGroupSchedulingStrategy(
                placement_group=self, placement_group_bundle_index=0),
        ).remote()

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.bundle_specs, self.strategy, None))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"invalid bundle: {b!r}")
    w = global_worker()
    pg_id = PlacementGroupID.from_random()
    # One request frame carries the whole bundle set (the GCS reserves
    # all-or-nothing in a single pass); the reply future comes straight
    # off the IO loop — no per-create helper thread (a thread spawn per
    # placement_group() dominated the create/removal cycle cost).
    fut = w.request_gcs_future({
        "t": "pg_create", "pgid": pg_id.binary(),
        "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
        "strategy": strategy, "name": name})
    return PlacementGroup(pg_id, bundles, strategy, fut)


def remove_placement_group(pg: PlacementGroup):
    # Fire-and-forget: frames on the GCS connection are FIFO, so any
    # later request (a new pg_create reusing the released resources, a
    # pg_list) is handled after the removal — no ack round trip needed.
    global_worker().send_gcs_threadsafe(
        {"t": "pg_remove", "pgid": pg.id.binary()})


def placement_group_table() -> Dict[str, dict]:
    reply = global_worker().request_gcs({"t": "pg_list"})
    return {
        p["pgid"].hex(): {
            "state": p["state"], "name": p["name"],
            "strategy": p["strategy"], "bundles": p["bundles"],
        }
        for p in reply.get("pgs", [])
    }
