"""Autoscaler instance lifecycle state machine.

Analog of the reference's v2 ``InstanceManager``
(``python/ray/autoscaler/v2/instance_manager/instance_manager.py:29``):
every cloud instance the autoscaler owns moves through explicit states,

    QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING -> RAY_DRAINING
                 |             |            |              |
                 v             v            v              v
         ALLOCATION_FAILED  TERMINATED  TERMINATED  TERMINATING/TERMINATED

(RAY_DRAINING: the autoscaler requested a GCS drain for the node —
scale-down vacates work before the provider instance is terminated.)

and each ``reconcile()`` compares that ledger against two ground truths —
what the PROVIDER still reports (cloud reality) and which nodes the GCS
sees alive (ray reality). The gap between them is what matters on real
GPU fleets: a preempted spot VM vanishes from the provider while the ledger
still says RAY_RUNNING — reconcile marks it TERMINATED/preempted, the
type's live count drops, and the demand scheduler relaunches it on the
next round.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Dict, List, Optional

from .node_provider import NodeInstance, NodeProvider

logger = logging.getLogger(__name__)

# Lifecycle states (reference: Instance proto states in
# autoscaler.proto / instance_manager.py:29).
QUEUED = "QUEUED"                    # decided to launch; not yet requested
REQUESTED = "REQUESTED"              # provider.create_node in flight
ALLOCATED = "ALLOCATED"              # cloud instance exists; ray not up yet
RAY_RUNNING = "RAY_RUNNING"          # node registered alive with the GCS
RAY_DRAINING = "RAY_DRAINING"        # GCS drain requested; vacating work
TERMINATING = "TERMINATING"          # terminate requested, not yet gone
TERMINATED = "TERMINATED"            # gone from the provider
ALLOCATION_FAILED = "ALLOCATION_FAILED"

# RAY_DRAINING still counts as live capacity: the node exists until its
# work migrates, and excluding it would make the demand scheduler launch
# a replacement for a node being scaled DOWN.
LIVE_STATES = (QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING, RAY_DRAINING)


class Instance:
    """One managed instance + its transition history."""

    def __init__(self, node_type: str, resources: Dict[str, float]):
        self.im_id = f"im-{uuid.uuid4().hex[:10]}"
        self.node_type = node_type
        self.resources = dict(resources)
        self.state = QUEUED
        self.cloud_instance_id: Optional[str] = None
        self.node_id_hex: Optional[str] = None
        self.preempted = False
        self.error: Optional[str] = None
        self.terminal_at: Optional[float] = None
        self.history: List[tuple] = [(time.time(), QUEUED, "")]

    def transition(self, state: str, reason: str = ""):
        self.state = state
        self.history.append((time.time(), state, reason))
        if state in (TERMINATED, ALLOCATION_FAILED):
            self.terminal_at = time.time()

    def __repr__(self):
        return (f"Instance({self.im_id} {self.node_type} {self.state}"
                f"{' preempted' if self.preempted else ''})")


class InstanceManager:
    """The ledger + reconciler for provider-managed instances.

    Terminal entries (TERMINATED / ALLOCATION_FAILED) are garbage-
    collected ``gc_after_s`` after reaching their terminal state — a
    churning preemptible fleet must not grow the ledger (and every
    reconcile scan) without bound."""

    def __init__(self, provider: NodeProvider, gc_after_s: float = 600.0):
        self.provider = provider
        self.gc_after_s = gc_after_s
        self.instances: Dict[str, Instance] = {}

    # ------------------------------------------------------------- intents

    def launch(self, node_type: str, resources: Dict[str, float],
               count: int = 1) -> List[Instance]:
        out = []
        for _ in range(count):
            inst = Instance(node_type, resources)
            self.instances[inst.im_id] = inst
            out.append(inst)
        return out

    def drain(self, im_id: str, reason: str = "drain"):
        """Mark an instance as vacating: a GCS drain was requested for its
        node — terminate() follows once the GCS reports the node idle (or
        dead), never while work is still running there."""
        inst = self.instances.get(im_id)
        if inst is None or inst.state != RAY_RUNNING:
            return
        inst.transition(RAY_DRAINING, reason)

    def terminate(self, im_id: str, reason: str = "requested"):
        inst = self.instances.get(im_id)
        if inst is None or inst.state not in (ALLOCATED, RAY_RUNNING,
                                              RAY_DRAINING):
            return
        try:
            self.provider.terminate_node(inst.cloud_instance_id)
            inst.transition(TERMINATING, reason)
        except Exception as e:  # noqa: BLE001
            inst.error = str(e)
            logger.warning("terminate %s failed: %s", inst, e)

    # ----------------------------------------------------------- queries

    def live_counts(self) -> Dict[str, int]:
        """Per-type instances in any live state — the capacity ledger the
        demand scheduler plans against (a preempted instance leaves this
        count, which is exactly what triggers its replacement)."""
        out: Dict[str, int] = {}
        for inst in self.instances.values():
            if inst.state in LIVE_STATES:
                out[inst.node_type] = out.get(inst.node_type, 0) + 1
        return out

    def by_cloud_id(self) -> Dict[str, Instance]:
        return {i.cloud_instance_id: i for i in self.instances.values()
                if i.cloud_instance_id is not None}

    def find_by_node_id(self, node_id_hex: str) -> Optional[Instance]:
        for inst in self.instances.values():
            if inst.node_id_hex == node_id_hex:
                return inst
        return None

    # ----------------------------------------------------------- reconcile

    def reconcile(self, alive_node_ids: List[str]) -> List[dict]:
        """Drive transitions from the two ground truths; returns events.

        ``alive_node_ids``: node ids (hex) the GCS currently sees alive.
        Provider reality comes from ``provider.non_terminated_nodes()``.
        """
        events: List[dict] = []
        cloud: Dict[str, NodeInstance] = {
            n.instance_id: n for n in self.provider.non_terminated_nodes()}
        alive = set(alive_node_ids)
        now = time.time()
        for im_id, inst in list(self.instances.items()):
            if (inst.terminal_at is not None
                    and now - inst.terminal_at > self.gc_after_s):
                del self.instances[im_id]

        for inst in list(self.instances.values()):
            if inst.state == QUEUED:
                inst.transition(REQUESTED)
                try:
                    created = self.provider.create_node(
                        inst.node_type, dict(inst.resources))
                    inst.cloud_instance_id = created.instance_id
                    inst.node_id_hex = created.node_id_hex
                    inst.transition(ALLOCATED)
                    events.append({"event": "allocated",
                                   "instance": inst.im_id,
                                   "type": inst.node_type})
                except Exception as e:  # noqa: BLE001
                    inst.error = str(e)
                    inst.transition(ALLOCATION_FAILED, str(e))
                    events.append({"event": "allocation_failed",
                                   "instance": inst.im_id,
                                   "error": str(e)})
            elif inst.state == ALLOCATED:
                if inst.cloud_instance_id not in cloud:
                    # Vanished before ray came up: preempted at boot.
                    inst.preempted = True
                    inst.transition(TERMINATED, "preempted before ray start")
                    events.append({"event": "preempted",
                                   "instance": inst.im_id,
                                   "type": inst.node_type,
                                   "phase": "allocated"})
                elif inst.node_id_hex in alive:
                    inst.transition(RAY_RUNNING)
                    events.append({"event": "ray_running",
                                   "instance": inst.im_id,
                                   "type": inst.node_type})
            elif inst.state in (RAY_RUNNING, RAY_DRAINING):
                if inst.cloud_instance_id not in cloud:
                    # The cloud took the instance back (spot preemption /
                    # maintenance): detect and release its capacity.
                    inst.preempted = True
                    inst.transition(TERMINATED, "preempted")
                    events.append({"event": "preempted",
                                   "instance": inst.im_id,
                                   "type": inst.node_type,
                                   "phase": "running"})
            elif inst.state == TERMINATING:
                if inst.cloud_instance_id not in cloud:
                    inst.transition(TERMINATED)
                    events.append({"event": "terminated",
                                   "instance": inst.im_id,
                                   "type": inst.node_type})
        return events

    def summary(self) -> Dict[str, Any]:
        states: Dict[str, int] = {}
        for inst in self.instances.values():
            states[inst.state] = states.get(inst.state, 0) + 1
        return {"states": states,
                "preempted_total": sum(1 for i in self.instances.values()
                                       if i.preempted)}
