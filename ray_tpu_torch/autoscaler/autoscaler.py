"""The autoscaler reconciler.

Analog of the reference's v2 ``Autoscaler`` (``autoscaler/v2/autoscaler.py:
42``) + ``InstanceManager`` state machine (``v2/instance_manager/
instance_manager.py:29``): each ``update()`` reads the GCS demand/idle view
(``autoscaler_state``), plans launches with ``ResourceDemandScheduler``,
launches via the provider, and retires nodes idle past the timeout
(never below ``min_workers``) through the GCS graceful-drain path:
drain first (no new placements, running work migrates), terminate the
cloud instance only once the node reports no running work.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .instance_manager import (RAY_DRAINING, RAY_RUNNING, Instance,
                               InstanceManager)
from .node_provider import NodeProvider
from .scheduler import ResourceDemandScheduler

logger = logging.getLogger(__name__)


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    # Max instances launched per update round (reference: upscaling_speed).
    max_launches_per_round: int = 100
    # Migration window granted to a node drained for idle scale-down
    # (in-flight work that appears mid-drain gets this long to finish
    # before the GCS forces the node DEAD).
    drain_deadline_s: float = 60.0

    def scheduler_types(self) -> Dict[str, dict]:
        return {name: {"resources": dict(c.resources),
                       "min_workers": c.min_workers,
                       "max_workers": c.max_workers}
                for name, c in self.node_types.items()}


class Autoscaler:
    def __init__(self, config: AutoscalerConfig, provider: NodeProvider,
                 gcs_address: str):
        self.config = config
        self.provider = provider
        self.gcs_address = gcs_address
        self.scheduler = ResourceDemandScheduler(config.scheduler_types())
        # Explicit per-instance lifecycle (reference: v2 InstanceManager,
        # instance_manager.py:29) — launches, ray-up detection, and
        # preemption detection all flow through this ledger.
        self.im = InstanceManager(provider)
        self._client = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.launched_total = 0
        self.terminated_total = 0
        self.preempted_total = 0
        # im_id -> consecutive not-busy rounds while RAY_DRAINING (the
        # settle window before terminate).
        self._drain_settle: Dict[str, int] = {}

    # ------------------------------------------------------------ plumbing

    def _gcs(self):
        if self._client is None or self._client.closed:
            from ray_tpu_torch._private.worker import Worker

            self._client = Worker(role="driver")
            self._client.connect(self.gcs_address)
        return self._client

    def _state(self) -> dict:
        return self._gcs().request_gcs({"t": "autoscaler_state"}, timeout=10)

    def _request_drain(self, node_id_hex: str, reason: str) -> bool:
        """Ask the GCS to drain a node (no new placements; running work
        migrates) ahead of terminating its instance."""
        try:
            reply = self._gcs().request_gcs(
                {"t": "drain_node", "node_id": bytes.fromhex(node_id_hex),
                 "reason": reason,
                 "deadline_s": self.config.drain_deadline_s}, timeout=10)
            return bool(reply.get("ok"))
        except Exception:  # noqa: BLE001 — retried next round
            logger.warning("drain request for node %s failed",
                           node_id_hex[:8])
            return False

    # ----------------------------------------------------------- reconcile

    def update(self) -> dict:
        """One reconcile round; returns a summary for tests/logging."""
        state = self._state()
        alive_nodes = [n for n in state["nodes"] if n["alive"]]
        demands = list(state["demands"])

        # 1. Reconcile the instance ledger against provider + GCS reality:
        #    QUEUED instances launch, ALLOCATED ones become RAY_RUNNING as
        #    their node registers, vanished cloud instances (preempted spot
        #    VMs) transition to TERMINATED and free their type's count.
        events = self.im.reconcile([n["node_id"] for n in alive_nodes])

        # 2. Plan launches against the LEDGER's live counts (not the raw
        #    provider listing): in-flight launches count, preempted ones
        #    don't — so a preempted VM is replaced on this very round.
        counts = self.im.live_counts()
        # DRAINING nodes' free capacity is NOT packable (the GCS refuses
        # placements there) — offering it to the demand scheduler would
        # stall pending work for the whole drain window with no launch.
        avail = [dict(n["avail"]) for n in alive_nodes
                 if not n.get("draining")]
        plan = self.scheduler.get_nodes_to_launch(demands, avail, counts)

        launched: List[Instance] = []
        budget = self.config.max_launches_per_round
        for name, count in plan.items():
            cfg = self.config.node_types[name]
            n = min(count, budget)
            if n > 0:
                launched.extend(self.im.launch(name, dict(cfg.resources), n))
                budget -= n
        if launched:
            # Move QUEUED -> ALLOCATED now (provider create), so capacity
            # is requested this round, not next.
            events += self.im.reconcile([n["node_id"] for n in alive_nodes])
        self.launched_total += len(launched)
        # Preemption accounting covers BOTH reconcile calls this round.
        preempted = [e for e in events if e["event"] == "preempted"]
        if preempted:
            self.preempted_total += len(preempted)
            logger.warning("detected %d preempted instance(s): %s",
                           len(preempted), preempted)

        # 3. Idle termination goes through the DRAIN path: an idle node is
        #    first drained in the GCS (no new placements; anything that
        #    raced onto it migrates within the deadline) and its instance
        #    is terminated only once the GCS reports it free of running
        #    work — never a direct kill of a node with work on it.
        #    Still never below min_workers, never while demand is pending.
        terminated = []
        drained = []
        # Instances already RAY_DRAINING still count in live_counts()
        # (they hold capacity until terminated) but are ALREADY leaving:
        # the min_workers floor must see them as gone, or successive
        # rounds drain one node each past the floor down to zero.
        already_draining: Dict[str, int] = {}
        for i2 in self.im.instances.values():
            if i2.state == RAY_DRAINING:
                already_draining[i2.node_type] = (
                    already_draining.get(i2.node_type, 0) + 1)
        if not demands:
            for n in alive_nodes:
                inst = self.im.find_by_node_id(n["node_id"])
                if inst is None:
                    continue  # head / externally-managed / not up yet
                if inst.state == RAY_DRAINING:
                    # Terminate only after TWO consecutive not-busy
                    # rounds: the GCS's busy bit cannot see direct-push
                    # work finishing on a just-revoked lease, so one
                    # settle round lets in-flight pushes drain before the
                    # instance goes away.
                    if not n.get("busy", False):
                        seen = self._drain_settle.get(inst.im_id, 0) + 1
                        self._drain_settle[inst.im_id] = seen
                        if seen >= 2:
                            self._drain_settle.pop(inst.im_id, None)
                            self.im.terminate(inst.im_id, "idle (drained)")
                            terminated.append(inst)
                    else:
                        self._drain_settle.pop(inst.im_id, None)
                    continue
                if inst.state != RAY_RUNNING:
                    continue
                cfg = self.config.node_types.get(inst.node_type)
                min_w = cfg.min_workers if cfg else 0
                live = counts.get(inst.node_type, 0)
                if (n["idle_s"] > self.config.idle_timeout_s
                        and live
                        - already_draining.get(inst.node_type, 0)
                        - len([t for t in drained
                               if t.node_type == inst.node_type])
                        > min_w):
                    if self._request_drain(n["node_id"],
                                           "autoscaler idle scale-down"):
                        self.im.drain(inst.im_id, "idle")
                        drained.append(inst)
        # A draining node the GCS already forced DEAD (drain deadline
        # expired, or it died on its own) no longer shows up alive —
        # release its instance regardless of pending demand, or the
        # ledger leaks a cloud instance per expired drain.
        alive_ids = {n["node_id"] for n in alive_nodes}
        for inst in list(self.im.instances.values()):
            if inst.state == RAY_DRAINING and inst.node_id_hex not in alive_ids:
                # also forget its settle counter — this release path
                # bypasses the two-round settle bookkeeping above
                self._drain_settle.pop(inst.im_id, None)
                self.im.terminate(inst.im_id, "drained (node dead)")
                terminated.append(inst)
        self.terminated_total += len(terminated)
        return {"demands": len(demands),
                "launched": [i.node_type for i in launched],
                "drained": [i.node_type for i in drained],
                "terminated": [i.node_type for i in terminated],
                "events": events,
                "instances": self.im.summary()}

    # ------------------------------------------------------------- driving

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ray_tpu_torch-autoscaler")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")
            self._stop.wait(self.config.update_interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._client is not None:
            self._client.disconnect()
            self._client = None
