"""Node providers: pluggable "cloud" backends for the autoscaler.

Analog of the reference's ``NodeProvider`` plugin surface
(``python/ray/autoscaler/node_provider.py``; fake provider
``autoscaler/_private/fake_multi_node/node_provider.py``; GCP VMs
``_private/gcp/node_provider.py:21``). The local provider launches real
node-agent subprocesses on this machine (the fake-multi-node strategy), so
autoscaler logic runs against genuinely registering/disappearing nodes.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from abc import ABC, abstractmethod
from typing import Dict, List


class NodeInstance:
    def __init__(self, instance_id: str, node_type: str,
                 node_id_hex: str, resources: Dict[str, float]):
        self.instance_id = instance_id
        self.node_type = node_type
        self.node_id_hex = node_id_hex
        self.resources = resources
        self.created_at = time.time()


class NodeProvider(ABC):
    """Minimal provider contract the reconciler drives."""

    @abstractmethod
    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> NodeInstance:
        ...

    @abstractmethod
    def terminate_node(self, instance_id: str):
        ...

    @abstractmethod
    def non_terminated_nodes(self) -> List[NodeInstance]:
        ...


class LocalNodeProvider(NodeProvider):
    """Launches node agents as subprocesses joined to a running cluster."""

    def __init__(self, gcs_address: str, session_dir: str,
                 num_initial_workers: int = 1):
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.num_initial_workers = num_initial_workers
        self._instances: Dict[str, NodeInstance] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> NodeInstance:
        from ray_tpu_torch._private.ids import NodeID
        from ray_tpu_torch._private.node import _AGENT_BOOTSTRAP, worker_sys_path

        node_id = NodeID.from_random()
        instance_id = f"local-{uuid.uuid4().hex[:8]}"
        res = dict(resources)
        res.setdefault("memory", 1 << 30)
        res.setdefault("object_store_memory", 1 << 30)
        proc = subprocess.Popen(
            [sys.executable, "-S", "-c", _AGENT_BOOTSTRAP,
             "--gcs", self.gcs_address,
             "--session-dir", self.session_dir,
             "--resources", json.dumps(res),
             "--num-initial-workers", str(self.num_initial_workers)],
            start_new_session=True,
            stdout=open(os.path.join(
                self.session_dir, f"as-agent-{instance_id}.out"), "ab"),
            stderr=subprocess.STDOUT,
            env={**os.environ, "RAY_TPU_TORCH_NODE_ID": node_id.hex(),
                 "RAY_TPU_TORCH_SYS_PATH": worker_sys_path()},
        )
        inst = NodeInstance(instance_id, node_type, node_id.hex(), res)
        with self._lock:
            self._instances[instance_id] = inst
            self._procs[instance_id] = proc
        return inst

    def terminate_node(self, instance_id: str):
        with self._lock:
            inst = self._instances.pop(instance_id, None)
            proc = self._procs.pop(instance_id, None)
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                proc.wait(3)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        return inst

    def non_terminated_nodes(self) -> List[NodeInstance]:
        with self._lock:
            out = []
            for iid, inst in list(self._instances.items()):
                proc = self._procs.get(iid)
                if proc is not None and proc.poll() is not None:
                    # Node died underneath us (chaos, crash).
                    self._instances.pop(iid, None)
                    self._procs.pop(iid, None)
                    continue
                out.append(inst)
            return out

    def terminate_all(self):
        for inst in self.non_terminated_nodes():
            self.terminate_node(inst.instance_id)


class GPUHostNodeProvider(LocalNodeProvider):
    """Models GPU hosts: one "instance" = one host (one VM) carrying
    ``gpus_per_host`` cards and the ``accelerator_type:<type>`` label the
    GPU manager gives a node it probes (``accelerators/gpu.py``), so work
    can ask for a card type (reference: a GPU node type of
    ``gcp/node_provider.py``; the label of
    ``python/ray/_private/accelerators/nvidia_gpu.py``).
    """

    def __init__(self, gcs_address: str, session_dir: str,
                 accelerator_type: str = "H100", gpus_per_host: int = 1):
        super().__init__(gcs_address, session_dir)
        self.accelerator_type = accelerator_type
        self.gpus_per_host = gpus_per_host

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> NodeInstance:
        res = dict(resources)
        res["GPU"] = float(self.gpus_per_host)
        res[f"accelerator_type:{self.accelerator_type}"] = 1.0
        return super().create_node(node_type, res)
