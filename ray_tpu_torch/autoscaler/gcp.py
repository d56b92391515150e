"""GCP GPU-VM node provider: provisions GPU hosts via gcloud.

Reference: ``python/ray/autoscaler/_private/gcp/node_provider.py:21``
(``GCPNodeProvider`` with its compute resource class) and
``gcp/config.py`` bootstrap. Instead of the GCP Python client (not a
baked-in dependency), the provider shells out to the ``gcloud compute
instances`` CLI with ``--format=json`` — the same operations
(create/list/describe/delete), testable by injecting ``exec_fn`` (tests use
a fake recorder; see ``tests/test_torch_autoscaler.py``).

A GPU host is ONE VM and one node: ``describe`` gives its address and an
``SSHCommandRunner`` reaches it. The machine type fixes the cards
(``_GPUS_PER_MACHINE``); the create call also names them with
``--accelerator type=...,count=...``.
"""

from __future__ import annotations

import json
import shutil
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from .command_runner import SSHCommandRunner, _default_exec
from .node_provider import NodeInstance, NodeProvider

# machine type -> (gcloud accelerator type, cards per VM, the
# accelerator_type label a node of it carries, ``accelerators/gpu.py``)
_GPUS_PER_MACHINE: Dict[str, Tuple[str, int, str]] = {
    "a3-highgpu-1g": ("nvidia-h100-80gb", 1, "H100"),
    "a3-highgpu-2g": ("nvidia-h100-80gb", 2, "H100"),
    "a3-highgpu-4g": ("nvidia-h100-80gb", 4, "H100"),
    "a3-highgpu-8g": ("nvidia-h100-80gb", 8, "H100"),
    "a3-megagpu-8g": ("nvidia-h100-mega-80gb", 8, "H100"),
    "a2-highgpu-1g": ("nvidia-tesla-a100", 1, "A100"),
    "a2-highgpu-8g": ("nvidia-tesla-a100", 8, "A100"),
    "a2-ultragpu-8g": ("nvidia-a100-80gb", 8, "A100-80G"),
    "g2-standard-4": ("nvidia-l4", 1, "L4"),
}

# VM states that no longer hold (or will not keep) the machine
_GONE = ("STOPPING", "TERMINATED", "SUSPENDING", "SUSPENDED")


def _gpus_of(machine_type: str) -> Tuple[str, int, str]:
    try:
        return _GPUS_PER_MACHINE[machine_type]
    except KeyError:
        raise ValueError(
            f"unknown GPU machine type {machine_type!r} (known: "
            f"{', '.join(sorted(_GPUS_PER_MACHINE))})") from None


def _node_resources(machine_type: str) -> Dict[str, float]:
    _, count, label = _gpus_of(machine_type)
    return {"GPU": float(count), f"accelerator_type:{label}": 1.0}


class GCPGPUNodeProvider(NodeProvider):
    """Provisions GPU VMs through the gcloud CLI."""

    def __init__(self, project: str, zone: str,
                 machine_type: str = "a3-highgpu-8g",
                 image_family: str = "pytorch-latest-gpu",
                 image_project: str = "deeplearning-platform-release",
                 name_prefix: str = "ray-tpu-torch",
                 exec_fn: Optional[Callable] = None,
                 preemptible: bool = False):
        if exec_fn is None and shutil.which("gcloud") is None:
            raise RuntimeError(
                "gcloud CLI not found; GCPGPUNodeProvider needs the Google "
                "Cloud SDK installed (or pass exec_fn for testing)")
        _gpus_of(machine_type)
        self.project = project
        self.zone = zone
        self.machine_type = machine_type
        self.image_family = image_family
        self.image_project = image_project
        self.name_prefix = name_prefix
        self.preemptible = preemptible
        self._exec = exec_fn or _default_exec
        self._created: Dict[str, NodeInstance] = {}

    # ------------------------------------------------------ gcloud ops

    def _gcloud(self, *args: str, timeout: float = 600) -> str:
        # ``list`` is not zonal: it takes the zone as a filter
        zone = (f"--zones={self.zone}" if args[0] == "list"
                else f"--zone={self.zone}")
        argv = ["gcloud", "compute", "instances", *args,
                f"--project={self.project}", zone,
                "--format=json", "--quiet"]
        return self._exec(argv, timeout)

    def create_node(self, node_type: str,
                    resources: Dict[str, float]) -> NodeInstance:
        name = f"{self.name_prefix}-{uuid.uuid4().hex[:8]}"
        accel, count, _ = _gpus_of(self.machine_type)
        args = ["create", name,
                f"--machine-type={self.machine_type}",
                f"--accelerator=type={accel},count={count}",
                f"--image-family={self.image_family}",
                f"--image-project={self.image_project}",
                # a VM with GPUs cannot live-migrate
                "--maintenance-policy=TERMINATE",
                "--metadata=install-nvidia-driver=True"]
        if self.preemptible:
            args.append("--provisioning-model=SPOT")
        self._gcloud(*args)
        res = dict(resources)
        for k, v in _node_resources(self.machine_type).items():
            res.setdefault(k, v)
        inst = NodeInstance(name, node_type, node_id_hex="", resources=res)
        self._created[name] = inst
        return inst

    def terminate_node(self, instance_id: str):
        self._created.pop(instance_id, None)
        self._gcloud("delete", instance_id)

    def non_terminated_nodes(self) -> List[NodeInstance]:
        raw = self._gcloud("list", timeout=60)
        out: List[NodeInstance] = []
        for node in json.loads(raw or "[]"):
            name = node.get("name", "").rsplit("/", 1)[-1]
            if not name.startswith(self.name_prefix):
                continue
            if node.get("status") in _GONE:
                # a spot VM the cloud took back shows TERMINATED
                self._created.pop(name, None)
                continue
            inst = self._created.get(name)
            if inst is None:
                machine = node.get("machineType",
                                   self.machine_type).rsplit("/", 1)[-1]
                inst = NodeInstance(
                    name, "gpu_worker", node_id_hex="",
                    resources=_node_resources(
                        machine if machine in _GPUS_PER_MACHINE
                        else self.machine_type))
                self._created[name] = inst
            out.append(inst)
        return out

    # ----------------------------------------------- host introspection

    def address(self, instance_id: str, internal: bool = True) -> str:
        """The VM's address (``describe`` networkInterfaces)."""
        raw = self._gcloud("describe", instance_id, timeout=60)
        nics = json.loads(raw or "{}").get("networkInterfaces", [])
        if not nics:
            return ""
        nic = nics[0]
        if not internal:
            for ac in nic.get("accessConfigs", []):
                if ac.get("natIP"):
                    return ac["natIP"]
        return nic.get("networkIP", "")

    def command_runner(self, instance_id: str,
                       **ssh_kwargs) -> SSHCommandRunner:
        """A runner that reaches the VM over ssh."""
        return SSHCommandRunner(self.address(instance_id), **ssh_kwargs)

    def wait_ready(self, instance_id: str, timeout: float = 900) -> bool:
        """Block until the VM reports RUNNING."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            raw = self._gcloud("describe", instance_id, timeout=60)
            if json.loads(raw or "{}").get("status") == "RUNNING":
                return True
            time.sleep(10)
        return False
