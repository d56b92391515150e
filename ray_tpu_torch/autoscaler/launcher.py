"""Cluster launcher: ``up``/``down`` from a cluster YAML.

Reference: ``python/ray/autoscaler/_private/commands.py``
(``create_or_update_cluster``, ``teardown_cluster``) — parse the cluster
config, provision the head through the node provider, rsync file mounts,
run setup commands, start the head, and let the autoscaler grow workers.
Same flow here against the gcloud-CLI GPU provider (``gcp.py``): one VM is
the head host; its start command carries the GCS port so the worker VMs
the autoscaler adds join over the network.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, List, Optional

from .gcp import GCPGPUNodeProvider

DEFAULT_CONFIG: Dict[str, Any] = {
    "cluster_name": "ray-tpu-torch",
    "max_workers": 0,
    "provider": {"type": "gcp_gpu"},
    "auth": {"ssh_user": "ray"},
    "file_mounts": {},
    "head_setup_commands": [],
    "setup_commands": [],
    "head_start_ray_commands": [
        "python -m ray_tpu_torch start --head --port 6379 --host 0.0.0.0",
    ],
    "worker_start_ray_commands": [
        "python -m ray_tpu_torch start --address $RAY_TPU_TORCH_HEAD_IP:6379",
    ],
}


def load_config(path_or_dict) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        user = path_or_dict
    else:
        import yaml

        with open(path_or_dict) as f:
            user = yaml.safe_load(f) or {}
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    for k, v in user.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    return cfg


def _make_provider(cfg: Dict[str, Any],
                   exec_fn: Optional[Callable] = None) -> GCPGPUNodeProvider:
    p = cfg["provider"]
    ptype = p.get("type", "gcp_gpu")
    if ptype != "gcp_gpu":
        raise ValueError(
            f"launcher provider {ptype!r} not supported (use 'gcp_gpu'; "
            "in-process clusters use ray_tpu_torch.autoscaler.testing)")
    return GCPGPUNodeProvider(
        project=p["project"], zone=p["zone"],
        machine_type=p.get("machine_type", "a3-highgpu-8g"),
        image_family=p.get("image_family", "pytorch-latest-gpu"),
        image_project=p.get("image_project",
                            "deeplearning-platform-release"),
        name_prefix=cfg["cluster_name"],
        preemptible=bool(p.get("preemptible", False)),
        exec_fn=exec_fn)


def up(config, *, exec_fn: Optional[Callable] = None,
       no_start: bool = False) -> Dict[str, Any]:
    """Provision + bootstrap the head node. Returns head details."""
    cfg = load_config(config)
    provider = _make_provider(cfg, exec_fn)
    auth = cfg.get("auth", {})
    ssh_kwargs = {"ssh_user": auth.get("ssh_user", "ray")}
    if auth.get("ssh_private_key"):
        ssh_kwargs["ssh_key"] = os.path.expanduser(auth["ssh_private_key"])
    if exec_fn is not None:
        ssh_kwargs["exec_fn"] = exec_fn  # fan test recorder into ssh too

    head = provider.create_node("head", {})
    provider.wait_ready(head.instance_id)
    head_ip = provider.address(head.instance_id)
    runner = provider.command_runner(head.instance_id, **ssh_kwargs)

    # file_mounts follow the reference convention: {remote_path: local_path}
    for remote, local in sorted(cfg.get("file_mounts", {}).items()):
        runner.run_rsync_up(os.path.expanduser(local), remote)
    for cmd in cfg.get("head_setup_commands", []) + \
            cfg.get("setup_commands", []):
        runner.run(cmd)
    if not no_start:
        # One VM is one host: it runs the head; the worker VMs the
        # autoscaler adds run worker_start_ray_commands.
        runner.run(f"export RAY_TPU_TORCH_HEAD_IP={head_ip}; "
                   + " && ".join(cfg["head_start_ray_commands"]))
    return {"head_instance": head.instance_id, "head_ip": head_ip,
            "num_hosts": 1, "num_gpus": head.resources["GPU"],
            "cluster_name": cfg["cluster_name"]}


def down(config, *, exec_fn: Optional[Callable] = None) -> List[str]:
    """Terminate every instance belonging to the cluster."""
    cfg = load_config(config)
    provider = _make_provider(cfg, exec_fn)
    killed = []
    for inst in provider.non_terminated_nodes():
        provider.terminate_node(inst.instance_id)
        killed.append(inst.instance_id)
    return killed
