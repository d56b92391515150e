"""AutoscalingCluster: in-process elastic-cluster harness for tests.

Analog of the reference's ``AutoscalingCluster`` (``python/ray/
cluster_utils.py:26``) running against the fake multi-node provider
(``autoscaler/_private/fake_multi_node/node_provider.py``), so autoscaler
behavior is testable on one machine (SURVEY §4 requirement (b))."""

from __future__ import annotations

from typing import Dict, Optional

from .autoscaler import Autoscaler, AutoscalerConfig, NodeTypeConfig
from .node_provider import GPUHostNodeProvider, LocalNodeProvider


class AutoscalingCluster:
    def __init__(self, head_resources: Optional[Dict[str, float]] = None,
                 worker_node_types: Optional[Dict[str, dict]] = None,
                 idle_timeout_s: float = 5.0,
                 update_interval_s: float = 0.25,
                 gpu: bool = False, **gpu_kwargs):
        self.head_resources = head_resources or {"CPU": 1}
        self.worker_node_types = worker_node_types or {}
        self.idle_timeout_s = idle_timeout_s
        self.update_interval_s = update_interval_s
        self.gpu = gpu
        self.gpu_kwargs = gpu_kwargs
        self.head = None
        self.autoscaler: Optional[Autoscaler] = None
        self.provider = None
        self.address: Optional[str] = None

    def start(self):
        from ray_tpu_torch._private.node import HeadNode

        self.head = HeadNode(
            num_cpus=int(self.head_resources.get("CPU", 1)),
            resources={k: float(v) for k, v in self.head_resources.items()
                       if k != "CPU"} or None,
            probe_gpu=False, num_initial_workers=1)
        self.address = self.head.address
        provider_cls = GPUHostNodeProvider if self.gpu else LocalNodeProvider
        self.provider = provider_cls(self.address, self.head.session_dir,
                                     **self.gpu_kwargs)
        config = AutoscalerConfig(
            node_types={
                name: NodeTypeConfig(
                    resources={k: float(v)
                               for k, v in spec["resources"].items()},
                    min_workers=spec.get("min_workers", 0),
                    max_workers=spec.get("max_workers", 10))
                for name, spec in self.worker_node_types.items()},
            idle_timeout_s=self.idle_timeout_s,
            update_interval_s=self.update_interval_s)
        self.autoscaler = Autoscaler(config, self.provider, self.address)
        self.autoscaler.start()
        return self.address

    def connect(self):
        import ray_tpu_torch

        ray_tpu_torch.init(address=self.address, ignore_reinit_error=True)

    def shutdown(self):
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.provider is not None:
            self.provider.terminate_all()
        if self.head is not None:
            self.head.stop()
            self.head = None
