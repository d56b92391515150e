"""Autoscaler: reconciler-style cluster elasticity (reference: autoscaler v2,
``python/ray/autoscaler/v2/autoscaler.py:42``)."""

from .autoscaler import Autoscaler, AutoscalerConfig, NodeTypeConfig
from .node_provider import (
    GPUHostNodeProvider,
    LocalNodeProvider,
    NodeProvider,
)
from .scheduler import ResourceDemandScheduler
from .testing import AutoscalingCluster


def request_resources(*, num_cpus: int = 0, bundles=None):
    """App-level capacity request (reference: ``ray.autoscaler.sdk.
    request_resources``): the autoscaler treats these bundles as standing
    demand until replaced by a later call (empty call clears)."""
    import json

    from ray_tpu_torch._private.worker import global_worker

    out = []
    if num_cpus:
        # Reference semantics: num_cpus means TOTAL CPUs (N one-CPU
        # bundles), not one N-CPU slot — a single big bundle would be
        # silently infeasible on smaller node types.
        out.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    for b in (bundles or []):
        out.append({k: float(v) for k, v in b.items()})
    global_worker().kv_put("requested", json.dumps(out).encode(),
                           ns="_autoscaler")
    return len(out)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "NodeTypeConfig", "NodeProvider",
    "request_resources",
    "LocalNodeProvider", "GPUHostNodeProvider", "ResourceDemandScheduler",
    "AutoscalingCluster",
]
