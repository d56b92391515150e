"""Driver-side face of the tenant SLO plane (_private/slo.py).

A tenant (or an operator acting for one) registers what "healthy" means
for its workload — a stat over a tenant-tagged plane-event stream and a
ceiling — and the GCS-side detector takes it from there: sliding-window
evaluation, breach attribution, and the bounded enforcement ladder
(re-weight -> rebalance -> migrate) with hysteresis. See the README
"Consolidated operation" section for the spec format and ladder bounds.

    from ray_tpu_torch.util import slo
    slo.register("serve-a", event="serve.req.done", field="dur",
                 stat="p99", threshold_s=0.05)
    slo.status()["tenants"]["serve-a"]["breached"]
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def _gcs(timeout: float, msg: dict) -> dict:
    from ray_tpu_torch._private.worker import global_worker

    reply = global_worker().request_gcs(msg, timeout=timeout)
    if not reply.get("ok"):
        raise RuntimeError(f"slo op {msg.get('t')} failed: "
                           f"{reply.get('err', reply)}")
    return reply


def register(tenant: str, timeout: float = 10.0,
             **spec: Any) -> Dict[str, Any]:
    """Register (or replace) ``tenant``'s SLO spec. Keyword fields:
    ``event`` (plane-event name), ``field`` ("dur" or a fields key),
    ``stat`` (p99/p95/p50/mean/max), ``threshold_s``, ``breach_windows``,
    ``recover_windows``, ``min_samples`` — unset fields keep detector
    defaults. Returns the normalized spec the detector will evaluate."""
    return _gcs(timeout, {"t": "slo_register", "tenant": tenant,
                          "spec": spec})["spec"]


def unregister(tenant: str, timeout: float = 10.0) -> bool:
    return bool(_gcs(timeout, {"t": "slo_register", "tenant": tenant,
                               "spec": None}).get("removed"))


def status(timeout: float = 10.0) -> Dict[str, Any]:
    """Detector + ladder state: per-tenant streaks and last measured
    value, per-offender rung/weight, the bounded action journal, and
    the sweep counters."""
    reply = _gcs(timeout, {"t": "slo_status"})
    reply.pop("ok", None)
    return reply


def force(rung: str, offender: str, victim: str = "",
          timeout: float = 10.0) -> Dict[str, Any]:
    """Drill hook: execute one enforcement rung now (journaled with
    forced=1). Drives the deterministic enforcement action in the
    tier-1 soak smoke and operator game-days."""
    return _gcs(timeout, {"t": "slo_force", "rung": rung,
                          "offender": offender, "victim": victim})["action"]


def restore(offender: str, timeout: float = 10.0) -> bool:
    """Undo a re-weight (forced or detector-applied) immediately."""
    return bool(_gcs(timeout, {"t": "slo_force", "offender": offender,
                               "restore": 1}).get("restored"))
