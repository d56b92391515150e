"""Grafana dashboard generation.

Analog of the reference's dashboard factory
(``python/ray/dashboard/modules/metrics/grafana_dashboard_factory.py``):
emit a complete importable Grafana dashboard JSON whose panels query the
metrics this cluster exports on its Prometheus endpoint — the cluster's
own counters plus whatever user metrics (``ray_tpu_torch.util.metrics``) have
been reported so far.
"""

from __future__ import annotations

from typing import Any, Dict, List

# Core panels: cluster counters every session exports (gcs counters are
# served as gauges on /metrics alongside user metrics).
_CORE_PANELS = [
    ("Tasks finished", "rate(gcs_tasks_finished[1m])", "tasks/s"),
    ("Tasks failed", "rate(gcs_tasks_failed[1m])", "tasks/s"),
    ("Alive actors", "gcs_alive_actors", "actors"),
    ("Alive nodes", "gcs_alive_nodes", "nodes"),
    ("Object store bytes", "gcs_object_store_bytes", "bytes"),
    ("Pending tasks", "gcs_pending_tasks", "tasks"),
]

# Plane-event flight-recorder panels (queue-depth telemetry, ISSUE 14):
# each series flows through the ordinary metrics path — GCS-internal
# gauges (lane depth, admission) are appended by metrics_get, per-process
# gauges (broadcast in-flight, collective pending, per-tenant serve
# queues) arrive via metrics_push. (title, expr, unit, legend).
_PLANE_PANELS = [
    ("GCS ingress lane depth", "gcs_lane_depth", "frames", "{{role}}"),
    ("Admission-blocked lanes", "gcs_admission_blocked_lanes", "lanes",
     "{{instance}}"),
    ("Broadcast in-flight chunks", "bcast_inflight_chunks", "chunks",
     "{{src}}"),
    ("Collective pending ops", "collective_pending_ops", "ops",
     "{{gang}}"),
    ("Serve queue depth by tenant", "serve_tenant_queue_depth",
     "requests", "{{tenant}}"),
    ("Plane-event drops", "rate(plane_event_drops[1m])", "rows/s",
     "{{plane}}"),
]


def _panel(panel_id: int, title: str, expr: str, unit: str,
           x: int, y: int,
           legend: str = "{{instance}}") -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "gridPos": {"h": 8, "w": 12, "x": x, "y": y},
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
        "fieldConfig": {"defaults": {"unit": unit}},
        "targets": [{"expr": expr, "refId": "A",
                     "legendFormat": legend}],
    }


def generate_dashboard(extra_metrics: List[str] = None) -> Dict[str, Any]:
    """A complete importable dashboard dict. ``extra_metrics`` extends the
    core panels; when omitted, the live metric registry (user Gauges/
    Counters/Histograms reported to the GCS) is consulted."""
    names: List[str] = list(extra_metrics or [])
    if extra_metrics is None:
        try:
            from ray_tpu_torch._private.worker import global_worker

            reply = global_worker().request_gcs({"t": "metrics_get"},
                                                timeout=5)
            names = sorted({m.get("name") for m in reply.get("metrics", [])
                            if m.get("name")})
        except Exception:
            names = []
    panels = []
    pid = 1
    y = 0
    for i, (title, expr, unit) in enumerate(_CORE_PANELS):
        panels.append(_panel(pid, title, expr, unit,
                             x=(i % 2) * 12, y=y))
        pid += 1
        if i % 2 == 1:
            y += 8
    for i, (title, expr, unit, legend) in enumerate(_PLANE_PANELS):
        panels.append(_panel(pid, title, expr, unit,
                             x=(i % 2) * 12, y=y, legend=legend))
        pid += 1
        if i % 2 == 1:
            y += 8
    # Plane-panel series also show up in the live registry once their
    # planes run — don't duplicate them as auto-panels. Compare against
    # the UNDERLYING metric name (an expr may wrap it in rate(...)).
    plane_metrics = {expr[5:].split("[", 1)[0]
                     if expr.startswith("rate(") else expr
                     for _, expr, _, _ in _PLANE_PANELS}
    names = [n for n in names if n not in plane_metrics]
    for i, name in enumerate(names):
        panels.append(_panel(pid, name, name, "short",
                             x=(i % 2) * 12, y=y))
        pid += 1
        if i % 2 == 1:
            y += 8
    return {
        "title": "ray_tpu_torch cluster",
        "uid": "ray-tpu-default",
        "schemaVersion": 39,
        "timezone": "browser",
        "refresh": "10s",
        "time": {"from": "now-30m", "to": "now"},
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus"}]},
        "panels": panels,
    }
