"""State API: programmatic cluster introspection.

Analog of the reference's ``ray.util.state`` (``python/ray/util/state/api.py``
+ server side ``dashboard/state_aggregator.py``): list live nodes, workers,
actors, tasks, objects, and placement groups, summarize task states, export a
Chrome-trace timeline, and fetch aggregated metrics.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as _worker_mod


def _list(kind: str, limit: int = 1000) -> List[dict]:
    w = _worker_mod.global_worker()
    reply = w.request_gcs({"t": "state_list", "kind": kind, "limit": limit})
    if not reply.get("ok"):
        raise RuntimeError(reply.get("err", "state listing failed"))
    return reply["items"]


def list_nodes(limit: int = 1000) -> List[dict]:
    return _list("nodes", limit)


def list_workers(limit: int = 1000) -> List[dict]:
    return _list("workers", limit)


def list_actors(limit: int = 1000) -> List[dict]:
    return _list("actors", limit)


def list_tasks(limit: int = 1000) -> List[dict]:
    return _list("tasks", limit)


def list_objects(limit: int = 1000) -> List[dict]:
    return _list("objects", limit)


def list_placement_groups(limit: int = 1000) -> List[dict]:
    return _list("placement_groups", limit)


def list_task_events(limit: int = 50000) -> List[dict]:
    return _list("task_events", limit)


def list_plane_events(limit: int = 100000) -> List[dict]:
    """Flight-recorder rows from the GCS plane-event table
    (``ray_tpu_torch.util.events``): tenant-/plane-tagged events from every
    plane boundary, on one clock. Flush cadence: workers push on the
    0.5s task_events tick, drivers on the metrics tick — recent emits
    may need a moment to land."""
    return _list("plane_events", limit)


def list_cluster_events(limit: int = 1000) -> List[dict]:
    """Structured export events (node/actor lifecycle transitions) — the
    reference's RayEvent export stream (``util/event.h:246``); also
    written as ``events.jsonl`` in the session dir for external
    collectors. User pubsub channels are NOT exported (publish rates are
    unbounded); lifecycle channels are."""
    return _list("cluster_events", limit)


def list_metrics() -> List[dict]:
    w = _worker_mod.global_worker()
    reply = w.request_gcs({"t": "metrics_get"})
    if not reply.get("ok"):
        raise RuntimeError("metrics fetch failed")
    return reply["metrics"]


def prometheus_metrics() -> str:
    """Aggregated cluster metrics in Prometheus text format."""
    from ray_tpu_torch.util.metrics import flush_now, prometheus_text

    flush_now()
    return prometheus_text(list_metrics())


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """Per-function-name counts by state (reference: ``ray summary tasks``)."""
    out: Dict[str, Dict[str, int]] = {}
    for t in list_tasks(limit=100000):
        name = t["name"] or "<anonymous>"
        per = out.setdefault(name, {})
        state = "failed" if t.get("error") else t["state"]
        per[state] = per.get(state, 0) + 1
    return out


def timeline(filename: Optional[str] = None,
             planes: bool = False) -> List[dict]:
    """Export task execution events as a Chrome trace (``chrome://tracing`` /
    Perfetto). Reference: ``ray timeline`` CLI → Chrome-trace from
    GcsTaskManager events (``python/ray/scripts/scripts.py:1934``).

    ``planes=True`` merges the plane-event flight recorder into the same
    trace — one lane per (node, plane), all planes on ONE clock, so
    Perfetto shows e.g. broadcast chunk traffic interleaved with the
    actor tasks it competes with. Rows carrying a trace id (emitted
    under ``RAY_TPU_TORCH_TRACE``) surface it in ``args`` for span
    cross-linking.
    """
    events = list_task_events()
    trace = []
    pids = {}
    for ev in events:
        key = (ev.get("node_id", "")[:8], ev.get("pid", 0))
        pids.setdefault(key, len(pids))
        trace.append({
            "name": ev.get("name", ""),
            "cat": ev.get("kind", "task"),
            "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": max(0.0, (ev["end"] - ev["start"]) * 1e6),
            "pid": f"node:{key[0]} pid:{key[1]}",
            "tid": ev.get("worker_id", "")[:8],
            "args": {"task_id": ev.get("task_id", ""),
                     "ok": ev.get("ok", True)},
        })
    if planes:
        for ev in list_plane_events():
            args = dict(ev.get("fields") or {})
            if ev.get("tenant"):
                args["tenant"] = ev["tenant"]
            if ev.get("trace_id"):
                args["trace_id"] = ev["trace_id"]
            dur = ev.get("dur") or 0.0
            row = {
                "name": ev.get("name", ""),
                "cat": ev.get("plane", "plane"),
                # Durationed rows span their wall time (the emit stamps
                # the END of the operation); zero-dur rows are instants.
                "ph": "X" if dur else "i",
                "ts": (ev["ts"] - dur) * 1e6,
                "pid": f"node:{ev.get('node_id', '')[:8]} "
                       f"plane:{ev.get('plane', '')}",
                "tid": f"pid:{ev.get('pid', 0)}",
                "args": args,
            }
            if dur:
                row["dur"] = dur * 1e6
            else:
                row["s"] = "t"  # instant scope: thread
            trace.append(row)
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
