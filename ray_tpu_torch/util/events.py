"""Plane-event flight recorder: one clock across every plane.

The task plane has had spans / ``task_events`` / ``timeline()`` since the
seed; every OTHER plane shipped in PRs 3-10 (broadcast, wait groups,
collectives, admission, serving, podracer) was observable only through
its own bench's ad-hoc counters — "concurrent broadcast traffic vs.
rollout egress" interference was undiagnosable because no two planes
shared a timeline. This module is the shared emitter: a cheap
per-process ring buffer stamped at the same plane boundaries the
failpoint registry already marks, flushed over the existing coalesced
``task_events`` push path into a bounded GCS plane-event table, and
surfaced through ``ray_tpu_torch.util.state.timeline(planes=True)`` (one
Chrome-trace lane per (node, plane) — Perfetto shows all planes on one
clock), the metrics path (queue-depth gauges), and ``python -m ray_tpu_torch
timeline --planes``.

Contract (the reason this can sit on hot paths):

* **Never backpressure the emit site.** ``emit`` is a bounded append
  under a tiny lock; a full ring increments the per-plane ``dropped``
  counter and returns — it never blocks, never allocates beyond the
  row, never raises into the caller.
* **Aggregate the per-frame paths.** Protocol send/dispatch run at
  100k+ frames/s; per-frame rows would be all drops. ``count`` folds
  them into per-(name, key) counters drained as ONE aggregate row per
  flush interval — the rate signal without the row storm.
* **Cross-link with spans.** When tracing is live (``RAY_TPU_TORCH_TRACE`` or
  an adopted remote context), every row carries the active trace id, so
  a Perfetto lane click joins the task-plane span tree.

Event names are dotted three-segment literals (``plane.noun.verb``);
``ray_tpu_torch check --events`` cross-checks every name referenced by
benchmarks/tests against the literals registered here-abouts, exactly
like ``--failpoints`` does for chaos sites.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

# The planes a row may be tagged with (the timeline groups lanes by
# these; the --events checker treats the set as the name grammar's
# first-segment alphabet). "slo" rows are the interference detector's
# breach/recovery/sweep journal; "enforce" rows are the reactive
# control plane's action journal — cause (slo.*) and action (enforce.*)
# share one clock with every other plane, which is what lets
# ``timeline --planes`` prove breach -> attribution -> action ->
# recovery on a single trace.
PLANES = ("task", "proto", "gcs", "lease", "wait", "bcast", "coll",
          "serve", "rl", "pipe", "slo", "enforce")

_lock = threading.Lock()
_ring: List[list] = []
_dropped: Dict[str, int] = {}
# (name, key) -> [n, nbytes] aggregate counters (hot per-frame paths).
_counts: Dict[Tuple[str, str], list] = {}

# Import-time snapshot of the enable flag + ring cap (hot-path reads);
# re-snapshotted on config change so driver-side _system_config lands.
_enabled = True
_cap = 65536


def _snapshot_config():
    global _enabled, _cap
    try:
        from ray_tpu_torch._private.config import config as _cfg

        c = _cfg()
        _enabled = bool(c.plane_events)
        _cap = max(16, int(c.plane_event_ring))
    except Exception:  # pragma: no cover - bootstrap import cycles
        pass


def enabled() -> bool:
    return _enabled


def process_tenant() -> str:
    """The tenant (namespace) this process acts for — the connected
    driver/worker's namespace, or "" when no worker is live. Emit sites
    on tenant-less planes (broadcast chunk accounting, podracer
    rollout egress) tag their rows with this so the GCS-side
    interference detector can attribute a plane's traffic to a tenant
    without the emit site threading a namespace through every call."""
    import sys

    worker_mod = sys.modules.get("ray_tpu_torch._private.worker")
    if worker_mod is None:
        return ""
    w = worker_mod._global_worker
    if w is None:
        return ""
    ns = getattr(w, "namespace", "")
    return "" if ns in ("", "default", None) else str(ns)


def _trace_id() -> str:
    """Active trace id when the tracing module is live in this process
    (module-presence gate: don't import tracing just to answer no)."""
    import sys

    tracing = sys.modules.get("ray_tpu_torch.util.tracing")
    if tracing is None:
        return ""
    ctx = tracing._ctx.get()
    return ctx[0] if ctx is not None else ""


def emit(name: str, plane: str, tenant: str = "",
         dur: Optional[float] = None, trace: Optional[str] = None,
         **fields) -> None:
    """Record one discrete plane event. Bounded, non-blocking: a full
    ring drops the row and counts it — emit sites never stall.

    ``dur`` (seconds) makes the row a span in the exported trace
    (``ph="X"``); without it the row is an instant. ``trace`` overrides
    the ambient trace id (cross-process stitch points)."""
    if not _enabled:
        return
    row = [time.time(), name, plane, tenant,
           trace if trace is not None else _trace_id(),
           float(dur) if dur is not None else 0.0,
           fields if fields else None]
    with _lock:
        if len(_ring) < _cap:
            _ring.append(row)
        else:
            _dropped[plane] = _dropped.get(plane, 0) + 1


def count(name: str, key: str = "", n: int = 1, nbytes: int = 0,
          plane: str = "proto") -> None:
    """Fold a hot-path occurrence into an aggregate counter. Drained as
    one ``{name, key, n, bytes}`` row per flush — the per-frame planes
    (protocol send/dispatch) ride this, never per-event rows."""
    if not _enabled:
        return
    k = (name, key)
    with _lock:
        c = _counts.get(k)
        if c is None:
            _counts[k] = [n, nbytes, plane]
        else:
            c[0] += n
            c[1] += nbytes


def pending() -> int:
    with _lock:
        return len(_ring) + len(_counts)


def dropped_counts() -> Dict[str, int]:
    """Per-plane rows dropped at THIS process's ring since the last
    drain (drain resets; the GCS table accumulates pushed totals)."""
    with _lock:
        return dict(_dropped)


def drain() -> Tuple[List[list], Dict[str, int]]:
    """Swap out the ring + fold counters into rows; returns
    ``(rows, dropped)``. Counter rows carry ``{"n": .., "bytes": ..}``
    fields and a zero duration. Resets the drop counters — the flusher
    forwards them to the GCS, which accumulates."""
    with _lock:
        rows, _ring[:] = list(_ring), []
        counts, drops = dict(_counts), dict(_dropped)
        _counts.clear()
        _dropped.clear()
    now = time.time()
    for (name, key), (n, nb, plane) in counts.items():
        rows.append([now, name, plane, "", "", 0.0,
                     {"key": key, "n": n, "bytes": nb, "agg": 1}])
    return rows, drops


def reset() -> None:
    """Test hook: drop everything buffered (ring, counters, drops)."""
    with _lock:
        _ring.clear()
        _counts.clear()
        _dropped.clear()


def flush_now(worker=None) -> int:
    """Push buffered rows to the GCS plane-event table (no-op when not
    connected). Driver processes flush through the metrics flusher's
    tick (``util/metrics.py``); workers flush through the executor's
    coalesced ``task_events`` loop (``worker_main.flush_events``) — both
    call here. Thread-safe: the send marshals onto the worker IO loop."""
    if not _enabled:
        return 0
    if pending() == 0:
        return 0
    if worker is None:
        from ray_tpu_torch._private import worker as worker_mod

        worker = worker_mod._global_worker
    if (worker is None or worker.closed or worker.gcs is None
            or worker.loop is None):
        return 0
    rows, drops = drain()
    if not rows and not drops:
        return 0
    msg = {"t": "plane_events", "ev": rows, "drops": drops,
           "nid": getattr(worker, "node_id", b"") or b"",
           "pid": os.getpid()}
    worker.loop.call_soon_threadsafe(worker._send_gcs, msg)
    return len(rows)


def gauge(name: str, description: str = "",
          tag_keys: Tuple[str, ...] = ()):
    """A recorder-gated queue-depth gauge: returns a ``set(value,
    **tags)`` callable that lazily creates the underlying
    ``metrics.Gauge`` on first use (importing an emitter module never
    starts the metrics flusher) and no-ops while the recorder is
    disabled — the ``--recorder off`` A/B arm silences the telemetry
    gauges with the event rows, in one place."""
    holder: list = []

    def set_value(value, **tags) -> None:
        if not _enabled:
            return
        if not holder:
            from ray_tpu_torch.util.metrics import Gauge

            holder.append(Gauge(name, description,
                                tag_keys=tuple(tag_keys)))
        holder[0].set(value, tags=tags or None)

    return set_value


def row_to_dict(row, nid_hex: str = "", pid: int = 0) -> dict:
    """Decode one stored row (the state API / timeline read side)."""
    ts, name, plane, tenant, trace, dur, fields = row
    return {"ts": ts, "name": name, "plane": plane, "tenant": tenant,
            "trace_id": trace, "dur": dur, "fields": fields or {},
            "node_id": nid_hex, "pid": pid}


def stripe_share(rows) -> Dict[str, dict]:
    """Per-object source-share accounting over broadcast chunk events.

    Input: decoded plane-event rows (``list_plane_events()`` dicts).
    Every completed chunk transfer emits ``bcast.chunk.done`` on the
    PULLER with ``{oid, src, nbytes}`` — summing those per (object,
    source) yields exactly how many delivered bytes each endpoint
    served. The object-plane-v2 target is stated on this output: on a
    cooperative relay no single source (the origin included) serves
    >=50% of an object's delivered bytes. Endgame ``bcast.chunk.steal``
    duplicates are counted so a report can bound the waste.
    """
    out: Dict[str, dict] = {}
    for r in rows:
        name = r.get("name")
        if name not in ("bcast.chunk.done", "bcast.chunk.steal"):
            continue
        f = r.get("fields") or {}
        oid = str(f.get("oid") or "")
        o = out.setdefault(oid, {"bytes": 0, "chunks": 0, "steals": 0,
                                 "sources": {}})
        if name == "bcast.chunk.steal":
            o["steals"] += 1
            continue
        src = str(f.get("src") or "?")
        nb = int(f.get("nbytes") or 0)
        o["bytes"] += nb
        o["chunks"] += 1
        s = o["sources"].setdefault(src, {"chunks": 0, "bytes": 0})
        s["chunks"] += 1
        s["bytes"] += nb
    for o in out.values():
        total = o["bytes"]
        max_src, max_bytes = "", 0
        for src, s in o["sources"].items():
            s["share"] = (s["bytes"] / total) if total else 0.0
            if s["bytes"] > max_bytes:
                max_src, max_bytes = src, s["bytes"]
        o["max_share"] = (max_bytes / total) if total else 0.0
        o["max_src"] = max_src
    return out


_snapshot_config()
try:
    from ray_tpu_torch._private.config import on_config_change

    on_config_change(_snapshot_config)
except Exception:  # pragma: no cover - bootstrap import cycles
    pass
