"""Application metrics API: Counter / Gauge / Histogram.

Analog of the reference's ``ray.util.metrics`` (``python/ray/util/metrics.py``)
on top of the C++ OpenCensus stats layer (``src/ray/stats/metric.h:103-201``).
Here each process keeps a local registry; a daemon flusher pushes cumulative
snapshots to the GCS (the per-node metrics-agent role,
``python/ray/_private/metrics_agent.py``), which aggregates across processes.
Export formats: the state API (``ray_tpu_torch.util.state.list_metrics``) and
Prometheus text (``ray_tpu_torch.util.state.prometheus_metrics``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_flusher_thread: "threading.Thread | None" = None
_flusher_stop = threading.Event()

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0]


def _ensure_flusher():
    """Start (or restart after a shutdown) the daemon flusher. The
    stop event makes the thread joinable at worker shutdown — the
    invariants core's no-leaked-thread posture for metric-using tests;
    a later ``init()`` in the same process restarts it here."""
    global _flusher_thread
    with _registry_lock:
        if _flusher_thread is not None and _flusher_thread.is_alive():
            return
        _flusher_stop.clear()
        _flusher_thread = threading.Thread(
            target=_flush_loop, name="ray_tpu_torch-metrics", daemon=True)
        _flusher_thread.start()


def _flush_loop():
    from ray_tpu_torch._private.config import config as _cfg

    from . import events as _events

    while not _flusher_stop.wait(
            max(0.05, _cfg().metrics_flush_interval_s)):
        try:
            flush_now()
            # Driver-side plane events ride the same tick (workers have
            # their own coalesced task_events loop; this covers driver
            # and standalone processes).
            _events.flush_now()
        except Exception:
            pass


def shutdown_flusher(timeout: float = 2.0):
    """Stop and join the flusher (worker shutdown hook). Idempotent;
    safe when the flusher never started."""
    global _flusher_thread
    with _registry_lock:
        t, _flusher_thread = _flusher_thread, None
    if t is None or not t.is_alive():
        return
    _flusher_stop.set()
    t.join(timeout=timeout)


def flush_now():
    """Push a snapshot of every registered metric to the GCS (no-op when not
    connected)."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod._global_worker
    if w is None or w.closed or w.gcs is None or w.loop is None:
        return
    with _registry_lock:
        snap = [m._snapshot_all() for m in _registry]
    flat = [s for group in snap for s in group]
    if not flat:
        return
    w.loop.call_soon_threadsafe(w._send_gcs, {"t": "metrics_push", "m": flat})


class Metric:
    """Base: a named metric with fixed tag keys and per-tag-set series."""

    _type = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]):
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self._tag_keys)
        if extra:
            raise ValueError(f"unknown tag keys {sorted(extra)}; declared "
                             f"tag_keys={self._tag_keys}")
        return tuple(sorted(merged.items()))

    def _snapshot_all(self) -> List[dict]:
        with self._lock:
            return [{"name": self._name, "type": self._type,
                     "tags": dict(k), "value": v}
                    for k, v in self._series.items()]

    @property
    def info(self) -> dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys,
                "default_tags": dict(self._default_tags)}


class Counter(Metric):
    """Monotonically increasing count (reference: metric.h Count/Sum)."""

    _type = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc() requires a positive value")
        k = self._key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    """Last-value-wins measurement (reference: metric.h:103 Gauge)."""

    _type = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._series[self._key(tags)] = float(value)


class Histogram(Metric):
    """Bucketed distribution (reference: metric.h Histogram).

    Exports one series per bucket boundary (cumulative counts, Prometheus
    ``le`` convention) plus ``_sum`` and ``_count``.
    """

    _type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        # key -> [bucket counts..., +inf count, sum, count]
        self._hist: Dict[tuple, list] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            h = self._hist.get(k)
            if h is None:
                h = [0] * (len(self._boundaries) + 1) + [0.0, 0]
                self._hist[k] = h
            for i, b in enumerate(self._boundaries):
                if value <= b:
                    h[i] += 1
                    break
            else:
                h[len(self._boundaries)] += 1
            h[-2] += value
            h[-1] += 1

    def _snapshot_all(self) -> List[dict]:
        out = []
        with self._lock:
            for k, h in self._hist.items():
                cum = 0
                buckets = {}
                for i, b in enumerate(self._boundaries):
                    cum += h[i]
                    buckets[str(b)] = cum
                buckets["+Inf"] = cum + h[len(self._boundaries)]
                out.append({"name": self._name, "type": "histogram",
                            "tags": dict(k), "value": h[-2],
                            "buckets": buckets, "count": h[-1]})
        return out


def prometheus_text(metrics: List[dict]) -> str:
    """Render aggregated metric dicts in the Prometheus text format."""
    lines = []
    seen_types = set()
    for m in metrics:
        name = m["name"].replace(".", "_").replace("-", "_")
        if name not in seen_types:
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram"}.get(m.get("type"), "gauge")
            lines.append(f"# TYPE {name} {ptype}")
            seen_types.add(name)
        tags = m.get("tags") or {}
        label = ",".join(f'{k}="{v}"' for k, v in sorted(tags.items()))
        if m.get("type") == "histogram" and m.get("buckets"):
            for b, c in m["buckets"].items():
                ltags = dict(tags, le=b)
                bl = ",".join(f'{k}="{v}"' for k, v in sorted(ltags.items()))
                lines.append(f"{name}_bucket{{{bl}}} {c}")
            lines.append(f"{name}_sum{{{label}}} {m['value']}")
            lines.append(f"{name}_count{{{label}}} {m.get('count', 0)}")
        else:
            body = f"{{{label}}}" if label else ""
            lines.append(f"{name}{body} {m['value']}")
    return "\n".join(lines) + "\n"
