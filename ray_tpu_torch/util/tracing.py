"""Distributed tracing: W3C-traceparent spans over task/actor calls.

Reference: ``python/ray/util/tracing/tracing_helper.py:36-57`` — when
tracing is enabled, task/actor submission and execution are wrapped in
spans and the context propagates inside the task options so remote call
trees stitch into one trace. Same mechanics here: a contextvar carries
``(trace_id, span_id)``; submission injects a ``tp`` (traceparent) field
into the task message; the executing worker adopts it so nested
``.remote()`` calls chain. Spans are flushed to the GCS KV (``ns="trace"``)
and read back with ``get_trace``; if the ``opentelemetry`` package is
installed, finished spans are also forwarded to its tracer.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

_ENV_FLAG = "RAY_TPU_TORCH_TRACE"

# (trace_id_hex32, span_id_hex16) of the active span in this task/thread.
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)

_buffer: List[dict] = []
_buffer_lock = threading.Lock()
_MAX_BUFFER = 10_000


def enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "") == "1"


def active() -> bool:
    """Should spans be recorded here? True when tracing is enabled in
    this process OR an adopted remote context is live (a worker executing
    a traced call) — adoption is per-call, never a process-wide flag flip,
    so one traced job cannot virally enable tracing for later jobs on a
    shared cluster."""
    return enabled() or _ctx.get() is not None


def enable_tracing():
    """Turn on tracing for this process and every worker spawned after
    (propagates via the environment, like the reference's
    ``RAY_TRACING_ENABLED`` startup hook)."""
    os.environ[_ENV_FLAG] = "1"


def disable_tracing():
    os.environ.pop(_ENV_FLAG, None)


def current_traceparent() -> Optional[str]:
    """W3C format: ``00-<trace_id 32hex>-<span_id 16hex>-01``."""
    ctx = _ctx.get()
    if ctx is None:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-01"


def parse_traceparent(tp: str) -> Optional[tuple]:
    try:
        _, trace_id, span_id, _ = tp.split("-")
        if len(trace_id) == 32 and len(span_id) == 16:
            return trace_id, span_id
    except ValueError:
        pass
    return None


_atexit_registered = False
_FLUSH_THRESHOLD = 256


def _record(span: dict):
    global _atexit_registered
    with _buffer_lock:
        if len(_buffer) < _MAX_BUFFER:
            _buffer.append(span)
        n = len(_buffer)
        if not _atexit_registered:
            # Driver processes have no periodic flush loop (workers do,
            # worker_main.flush_events_loop): flush on exit + threshold.
            import atexit

            atexit.register(_flush_silent)
            _atexit_registered = True
    if n >= _FLUSH_THRESHOLD:
        _flush_silent()
    _maybe_export_otel(span)


def _flush_silent():
    try:
        flush_to_kv()
    except Exception:
        pass  # no cluster / GCS already gone


_otel = None  # None = not probed, False = unavailable, module otherwise


def _maybe_export_otel(span: dict):
    """Forward to opentelemetry when the package is installed (the
    reference's opt-in exporter hook, ``tracing_helper.py``). Soft
    dependency probed once; exporter failures never break the workload.

    The exported span carries the correct parent link (our caller's ids
    as a remote parent context) and real start/end times. OTel generates
    its own span id, so cross-referencing back to KV spans goes through
    the ``rtpt.span_id`` attribute."""
    global _otel
    if _otel is False:
        return
    try:
        if _otel is None:
            from opentelemetry import trace as otel_trace  # type: ignore

            _otel = otel_trace
        otel_trace = _otel
        parent_ctx = None
        if span.get("parent_id"):
            from opentelemetry.trace import (NonRecordingSpan, SpanContext,
                                             TraceFlags, set_span_in_context)

            parent_ctx = set_span_in_context(NonRecordingSpan(SpanContext(
                trace_id=int(span["trace_id"], 16),
                span_id=int(span["parent_id"], 16),
                is_remote=True, trace_flags=TraceFlags(1))))
        tracer = otel_trace.get_tracer("ray_tpu_torch")
        s = tracer.start_span(span["name"], context=parent_ctx,
                              start_time=int(span["start"] * 1e9))
        s.set_attribute("rtpt.trace_id", span["trace_id"])
        s.set_attribute("rtpt.span_id", span["span_id"])
        for k, v in span.get("attrs", {}).items():
            s.set_attribute(k, v)
        s.end(end_time=int(span["end"] * 1e9))
    except ImportError:
        _otel = False
    except Exception:
        pass


@contextlib.contextmanager
def span(name: str, kind: str = "internal",
         attrs: Optional[Dict[str, Any]] = None):
    """Open a span under the current context (user-facing API)."""
    if not active():
        yield None
        return
    parent = _ctx.get()
    trace_id = parent[0] if parent else secrets.token_hex(16)
    span_id = secrets.token_hex(8)
    token = _ctx.set((trace_id, span_id))
    t0 = time.time()
    status = "ok"
    try:
        yield (trace_id, span_id)
    except BaseException:
        status = "error"
        raise
    finally:
        _ctx.reset(token)
        _record({
            "trace_id": trace_id, "span_id": span_id,
            "parent_id": parent[1] if parent else None,
            "name": name, "kind": kind, "start": t0, "end": time.time(),
            "status": status, "pid": os.getpid(), "attrs": attrs or {},
        })


def inject_task_opts(opts: dict, name: str):
    """Submission-side hook: record a submit span and stamp the message
    with the traceparent (reference: ``_inject_tracing_into_function``)."""
    if not active():
        return
    parent = _ctx.get()
    trace_id = parent[0] if parent else secrets.token_hex(16)
    span_id = secrets.token_hex(8)
    _record({
        "trace_id": trace_id, "span_id": span_id,
        "parent_id": parent[1] if parent else None,
        "name": f"submit:{name}", "kind": "producer",
        "start": time.time(), "end": time.time(), "status": "ok",
        "pid": os.getpid(), "attrs": {},
    })
    opts["tp"] = f"00-{trace_id}-{span_id}-01"


@contextlib.contextmanager
def adopt_and_span(tp: Optional[str], name: str, kind: str = "consumer"):
    """Execution-side hook: adopt the caller's context and open the
    execute span, so nested submits from user code chain correctly.

    The arriving ``tp`` itself proves the submitting driver enabled
    tracing — don't gate on this process's own env var (workers of an
    already-running cluster were spawned before ``enable_tracing``).
    Adoption is scoped to this call via the contextvar (``active()``), so
    it does not flip tracing on for unrelated later work."""
    if not tp:
        yield
        return
    parsed = parse_traceparent(tp)
    if parsed is None:
        yield
        return
    token = _ctx.set(parsed)
    try:
        with span(name, kind=kind):
            yield
    finally:
        _ctx.reset(token)


def flush_to_kv(worker=None):
    """Persist buffered spans to the GCS KV (``ns="trace"``), keyed by
    trace id so ``get_trace`` is one prefix read per trace."""
    with _buffer_lock:
        batch, _buffer[:] = list(_buffer), []
    if not batch:
        return 0
    if worker is None:
        from ray_tpu_torch._private.worker import global_worker

        worker = global_worker()
    by_trace: Dict[str, List[dict]] = {}
    for s in batch:
        by_trace.setdefault(s["trace_id"], []).append(s)
    # Worker processes flush from their event loop — a blocking kv_put
    # there would deadlock the loop, so fire-and-forget the frames.
    import asyncio

    try:
        asyncio.get_running_loop()
        on_loop = True
    except RuntimeError:
        on_loop = False
    for trace_id, spans in by_trace.items():
        key = f"{trace_id}:{os.getpid()}:{secrets.token_hex(4)}"
        value = json.dumps(spans).encode()
        if on_loop:
            worker.gcs.request_nowait(
                {"t": "kv_put", "ns": "trace", "k": key, "v": value})
        else:
            worker.kv_put(key, value, ns="trace")
    return len(batch)


def clear_traces() -> int:
    """Drop every span blob in the GCS trace namespace now (driver API;
    retention — ``trace_retention_s`` / ``trace_max_traces`` — bounds
    them anyway, this is the explicit reset between experiments).
    Returns how many KV blobs were cleared."""
    from ray_tpu_torch._private.worker import global_worker

    with _buffer_lock:
        _buffer.clear()  # don't resurrect local spans on the next flush
    reply = global_worker().request_gcs({"t": "clear_traces"}, timeout=10)
    return int(reply.get("cleared", 0))


def get_trace(trace_id: str) -> List[dict]:
    """All spans of a trace, sorted by start time (driver-side query)."""
    from ray_tpu_torch._private.worker import global_worker

    flush_to_kv()  # local (driver-side) spans first
    w = global_worker()
    spans: List[dict] = []
    for key in w.kv_keys(prefix=trace_id, ns="trace"):
        blob = w.kv_get(key, ns="trace")
        if blob:
            spans.extend(json.loads(blob))
    return sorted(spans, key=lambda s: s["start"])


def pending_spans() -> int:
    with _buffer_lock:
        return len(_buffer)
