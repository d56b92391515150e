"""Plane-event recorder, reduced to a local buffer.

A copy of the emit side of ``ray_tpu/util/events.py``: ``emit`` appends a
row to a bounded per-process ring (a full ring counts the row as dropped
and returns; it never blocks or raises into the caller), ``drain`` swaps
the ring out, ``reset`` clears it. Rows keep the reference's layout
``[ts, name, plane, tenant, trace, dur, fields]`` and the serving path
emits the same names (``serve.req.queue``, ``serve.req.first_token``,
``serve.req.tokens_done``). Flushing to a GCS waits until the runtime
tier is ported.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

_CAP = 65536

_lock = threading.Lock()
_ring: List[list] = []
_dropped: Dict[str, int] = {}


def emit(name: str, plane: str, tenant: str = "",
         dur: Optional[float] = None, **fields) -> None:
    """Record one event; ``dur`` (seconds) marks it as a span."""
    row = [time.time(), name, plane, tenant, "",
           float(dur) if dur is not None else 0.0,
           fields if fields else None]
    with _lock:
        if len(_ring) < _CAP:
            _ring.append(row)
        else:
            _dropped[plane] = _dropped.get(plane, 0) + 1


def drain() -> Tuple[List[list], Dict[str, int]]:
    """Swap out the buffered rows; returns ``(rows, dropped)`` and resets
    the drop counters."""
    with _lock:
        rows, _ring[:] = list(_ring), []
        drops = dict(_dropped)
        _dropped.clear()
    return rows, drops


def reset() -> None:
    """Drop everything buffered."""
    with _lock:
        _ring.clear()
        _dropped.clear()
