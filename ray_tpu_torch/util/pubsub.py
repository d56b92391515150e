"""Client-side pubsub API over the GCS publisher.

Reference: ``src/ray/pubsub/subscriber.h:329`` (``SubscriberChannel``) and
the Python surfaces built on it. The GCS publishes built-in channels —
``actor_state``, ``node_events``, ``errors``, ``jobs`` — and any process
can publish/subscribe on arbitrary user channels. Subscriptions are
server-push streams on the persistent GCS connection (no long-poll; see
``_private/pubsub.py``), surfaced here as a thread-safe iterator.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Any, Iterator, Optional

CH_ACTOR_STATE = "actor_state"
CH_NODE_EVENTS = "node_events"
CH_ERRORS = "errors"
CH_JOBS = "jobs"


def publish(channel: str, message: Any, *, wait: bool = True) -> int:
    """Publish on a channel; returns the number of live subscribers
    delivered to (0 when ``wait`` is False)."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    if wait:
        reply = w.run_async(w.gcs.request(
            {"t": "pub", "ch": channel, "m": message}), timeout=30)
        return int(reply.get("delivered", 0))
    w.loop.call_soon_threadsafe(
        w.gcs.send, {"t": "pub", "ch": channel, "m": message})
    return 0


class Subscriber:
    """A live subscription; iterate or ``poll`` for messages.

    Each received item is a dict: ``{"message": ..., "seq": int,
    "ts": float, "channel": str}``. ``seq`` gaps mean the publisher
    dropped frames for this subscriber (slow-reader backpressure). After
    a control-plane restart the subscription re-establishes itself and
    delivers one ``{"resubscribed": True, "message": None}`` gap marker —
    frames published during the outage are lost."""

    def __init__(self, channel: str):
        from ray_tpu_torch._private.worker import global_worker

        self.channel = channel
        self._w = global_worker()
        self._out: _queue.Queue = _queue.Queue()
        self._closed = threading.Event()
        self._sid: Optional[int] = None
        self._w.run_async(self._start(), timeout=30)

    async def _start(self):
        msg = {"t": "sub", "ch": self.channel}
        q = self._w.gcs.request_stream(msg)
        self._sid = msg["i"]  # request_stream stamps the stream id

        async def pump():
            while True:
                kind, end_msg = await q.get()
                if kind == "end":
                    await on_end(end_msg)
                    return
                self._out.put({
                    "channel": end_msg.get("ch", self.channel),
                    "seq": end_msg.get("seq"),
                    "ts": end_msg.get("ts"),
                    "dropped": end_msg.get("dropped", 0),
                    "message": end_msg.get("pub"),
                })

        async def on_end(end_msg):
            if self._closed.is_set() or end_msg.get("closed"):
                # Clean unsubscribe (server confirms with closed=True).
                self._closed.set()
                self._out.put(None)
                return
            # Abnormal end: the GCS connection dropped (control-plane
            # restart). The rest of the cluster transparently resyncs
            # (worker reconnect path), so long-lived subscriptions must
            # too — resubscribe on the fresh connection with backoff,
            # surfacing a gap marker so readers know frames may be lost.
            deadline = asyncio.get_running_loop().time() + 60.0
            while not self._closed.is_set():
                await asyncio.sleep(0.5)
                conn = self._w.gcs
                if conn is None or conn.closed:
                    if asyncio.get_running_loop().time() > deadline:
                        break
                    continue
                try:
                    await self._start()
                except ConnectionError:
                    continue
                self._out.put({"channel": self.channel, "seq": None,
                               "ts": None, "dropped": 0, "message": None,
                               "resubscribed": True})
                return
            self._closed.set()
            self._out.put(None)

        self._pump_task = asyncio.ensure_future(pump())

    def poll(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next message, or None on timeout/closed stream."""
        if self._closed.is_set() and self._out.empty():
            return None
        try:
            return self._out.get(timeout=timeout)
        except _queue.Empty:
            return None

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self.poll()
            if item is None:
                return
            yield item

    def close(self):
        if self._closed.is_set():
            return
        try:
            self._w.run_async(self._w.gcs.request(
                {"t": "unsub", "ch": self.channel, "sid": self._sid}),
                timeout=10)
        except Exception:
            pass
        self._closed.set()
        self._out.put(None)  # wake any consumer blocked in poll()
        # Cancel the pump so interpreter teardown doesn't warn about a
        # pending task parked on the stream queue.
        task = getattr(self, "_pump_task", None)
        if task is not None and not task.done():
            try:
                self._w.loop.call_soon_threadsafe(task.cancel)
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def subscribe(channel: str) -> Subscriber:
    return Subscriber(channel)
