"""GCS-side publisher: named channels with per-subscriber state.

Reference: ``src/ray/pubsub/publisher.h:296`` / ``subscriber.h:329`` — the
reference's long-poll publisher tracks per-subscriber cursors over
channels (object locations, actor state, jobs, logs, errors). TPU-native
redesign: connections here are persistent framed streams
(``protocol.py``), so subscriptions are server-push stream requests — a
subscriber opens one ``{"t": "sub", "ch": ...}`` stream and every
``publish`` delivers a chunk frame on it; no long-poll round trips.
Slow/dead subscribers are bounded by a per-subscription overflow counter
(the reference's ``publisher_entity_buffer`` analog) and dropped frames
are reported in-band so readers can detect gaps.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

# Channels the GCS itself publishes on (user code may add its own names).
CH_ACTOR_STATE = "actor_state"
CH_NODE_EVENTS = "node_events"
CH_ERRORS = "errors"
CH_JOBS = "jobs"


class _Subscription:
    __slots__ = ("conn", "corr", "delivered", "dropped")

    def __init__(self, conn, corr: int):
        self.conn = conn
        self.corr = corr
        self.delivered = 0
        self.dropped = 0


class Publisher:
    """Named channels -> live subscriptions; push on publish."""

    def __init__(self, max_outstanding_bytes: int = 4 << 20):
        self._channels: Dict[str, List[_Subscription]] = {}
        self._seq: Dict[str, int] = {}
        self.max_outstanding_bytes = max_outstanding_bytes

    def subscribe(self, channel: str, conn, corr: int) -> _Subscription:
        sub = _Subscription(conn, corr)
        self._channels.setdefault(channel, []).append(sub)
        return sub

    def unsubscribe(self, channel: str, conn, corr: Optional[int] = None
                    ) -> int:
        """Close matching subscriptions (by conn, optionally by stream id).
        Sends the stream-terminating reply so the client's queue ends."""
        subs = self._channels.get(channel, [])
        closed = 0
        keep = []
        for s in subs:
            if s.conn is conn and (corr is None or s.corr == corr):
                self._finish(s)
                closed += 1
            else:
                keep.append(s)
        if keep:
            self._channels[channel] = keep
        else:
            self._channels.pop(channel, None)
            self._seq.pop(channel, None)
        return closed

    def _finish(self, sub: _Subscription):
        if not sub.conn.closed:
            try:
                sub.conn.send({"i": sub.corr, "r": 1, "ok": True,
                               "closed": True, "delivered": sub.delivered,
                               "dropped": sub.dropped})
            except ConnectionError:
                pass

    def publish(self, channel: str, message: dict) -> int:
        """Deliver to every live subscriber; returns the delivery count."""
        subs = self._channels.get(channel)
        if not subs:
            # No seq tracking for subscriber-less channels: per-task/job
            # channel names would otherwise grow this dict forever.
            return 0
        seq = self._seq[channel] = self._seq.get(channel, 0) + 1
        delivered = 0
        dead = False
        for s in subs:
            if s.conn.closed:
                dead = True
                continue
            # Backpressure: a subscriber that stopped reading accumulates
            # outbound bytes on its transport; skip (and count) instead of
            # buffering unboundedly in the GCS.
            transport_backlog = getattr(s.conn, "outstanding_bytes", None)
            if (transport_backlog is not None
                    and transport_backlog() > self.max_outstanding_bytes):
                s.dropped += 1
                continue
            try:
                s.conn.send({"i": s.corr, "sc": 1, "ch": channel,
                             "seq": seq, "ts": time.time(),
                             "pub": message,
                             **({"dropped": s.dropped} if s.dropped else {})})
                s.delivered += 1
                delivered += 1
            except ConnectionError:
                dead = True
        if dead:
            self._channels[channel] = [s for s in subs if not s.conn.closed]
        return delivered

    def drop_conn(self, conn):
        """Disconnect cleanup: remove every subscription on this conn."""
        for channel in list(self._channels):
            self._channels[channel] = [
                s for s in self._channels[channel] if s.conn is not conn]
            if not self._channels[channel]:
                del self._channels[channel]
                self._seq.pop(channel, None)

    def stats(self) -> Dict[str, dict]:
        return {
            ch: {"subscribers": len(subs),
                 "seq": self._seq.get(ch, 0),
                 "dropped": sum(s.dropped for s in subs)}
            for ch, subs in self._channels.items()
        }
