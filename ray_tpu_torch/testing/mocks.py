"""Mock transport + in-process GCS harness for unit tests.

Reference: ``src/mock/ray/`` — a GMock mirror of the source tree lets any
component be unit-tested against mocked peers (e.g.
``cluster_task_manager_test.cc`` drives the scheduler with mock raylet
clients). Here the unit of mocking is the framed ``protocol.Connection``:
``MockConnection`` records every outbound frame and scripts replies, and
``MockGcsHarness`` instantiates a real ``GcsServer`` (no sockets, no
subprocesses) whose handlers are driven directly with fabricated clients —
scheduler, pubsub, KV, and object-directory logic become plain-function
tests.
"""

from __future__ import annotations

import asyncio
import tempfile
from typing import Any, Callable, Dict, List, Optional


class MockConnection:
    """Scriptable stand-in for ``protocol.Connection``.

    Records everything the component under test sends; ``sent`` holds the
    raw frames, ``replies_to(corr)`` / ``chunks_for(corr)`` filter by
    correlation id.
    """

    def __init__(self, name: str = "mock"):
        self.name = name
        self.sent: List[dict] = []
        self.closed = False
        self._backlog = 0
        self._next_id = 1000

    # ------------------------------------------------ Connection surface

    def send(self, msg: dict):
        if self.closed:
            raise ConnectionError("mock connection closed")
        self.sent.append(dict(msg))

    def reply(self, req: dict, msg: dict):
        out = dict(msg)
        out["i"] = req["i"]
        out["r"] = 1
        self.send(out)

    def request_nowait(self, msg: dict):
        self._next_id += 1
        msg = dict(msg)
        msg["i"] = self._next_id
        self.send(msg)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        return fut

    def outstanding_bytes(self) -> int:
        return self._backlog

    def start(self):
        return self

    async def close(self):
        self.closed = True

    # ----------------------------------------------------- test controls

    def mark_closed(self):
        self.closed = True

    def set_backlog(self, n: int):
        """Simulate a slow reader (pubsub backpressure trips past the
        publisher's max_outstanding_bytes)."""
        self._backlog = n

    def replies_to(self, corr: int) -> List[dict]:
        return [m for m in self.sent if m.get("i") == corr and m.get("r")]

    def chunks_for(self, corr: int) -> List[dict]:
        return [m for m in self.sent if m.get("i") == corr and m.get("sc")]

    def frames(self, t: Optional[str] = None) -> List[dict]:
        return [m for m in self.sent if t is None or m.get("t") == t]


class MockGcsHarness:
    """A real ``GcsServer`` with no transport: drive handlers directly.

    Usage::

        async with gcs_harness() as h:
            client = h.add_client(role="driver")
            await h.dispatch(client, {"t": "kv_put", "ns": "", "k": "a",
                                      "v": b"1", "i": 1})
            assert client.conn.replies_to(1)[0]["ok"]
    """

    def __init__(self, server):
        self.server = server
        self.clients: List[Any] = []

    def add_client(self, role: str = "driver", node_id=None, worker_id=None):
        from ray_tpu_torch._private.gcs import ClientConn

        conn = MockConnection(name=role)
        client = ClientConn(conn)
        client.role = role
        client.node_id = node_id
        client.worker_id = worker_id
        self.server.clients.append(client)
        self.clients.append(client)
        return client

    async def dispatch(self, client, msg: dict):
        await self.server._dispatch(client, msg)
        return client.conn

    def disconnect(self, client):
        client.conn.mark_closed()
        self.server._on_disconnect(client)


class _HarnessCtx:
    def __init__(self, **server_kwargs):
        self.server_kwargs = server_kwargs
        self.harness: Optional[MockGcsHarness] = None
        self._tmp = None

    async def __aenter__(self) -> MockGcsHarness:
        from ray_tpu_torch._private.gcs import GcsServer

        self._tmp = tempfile.TemporaryDirectory(prefix="rtpt_mockgcs_")
        kwargs = {"session_name": "mock", "session_dir": self._tmp.name,
                  "persist": False}
        kwargs.update(self.server_kwargs)
        server = GcsServer(**kwargs)
        self.harness = MockGcsHarness(server)
        return self.harness

    async def __aexit__(self, *exc):
        try:
            store = self.harness.server.store
            # the native arena has no destroy(): close it and remove it,
            # as the head does at shutdown (``_private/node.py``)
            store.close()
            if hasattr(store, "unlink"):
                store.unlink()
        except Exception:
            pass
        self._tmp.cleanup()


def gcs_harness(**server_kwargs) -> _HarnessCtx:
    """Async context manager producing a transport-less GCS harness."""
    return _HarnessCtx(**server_kwargs)
