"""Client SDK for the Serve binary RPC ingress.

Reference: the gRPC client side of Serve's gRPC proxy
(``python/ray/serve/_private/proxy.py`` gRPCProxy + generated stubs).
grpcio is not a framework dependency, so the transport is the framework's
length-prefixed msgpack frame protocol over a plain TCP socket —
synchronous, dependency-free, usable from any process.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Iterator, Optional

import msgpack

# Must match ray_tpu_torch._private.protocol._LEN (little-endian length prefix).
_LEN = struct.Struct("<I")


class ServeRpcError(RuntimeError):
    pass


class ServeRpcClient:
    """Synchronous client for ``ProxyActor.start_rpc`` ingress."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: Optional[float] = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")
        self._next_id = 0

    def _send(self, msg: dict) -> int:
        self._next_id += 1
        msg["i"] = self._next_id
        payload = msgpack.packb(msg, use_bin_type=True)
        self._sock.sendall(_LEN.pack(len(payload)) + payload)
        return self._next_id

    def _recv(self) -> dict:
        header = self._rfile.read(4)
        if len(header) < 4:
            raise ServeRpcError("connection closed by proxy")
        (length,) = _LEN.unpack(header)
        body = self._rfile.read(length)
        if len(body) < length:
            raise ServeRpcError("truncated frame from proxy")
        return msgpack.unpackb(body, raw=False)

    def call(self, route: str, payload: Any = None,
             metadata: Optional[dict] = None) -> Any:
        """Unary call: returns the handler's (last) result."""
        corr = self._send({"t": "serve_call", "route": route,
                           "payload": payload, "meta": metadata or {}})
        reply = self._recv()
        assert reply.get("i") == corr, "correlation mismatch"
        if not reply.get("ok"):
            raise ServeRpcError(reply.get("error", "unknown error"))
        return reply.get("result")

    def stream(self, route: str, payload: Any = None,
               metadata: Optional[dict] = None) -> Iterator[Any]:
        """Server-streaming call: yields each chunk the handler emits."""
        corr = self._send({"t": "serve_call", "route": route,
                           "payload": payload, "meta": metadata or {},
                           "stream": True})
        while True:
            reply = self._recv()
            assert reply.get("i") == corr, "correlation mismatch"
            if reply.get("eos"):
                return
            if "chunk" in reply:
                yield reply["chunk"]
                continue
            if not reply.get("ok", True):
                raise ServeRpcError(reply.get("error", "unknown error"))

    def routes(self) -> list:
        corr = self._send({"t": "serve_routes"})
        reply = self._recv()
        assert reply.get("i") == corr
        return reply.get("result", [])

    def healthz(self) -> bool:
        corr = self._send({"t": "serve_healthz"})
        reply = self._recv()
        return reply.get("i") == corr and reply.get("result") == "ok"

    def close(self):
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
