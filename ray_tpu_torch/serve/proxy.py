"""HTTP ingress proxy.

Reference: ``ProxyActor`` (``serve/proxy.py:1129``) — an aiohttp server in
an actor forwarding requests to the app's ingress deployment handle. JSON
bodies are parsed into a lightweight ``Request``; handler returns are
serialized as JSON (dict/list) or text.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import ray_tpu_torch


class Request:
    """What an HTTP-ingress deployment receives (starlette-Request-like)."""

    def __init__(self, method: str, path: str, query: Dict[str, str],
                 body: bytes, headers: Dict[str, str]):
        self.method = method
        self.path = path
        self.query_params = query
        self._body = body
        self.headers = headers

    def json(self) -> Any:
        return json.loads(self._body or b"null")

    def body(self) -> bytes:
        return self._body

    def __reduce__(self):
        return (Request, (self.method, self.path, self.query_params,
                          self._body, self.headers))


@ray_tpu_torch.remote
class ProxyActor:
    def __init__(self):
        self.apps: Dict[str, str] = {}  # route_prefix -> (app, ingress dep)
        self.handles: Dict[str, Any] = {}
        self._route_order: list = []  # prefixes, longest first
        self.port: Optional[int] = None
        self._runner = None

    def _reindex_routes(self):
        self._route_order = sorted(self.handles, key=len, reverse=True)

    def _node_draining(self) -> bool:
        """Is THIS proxy's node draining? (cached ~5s). External load
        balancers watch the health endpoints; flipping them to "draining"
        the moment the GCS records the drain lets the LB stop sending new
        connections before the node goes away."""
        import time as _time

        now = _time.monotonic()
        cached = getattr(self, "_drain_cache", None)
        if cached is not None and now - cached[0] < 5.0:
            return cached[1]
        draining = False
        try:
            from ray_tpu_torch import get_runtime_context
            from ray_tpu_torch.util import state as state_api

            my_node = get_runtime_context().get_node_id()
            for n in state_api.list_nodes():
                if n["node_id"] == my_node:
                    draining = bool(n.get("draining"))
                    break
        except Exception:
            draining = False
        self._drain_cache = (now, draining)
        return draining

    async def register(self, route_prefix: str, app_name: str,
                       ingress_deployment: str):
        from .deployment import DeploymentHandle

        self.handles[route_prefix] = DeploymentHandle(
            ingress_deployment, app_name)
        self._reindex_routes()
        return True

    async def unregister(self, route_prefix: str):
        self.handles.pop(route_prefix, None)
        self._reindex_routes()
        return True

    def _find_route(self, path: str):
        """Longest-prefix route match, shared by HTTP and RPC ingress
        (route order precomputed at register time, not per request)."""
        for prefix in self._route_order:
            if path == prefix or path.startswith(
                    prefix.rstrip("/") + "/") or prefix == "/":
                return prefix
        return None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        from aiohttp import web

        def encode_chunk(item, sse: bool) -> bytes:
            if isinstance(item, bytes):
                raw = item
            elif isinstance(item, (dict, list)):
                raw = json.dumps(item).encode()
            else:
                raw = str(item).encode()
            if sse:
                return b"data: " + raw + b"\n\n"
            return raw

        def render_unary(result):
            if isinstance(result, dict) and result.get("__asgi__"):
                # serve.ingress ASGI bridge: status/headers preserved
                return web.Response(
                    status=result["status"],
                    headers={k: v for k, v in result["headers"]
                             if k.lower() != "content-length"},
                    body=result["body"])
            if isinstance(result, (dict, list)):
                return web.json_response(result)
            if isinstance(result, bytes):
                return web.Response(body=result)
            return web.Response(text=str(result))

        async def handler(request: "web.Request"):
            path = request.path
            if path == "/-/healthz":
                # LB health endpoint: 503 while this proxy's node drains
                # so upstreams stop opening new connections here.
                import asyncio as _asyncio

                draining = await _asyncio.get_event_loop().run_in_executor(
                    None, self._node_draining)
                if draining:
                    return web.Response(status=503, text="draining")
                return web.Response(text="ok")
            match = self._find_route(path)
            if match is None:
                return web.Response(status=404, text="no app for route")
            body = await request.read()
            req = Request(request.method, path, dict(request.query), body,
                          dict(request.headers))
            handle = self.handles[match]
            # Unary first, on the batched actor-call path (~an order of
            # magnitude cheaper per call than the streaming channel);
            # generator handlers answer with the needs-stream marker and
            # fall through to the streaming flow below.
            try:
                result = await handle.remote(req)
            except Exception as e:  # noqa: BLE001
                return web.Response(status=500, text=str(e))
            if not (isinstance(result, dict)
                    and result.get("__serve_needs_stream__")):
                return render_unary(result)
            # Streaming handler (reference: Serve streaming responses,
            # proxy.py:1129): the replica's generator chunks flow
            # straight to the client.
            gen = handle.stream(req)
            try:
                first = await anext(gen)
            except StopAsyncIteration:
                return web.Response(status=204)
            except Exception as e:  # noqa: BLE001
                return web.Response(status=500, text=str(e))
            try:
                second = await anext(gen)
            except StopAsyncIteration:
                return render_unary(first)
            except Exception as e:  # noqa: BLE001
                return web.Response(status=500, text=str(e))
            # ≥2 chunks: a real stream. SSE framing when the client asked
            # for text/event-stream, raw chunked transfer otherwise.
            sse = "text/event-stream" in request.headers.get("Accept", "")
            resp = web.StreamResponse(headers={
                "Content-Type": ("text/event-stream" if sse
                                 else "text/plain; charset=utf-8"),
                "Cache-Control": "no-cache"})
            await resp.prepare(request)
            await resp.write(encode_chunk(first, sse))
            await resp.write(encode_chunk(second, sse))
            try:
                async for item in gen:
                    await resp.write(encode_chunk(item, sse))
            except Exception as e:  # noqa: BLE001
                await resp.write(encode_chunk(
                    {"error": str(e)} if sse else f"[stream error: {e}]",
                    sse))
            await resp.write_eof()
            return resp

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", handler)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self.port

    async def get_port(self):
        return self.port

    # ----------------------------------------------------- RPC ingress

    async def start_rpc(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Binary RPC ingress (the reference's gRPC proxy analog,
        ``serve/_private/proxy.py:1129`` gRPCProxy).

        grpcio is not a framework dependency, so the wire format is the
        framework's own length-prefixed msgpack frames
        (``_private/protocol.py``) — same capability surface as the
        reference's gRPC ingress: unary calls, server streaming, route
        listing, health checks. Clients use
        ``ray_tpu_torch.serve.rpc_client.ServeRpcClient``.
        """
        import asyncio

        from ray_tpu_torch._private import protocol

        async def handle_call(writer, msg):
            corr = msg.get("i")
            route = self._find_route(msg.get("route", "/"))
            if route is None:
                writer.write(protocol.pack(
                    {"i": corr, "ok": False,
                     "error": f"no app for route {msg.get('route')!r}"}))
                return
            payload = msg.get("payload")
            body = payload if isinstance(payload, bytes) else \
                json.dumps(payload).encode()
            req = Request("RPC", msg.get("route", route), {}, body,
                          msg.get("meta") or {})
            handle = self.handles[route]
            if msg.get("stream"):
                gen = handle.stream(req)
                try:
                    async for item in gen:
                        writer.write(protocol.pack(
                            {"i": corr, "chunk": _rpc_safe(item)}))
                        await writer.drain()
                    writer.write(protocol.pack({"i": corr, "eos": True}))
                except Exception as e:  # noqa: BLE001
                    writer.write(protocol.pack(
                        {"i": corr, "ok": False, "error": str(e)}))
                return
            try:
                # Unary on the batched actor-call path; a generator
                # handler answers with the needs-stream marker and is
                # drained over the streaming channel instead.
                result = await handle.remote(req)
                if isinstance(result, dict) and \
                        result.get("__serve_needs_stream__"):
                    result = None
                    async for item in handle.stream(req):
                        result = item  # unary client: last chunk wins
                writer.write(protocol.pack(
                    {"i": corr, "ok": True, "result": _rpc_safe(result)}))
            except Exception as e:  # noqa: BLE001
                writer.write(protocol.pack(
                    {"i": corr, "ok": False, "error": str(e)}))

        async def on_client(reader, writer):
            try:
                while True:
                    msg = await protocol.read_frame(reader)
                    if msg is None:
                        break
                    if not msg:
                        continue  # undecodable frame placeholder: skip
                    t = msg.get("t")
                    if t == "serve_call":
                        await handle_call(writer, msg)
                    elif t == "serve_routes":
                        writer.write(protocol.pack(
                            {"i": msg.get("i"), "ok": True,
                             "result": sorted(self.handles)}))
                    elif t == "serve_healthz":
                        draining = await asyncio.get_event_loop() \
                            .run_in_executor(None, self._node_draining)
                        writer.write(protocol.pack(
                            {"i": msg.get("i"), "ok": True,
                             "result": "draining" if draining else "ok"}))
                    else:
                        writer.write(protocol.pack(
                            {"i": msg.get("i"), "ok": False,
                             "error": f"unknown rpc {t!r}"}))
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass
            finally:
                try:
                    writer.close()
                except Exception:
                    pass

        server = await asyncio.start_server(on_client, host, port)
        self._rpc_server = server
        self.rpc_port = server.sockets[0].getsockname()[1]
        return self.rpc_port

    async def get_rpc_port(self):
        return getattr(self, "rpc_port", None)


def _rpc_safe(item):
    """Coerce a handler return into something msgpack can carry.

    Recursive (not a json round-trip) so nested ``bytes`` survive — the
    wire format is msgpack, which carries binary natively."""
    if isinstance(item, (bytes, str, int, float, bool, type(None))):
        return item
    if isinstance(item, dict):
        return {str(k): _rpc_safe(v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return [_rpc_safe(v) for v in item]
    return str(item)
