"""ASGI ingress: serve any ASGI application as a deployment.

Reference: ``serve.ingress`` (``python/ray/serve/api.py:170``) wraps a
FastAPI app so HTTP requests dispatch through it. FastAPI/starlette do
not ship in this image, so the bridge here speaks raw ASGI — any
framework implementing the protocol (or a hand-written
``async def app(scope, receive, send)``) works, which is the same
contract FastAPI apps satisfy.

The wrapped deployment's ``__call__`` translates the proxy's ``Request``
into an ASGI ``http`` scope, runs the app, and returns the response with
status/headers preserved (the proxy honors the ``__asgi__`` marker).
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def _to_scope(request) -> Dict[str, Any]:
    query = "&".join(f"{k}={v}"
                     for k, v in (request.query_params or {}).items())
    return {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": request.method,
        "path": request.path,
        "raw_path": request.path.encode(),
        "query_string": query.encode(),
        "headers": [(k.lower().encode(), str(v).encode())
                    for k, v in (request.headers or {}).items()],
        "client": ("127.0.0.1", 0),
        "server": ("127.0.0.1", 0),
    }


async def _run_asgi(app: Callable, request) -> Dict[str, Any]:
    scope = _to_scope(request)
    body = request.body() if callable(getattr(request, "body", None)) \
        else (getattr(request, "body", b"") or b"")
    sent = {"given": False}

    async def receive():
        if sent["given"]:
            return {"type": "http.disconnect"}
        sent["given"] = True
        return {"type": "http.request", "body": body, "more_body": False}

    out = {"status": 500, "headers": [], "body": b""}

    async def send(message):
        if message["type"] == "http.response.start":
            out["status"] = message["status"]
            out["headers"] = [
                (k.decode(), v.decode())
                for k, v in message.get("headers", [])]
        elif message["type"] == "http.response.body":
            out["body"] += message.get("body", b"")

    await app(scope, receive, send)
    return {"__asgi__": True, "status": out["status"],
            "headers": out["headers"], "body": out["body"]}


def ingress(app: Any) -> Callable:
    """Class decorator: HTTP requests route through the ASGI ``app``
    (reference: ``serve.ingress``). The decorated class may also expose
    normal methods for handle-based calls."""
    if not callable(app):
        raise TypeError(
            "serve.ingress expects an ASGI application "
            "(async callable taking (scope, receive, send)); FastAPI "
            "apps satisfy this when the package is installed")

    def decorator(cls):
        class AsgiIngress(cls):
            __name__ = getattr(cls, "__name__", "AsgiIngress")

            async def __call__(self, request):
                return await _run_asgi(app, request)

        AsgiIngress.__qualname__ = getattr(cls, "__qualname__",
                                           "AsgiIngress")
        AsgiIngress.__serve_asgi_app__ = app
        return AsgiIngress

    return decorator
