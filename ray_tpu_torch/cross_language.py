"""Cross-language task calls (C++ → Python).

Analog of the reference's ``python/ray/cross_language.py`` + the C++ user
API (``cpp/include/ray/api/``): a Python driver registers named functions;
a C++ client (``native/cpp_client/ray_tpu_client.hpp``) submits tasks that
call them by name, with arguments and results encoded as plain msgpack —
the same language-neutral interchange the reference uses for cross-language
calls. Worker-side dispatch: a task whose options carry ``xlang`` decodes
``args`` as a msgpack array and msgpack-encodes the return value, so the
non-Python owner can read the result bytes directly.
"""

from __future__ import annotations

from typing import Any, Callable

import cloudpickle

from ._private.worker import global_worker


def register_function(name: str, fn: Callable) -> None:
    """Expose ``fn`` to non-Python clients under ``name``.

    The function must accept/return msgpack-representable values (numbers,
    strings, bytes, lists, dicts).
    """
    if not name or "/" in name:
        raise ValueError(f"invalid cross-language function name {name!r}")
    w = global_worker()
    w.kv_put(name, cloudpickle.dumps(fn), ns="fn")


def unregister_function(name: str) -> None:
    w = global_worker()
    w.kv_del(name, ns="fn")


def execute_xlang_task(fn: Callable, raw_args: Any) -> bytes:
    """Worker-side xlang execution: msgpack in, msgpack out."""
    import msgpack

    args = msgpack.unpackb(raw_args, raw=False) if raw_args else []
    value = fn(*args)
    return msgpack.packb(value, use_bin_type=True)


def put_xlang(value: Any):
    """Store a msgpack-representable value so NON-Python readers can
    ``get`` it (reference: cross-language object interchange; C++ side:
    ``Client::get`` in ``native/cpp_client/ray_tpu_client.hpp``).

    The object uses the language-neutral framing — a ``{"x": msgpack}``
    header instead of the pickle field — which Python's ``deserialize``
    also reads, so the returned ref resolves from every language.
    """
    import struct

    import msgpack

    from ._private import serialization
    from ._private.ids import ObjectID
    from ._private.worker import ObjectRef

    w = global_worker()
    payload = msgpack.packb(value, use_bin_type=True)
    header = msgpack.packb({"x": payload, "o": [], "l": []},
                           use_bin_type=True)
    blob = struct.pack("<I", len(header)) + header
    oid = ObjectID.for_put(w._put_counter.next())
    if len(blob) <= serialization.INLINE_THRESHOLD:
        w._memory_store[oid] = blob
        w.send_gcs_threadsafe({"t": "obj_put", "oid": oid.binary(),
                               "nbytes": len(blob), "data": blob})
    else:
        # Same split as Worker.put: large values go through the shm
        # store, not the control plane.
        buf = w.create_in_store(oid, len(blob))
        buf[:] = blob
        w.store.seal(oid)
        w.send_gcs_threadsafe({"t": "obj_put", "oid": oid.binary(),
                               "nbytes": len(blob), "shm": True})
    return ObjectRef(oid, w)


class CppFunction:
    """Proxy for a function registered by a C++ worker
    (``ray_tpu_torch::Worker::register_function`` + ``serve``): calls go over
    the worker's direct channel with msgpack args/results — the Python →
    C++ direction of cross-language calls (reference:
    ``cross_language.cpp_function`` + the C++ worker runtime,
    ``cpp/src/ray/runtime/``)."""

    def __init__(self, worker_name: str, fn_name: str):
        self._worker_name = worker_name
        self._fn_name = fn_name
        self._conn = None

    def _connect(self):
        import asyncio

        from ._private import protocol

        w = global_worker()
        addr = w.kv_get(self._worker_name, ns="cppw")
        if addr is None:
            raise ValueError(
                f"no C++ worker {self._worker_name!r} registered")

        async def _open():
            reader, writer = await protocol.connect(addr.decode())
            conn = protocol.Connection(reader, writer)
            conn.start()
            return conn

        return asyncio.run_coroutine_threadsafe(
            _open(), w.loop).result(30)

    def __call__(self, *args, timeout: float = 60.0):
        import asyncio
        import os

        import msgpack

        w = global_worker()
        if self._conn is None or self._conn.closed:
            self._conn = self._connect()
        call = {"t": "actor_call", "m": self._fn_name,
                "tid": os.urandom(16), "nret": 1,
                "opts": {"xlang": True},
                "args": msgpack.packb(list(args), use_bin_type=True)}

        async def _req():
            return await self._conn.request(call, timeout=timeout)

        reply = asyncio.run_coroutine_threadsafe(_req(), w.loop).result(
            timeout + 5)
        data = reply["results"][0]["data"]
        out = msgpack.unpackb(bytes(data), raw=False)
        if isinstance(out, dict) and "__xlang_error__" in out:
            raise RuntimeError(f"C++ worker error: {out['__xlang_error__']}")
        return out


def cpp_function(worker_name: str, fn_name: str) -> CppFunction:
    """Resolve a function served by a named C++ worker."""
    return CppFunction(worker_name, fn_name)
