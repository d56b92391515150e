"""Wire protocol: length-prefixed msgpack frames over asyncio streams.

This is the TPU-native framework's control-plane transport, playing the role
of the reference's gRPC services (``src/ray/protobuf/*.proto``,
``src/ray/rpc/grpc_server.h``). We use Unix-domain sockets with msgpack
framing instead of gRPC: on a single host (the common TPU-pod-host case) UDS
round-trips are ~2-3x cheaper than loopback gRPC and there is no proto
codegen step. Multi-host uses the same framing over TCP.

Frame layout: ``uint32 little-endian payload length | msgpack payload``.
Messages are dicts with short keys:
  ``t``  message type (str)
  ``i``  correlation id for request/reply (int, optional)
plus type-specific fields. Raw binary (pickled data, buffers) rides msgpack
bin fields zero-copy on the read side via ``memoryview``.

Scatter-gather variant (the out-of-band data plane): setting the top bit
of the length prefix marks a frame whose payload is
``uint32 header_len | msgpack header | raw buffer section``. The header is
a normal message dict carrying ``bl`` (buffer lengths); the raw section is
the concatenation of the buffers. On the write side the buffers are handed
to the transport as memoryviews (``writelines`` — no ``to_bytes()``
flatten, no msgpack-bin copy: the transport's gather write is the single
write-side copy). On the read side they are sliced back out of one
immutable payload as memoryviews under ``msg["_bufs"]``, feeding
``pickle.loads(..., buffers=...)`` / ``jax.device_put`` without a copy.
This is what lets pickle5 out-of-band numpy/JAX buffers
(``SerializedObject.buffers``) cross a process boundary without riding
the shared-memory store (remote._prepare_args direct-lane args).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import random
import struct
from typing import Any, Awaitable, Callable, Dict, Optional

import msgpack

from . import failpoints

# Plane-event recorder binding, resolved lazily: protocol is imported
# while ray_tpu_torch/__init__ is still executing (worker bootstrap), so a
# module-level ``from ray_tpu_torch.util import events`` would re-enter the
# partially-initialized package. Bound on first use instead; until the
# recorder module loads, the counter hook is a no-op.
_plane_events = None


def _events():
    global _plane_events
    if _plane_events is None:
        import sys as _sys

        mod = _sys.modules.get("ray_tpu_torch.util.events")
        # Another thread may still be running the module's body (it is in
        # sys.modules from its first line): bind it once that is done.
        if not getattr(getattr(mod, "__spec__", None), "_initializing",
                       False):
            _plane_events = mod
    return _plane_events

_LEN = struct.Struct("<I")
_SG_FLAG = 0x8000_0000  # top bit of the length prefix: scatter-gather
MAX_FRAME = 1 << 30

# RPC chaos (reference: src/ray/rpc/rpc_chaos.h:23 — env-var-driven failure
# injection). ``RAY_TPU_TORCH_RPC_FAILURE="actor_call=0.2,submit=0.1"`` fails that
# fraction of outgoing frames of the named types with a ConnectionError
# before they reach the wire. Client-side only; retry paths must absorb it.
_rpc_chaos: Dict[str, float] = {}


def reload_rpc_chaos():
    _rpc_chaos.clear()
    spec = os.environ.get("RAY_TPU_TORCH_RPC_FAILURE", "")
    for part in filter(None, spec.split(",")):
        mtype, _, prob = part.partition("=")
        try:
            _rpc_chaos[mtype.strip()] = float(prob)
        except ValueError:
            pass


reload_rpc_chaos()


def _maybe_inject_failure(msg: dict):
    if _rpc_chaos:
        prob = _rpc_chaos.get(msg.get("t", ""))
        if prob and random.random() < prob:
            raise ConnectionError(
                f"injected RPC failure for {msg.get('t')!r}")


def pack(msg: dict) -> bytes:
    payload = msgpack.packb(msg, use_bin_type=True)
    if len(payload) > MAX_FRAME:
        # Fail at the SENDER: bit 31 of the prefix is the scatter-gather
        # flag, so an unchecked jumbo frame would be misread by the peer
        # (flag bit set) and desynchronize the stream instead of erroring
        # cleanly. Payloads this size belong on the chunked object plane.
        raise ValueError(f"frame too large: {len(payload)}")
    return _LEN.pack(len(payload)) + payload


def pack_with_buffers(msg: dict, buffers) -> list:
    """Build a scatter-gather frame as a write list.

    Returns ``[prefix+header, buf0, buf1, ...]`` where the buffers are the
    CALLER'S memoryviews, untouched — this function never copies payload
    bytes (asserted by the buffer-identity test); the transport's gather
    write is the only write-side copy. ``bl`` (buffer lengths) is injected
    into the packed header so the read side can slice the raw section
    without any per-buffer framing.
    """
    lens = [len(b) for b in buffers]
    msg["bl"] = lens
    try:
        header = msgpack.packb(msg, use_bin_type=True)
    finally:
        del msg["bl"]
    total = 4 + len(header) + sum(lens)
    if total > MAX_FRAME:
        raise ValueError(f"frame too large: {total}")
    head = _LEN.pack(total | _SG_FLAG) + _LEN.pack(len(header)) + header
    return [head, *buffers]


def decode_sg_payload(payload) -> dict:
    """Decode a scatter-gather payload (everything after the length
    prefix). ``payload`` must be immutable or never-resized: the returned
    ``msg["_bufs"]`` memoryviews alias it zero-copy."""
    view = memoryview(payload)
    (header_len,) = _LEN.unpack(view[:4])
    if 4 + header_len > len(view):
        raise ValueError("scatter-gather header overruns frame")
    msg = msgpack.unpackb(view[4:4 + header_len], raw=False)
    lens = msg.pop("bl", None) or []
    bufs = []
    pos = 4 + header_len
    for ln in lens:
        if pos + ln > len(view):
            raise ValueError("scatter-gather buffer overruns frame")
        bufs.append(view[pos:pos + ln])
        pos += ln
    msg["_bufs"] = bufs
    return msg


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    """Read one frame; returns None on clean EOF."""
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(header)
    sg = bool(length & _SG_FLAG)
    length &= ~_SG_FLAG
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    try:
        payload = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    try:
        msg = (decode_sg_payload(payload) if sg
               else msgpack.unpackb(payload, raw=False))
        if not isinstance(msg, dict):
            raise TypeError(f"non-dict frame: {type(msg).__name__}")
        return msg
    except Exception:
        # A malformed frame (e.g. int map keys, corrupt payload) must not
        # kill the read loop — the length prefix keeps the stream
        # consistent, so skip the frame and keep serving.
        import logging

        logging.getLogger(__name__).exception(
            "dropping undecodable %d-byte frame", length)
        return {}


class Connection:
    """A framed duplex connection with request/reply correlation.

    Mirrors the role of the reference's ``ClientCallManager``
    (``src/ray/rpc/client_call.h``): callers issue ``request()`` and get a
    future; unsolicited messages are dispatched to a handler callback.
    """

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        handler: Optional[Callable[[dict], Awaitable[None]]] = None,
        on_close: Optional[Callable[[], None]] = None,
    ):
        self.reader = reader
        self.writer = writer
        self._handler = handler
        self._on_close = on_close
        self._pending: Dict[int, asyncio.Future] = {}
        # Streaming requests (reference: streaming generators,
        # _raylet.pyx ObjectRefGenerator): chunks arrive as unsolicited
        # frames correlated by request id, the final frame closes the
        # stream. Queue items: ("chunk", msg) | ("end", msg).
        self._streams: Dict[int, asyncio.Queue] = {}
        self._req_ids = itertools.count(1)
        self._closed = False
        self._read_task: Optional[asyncio.Task] = None
        # Write coalescing: frames queued within one loop iteration go out
        # in a single transport write / syscall. Under load (thousands of
        # small control frames per second) this collapses per-message send
        # syscalls, the dominant cost of the control plane.
        self._wbuf: list = []
        self._flush_scheduled = False
        # Backpressure (data-plane bursts): once the transport's write
        # buffer passes the high-water mark, queued parts stay HERE (a
        # plain list) and a drain waiter resumes flushing when the kernel
        # catches up. Without this, a payload burst (thousands of 100KB
        # direct-lane frames submitted in one tick) balloons the transport
        # buffer, whose per-send ``del buffer[:n]`` compaction is
        # O(backlog) — quadratic in the burst (measured: the whole arg
        # data plane collapsed to ~1.4k frames/s before this).
        self._drain_waiting = False
        self._affinity_check = None  # set in start() when checks enabled
        # Ingress accounting (read loop increments): the per-connection
        # rate signal the GCS fairness/admission stats surface — who is
        # actually flooding the control plane, in frames and bytes.
        self.frames_in = 0
        self.bytes_in = 0
        # Cooperative fairness (server-side use): when set, the read
        # loop yields to the event loop every N dispatched frames, so a
        # single connection's 1MB chunk (thousands of decoded frames)
        # cannot monopolize the loop — and a consumer draining parked
        # frames (the GCS fair drain) interleaves instead of watching a
        # queue balloon. None = legacy behavior (no mid-chunk yields).
        self.yield_every: Optional[int] = None

    def start(self):
        loop = asyncio.get_running_loop()
        self._owner_loop = loop
        # Affinity invariant (reference: thread_checker.h): a Connection
        # is owned by ONE loop — off-loop writes are the race class this
        # design forbids. Resolved once here so the per-frame hot path
        # pays a single attribute test when checks are off.
        from .thread_check import assert_on_loop, checks_enabled

        self._affinity_check = (
            (lambda: assert_on_loop(loop, "Connection._write_frame"))
            if checks_enabled() else None)
        self._read_task = loop.create_task(self._read_loop())

    # Transport-buffer congestion threshold and the per-tick byte budget
    # handed to the transport while draining a backlog. Both bound the
    # transport's own buffer (its send-compaction is O(len)); the burst
    # itself waits in ``_wbuf`` as cheap list entries / memoryviews.
    _SEND_HIGH_WATER = 1 << 20
    _SEND_BATCH = 1 << 20

    def _congested(self) -> bool:
        try:
            return (self.writer.transport.get_write_buffer_size()
                    > self._SEND_HIGH_WATER)
        except Exception:
            return False

    def _write_frame(self, data: bytes):
        if self._affinity_check is not None:
            self._affinity_check()
        if self._flush_scheduled or self._congested():
            # A frame already went out this loop tick (coalesce the burst
            # into one combined write at tick end), or the transport is
            # backed up (park the frame here until drain).
            self._wbuf.append(data)
            self._schedule_flush()
            return
        self._flush_scheduled = True
        asyncio.get_running_loop().call_soon(self._flush_wbuf)
        try:
            self.writer.write(data)
        except (ConnectionResetError, BrokenPipeError, OSError):
            self._mark_closed()

    def _write_parts(self, parts: list):
        """Write a scatter-gather frame: the parts (header bytes + caller
        buffer memoryviews) go straight to the transport — a large buffer
        view is handed over as-is, so an uncongested transport sends it
        from the caller's memory with NO user-space copy (the transport's
        buffering is the single write-side copy otherwise)."""
        if self._affinity_check is not None:
            self._affinity_check()
        if self._flush_scheduled or self._congested():
            self._wbuf.extend(parts)
            self._schedule_flush()
            return
        self._flush_scheduled = True
        asyncio.get_running_loop().call_soon(self._flush_wbuf)
        self._transport_write_batch(parts)

    # Parts at least this large are written to the transport individually
    # (zero-join); smaller ones batch through one gather write so a burst
    # of control frames still costs one syscall.
    _BIG_PART = 32 * 1024

    def _transport_write_batch(self, batch: list):
        w = self.writer
        small: list = []
        i = 0
        try:
            for i, p in enumerate(batch):
                if callable(p):
                    # Release marker (pinned-buffer serves): every part
                    # queued before it must reach the transport BEFORE the
                    # pin drops — flush the coalesced small parts first,
                    # or a store abort could recycle the arena range while
                    # its bytes still sit in ``small`` unwritten.
                    if small:
                        if len(small) == 1:
                            w.write(small[0])
                        else:
                            w.writelines(small)
                        small = []
                    try:
                        p()
                    except Exception:
                        pass
                    continue
                if len(p) >= self._BIG_PART:
                    if small:
                        if len(small) == 1:
                            w.write(small[0])
                        else:
                            w.writelines(small)
                        small = []
                    w.write(p)
                else:
                    small.append(p)
            if small:
                if len(small) == 1:
                    w.write(small[0])
                else:
                    w.writelines(small)
        except (ConnectionResetError, BrokenPipeError, OSError):
            # Unreached release markers must still run (the data is never
            # going out; leaking the pins would wedge store aborts).
            for p in batch[i:]:
                if callable(p):
                    try:
                        p()
                    except Exception:
                        pass
            self._mark_closed()

    def _schedule_flush(self):
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_wbuf)

    def _flush_wbuf(self):
        self._flush_scheduled = False
        if self._closed or not self._wbuf:
            for p in self._wbuf:
                if callable(p):  # never-sent frames still release pins
                    try:
                        p()
                    except Exception:
                        pass
            self._wbuf.clear()
            return
        if self._congested():
            # Keep the backlog in _wbuf; resume when the kernel drains.
            # The drain waiter owns the next flush — leaving the scheduled
            # flag set lets concurrent senders append without spinning a
            # no-op call_soon per frame.
            self._flush_scheduled = True
            if not self._drain_waiting:
                self._drain_waiting = True
                asyncio.get_running_loop().create_task(
                    self._drain_then_flush())
            return
        parts = self._wbuf
        if len(parts) == 1:
            self._wbuf = []
            batch = parts
        else:
            # Bounded batch per tick: the transport buffer stays near the
            # high-water mark instead of swallowing the entire burst.
            budget = self._SEND_BATCH
            i = 0
            n = len(parts)
            while i < n:
                p = parts[i]
                if callable(p):
                    # Zero-byte release marker: always rides with (after)
                    # its frame's parts.
                    i += 1
                    continue
                if budget <= 0:
                    break
                budget -= len(p)
                i += 1
            batch = parts[:i]
            self._wbuf = parts[i:]
        self._transport_write_batch(batch)
        if self._closed:
            return
        if self._wbuf:
            self._schedule_flush()

    async def _drain_then_flush(self):
        try:
            await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError,
                ConnectionError):
            self._drain_waiting = False
            self._mark_closed()
            return
        self._drain_waiting = False
        self._flush_wbuf()

    async def _read_loop(self):
        # Batched decode: drain whatever the kernel has buffered in ONE
        # read() wakeup and parse every complete frame out of it — under
        # load (thousands of small control frames/s) this collapses the
        # two readexactly() coroutine hops per frame that dominated the
        # async call path's CPU (reference analog: gRPC's batched
        # completion-queue drain).
        #
        # Fast path: with no carryover from the previous wakeup, frames
        # are parsed STRAIGHT out of the ``read()`` chunk — an immutable
        # bytes — so scatter-gather buffer views alias it with zero
        # additional copies and ordinary frames skip the stream-buffer
        # append. Only a partial tail (or a frame spanning reads) goes
        # through the mutable carry buffer.
        carry = bytearray()
        try:
            while True:
                chunk = await self.reader.read(1 << 20)
                if not chunk:
                    break
                self.bytes_in += len(chunk)
                if carry:
                    carry += chunk
                    src: Any = carry
                    mutable = True
                else:
                    src = chunk
                    mutable = False
                n = len(src)
                pos = 0
                mv = memoryview(src)
                try:
                    while n - pos >= 4:
                        length = int.from_bytes(mv[pos:pos + 4], "little")
                        sg = length & _SG_FLAG
                        if sg:
                            length &= ~_SG_FLAG
                        if length > MAX_FRAME:
                            raise ValueError(f"frame too large: {length}")
                        end = pos + 4 + length
                        if end > n:
                            break  # incomplete frame: wait for more bytes
                        try:
                            if sg and not mutable and 4 * length >= n:
                                # Zero-copy: _bufs alias the immutable
                                # chunk directly. Gated on the frame being
                                # a decent fraction of the chunk: a
                                # handler retaining the value pins the
                                # WHOLE chunk through the views, so small
                                # frames sharing a big chunk would retain
                                # up to chunk/frame times their size —
                                # this bounds that amplification at 4x
                                # (smaller frames take the copy below,
                                # which is what the shm path pays anyway).
                                msg = decode_sg_payload(mv[pos + 4:end])
                            elif sg and not mutable:
                                msg = decode_sg_payload(
                                    bytes(mv[pos + 4:end]))
                            elif sg:
                                # Carve the payload out as one IMMUTABLE
                                # bytes: the msg's ``_bufs`` memoryviews
                                # alias it for as long as the handler (and
                                # any value unpickled zero-copy from them)
                                # needs — the mutable carry buffer gets
                                # compacted below.
                                msg = decode_sg_payload(
                                    bytes(mv[pos + 4:end]))
                            else:
                                msg = msgpack.unpackb(mv[pos + 4:end],
                                                      raw=False)
                            if not isinstance(msg, dict):
                                # Valid msgpack, wrong shape (e.g. a bare
                                # int): same skip as undecodable.
                                raise TypeError(
                                    f"non-dict frame: {type(msg).__name__}")
                        except Exception:
                            # A malformed frame must not kill the read
                            # loop — the length prefix keeps the stream
                            # consistent.
                            import logging

                            logging.getLogger(__name__).exception(
                                "dropping undecodable %d-byte frame",
                                length)
                            msg = {}
                        pos = end
                        self.frames_in += 1
                        await self._dispatch_frame(msg)
                        ye = self.yield_every
                        if ye is not None and self.frames_in % ye == 0:
                            await asyncio.sleep(0)
                finally:
                    # The view must die before the bytearray resize below
                    # (exported views block it with a BufferError).
                    mv.release()
                if mutable:
                    if pos:
                        del carry[:pos]
                else:
                    if pos < n:
                        carry += memoryview(chunk)[pos:]  # partial tail
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        finally:
            self._mark_closed()

    async def _dispatch_frame(self, msg: dict):
        if not msg:
            # Undecodable frame placeholder ({} from the decode guard
            # above): already logged there — never hand it to correlation
            # or handler dispatch, where a missing "t"/"i" would be
            # misread as a typeless push.
            return
        rid = msg.get("i")
        # "r" marks a reply: requests and replies share the "i" field but
        # the two sides allocate ids independently, so a peer-initiated
        # request must not be mistaken for a reply to ours (both
        # directions issue requests on this connection).
        if rid is not None and msg.get("sc") and rid in self._streams:
            self._streams[rid].put_nowait(("chunk", msg))
        elif rid is not None and msg.get("r") and rid in self._streams:
            self._streams.pop(rid).put_nowait(("end", msg))
        elif rid is not None and msg.get("r") and rid in self._pending:
            fut = self._pending.pop(rid)
            if not fut.done():
                fut.set_result(msg)
        elif self._handler is not None:
            # Handlers may be plain functions returning None (cheap
            # enqueue paths — the GCS fair-ingress hot path) or an
            # awaitable / coroutine functions; only await real
            # awaitables so the sync path pays no coroutine setup.
            res = self._handler(msg)
            if res is not None:
                await res

    def _mark_closed(self):
        if self._closed:
            return
        self._closed = True
        if self._wbuf:
            # Parked frames will never be written: run their release
            # markers so pinned serve buffers are freed.
            for p in self._wbuf:
                if callable(p):
                    try:
                        p()
                    except Exception:
                        pass
            self._wbuf.clear()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("connection closed"))
        self._pending.clear()
        for q in self._streams.values():
            q.put_nowait(("end", {"err": "connection closed"}))
        self._streams.clear()
        if self._on_close is not None:
            self._on_close()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------ failpoint plumbing

    def _abort_transport(self):
        """Hard-close without flushing (the injected-crash analog of a
        peer dying mid-stream: TCP RST / no clean FIN handshake)."""
        try:
            self.writer.transport.abort()
        except Exception:
            pass
        self._mark_closed()

    def _fp_short_write(self, msg: dict, buffers):
        """Truncation fault: emit a frame whose length prefix claims the
        full payload but whose body stops partway, then close — the peer
        observes EOF mid-frame (mid-SG-payload for buffer frames), the
        exact wire state a sender crash leaves behind. The reader is
        specified to treat it as a disconnect, never to desync."""
        try:
            if buffers:
                parts = pack_with_buffers(msg, buffers)
                self.writer.write(bytes(parts[0]))
                if len(parts) > 1 and len(parts[1]):
                    first = memoryview(parts[1])
                    self.writer.write(bytes(first[:max(1, len(first) // 2)]))
            else:
                data = pack(msg)
                self.writer.write(data[:max(5, len(data) // 2)])
            # close() (not abort) flushes the partial bytes before FIN so
            # the truncation actually reaches the peer.
            self.writer.close()
        except Exception:
            pass
        self._mark_closed()

    def _fp_outbound(self, msg: dict, buffers, release) -> Optional[str]:
        """Hit the ``conn.send`` failpoint for an outgoing frame. Returns
        None (common case) or the caller-action that consumed the frame
        ("drop"/"short"/"disconnect"); re-raises injected errors after
        running the release hook (pinned buffers must never leak)."""
        try:
            act = failpoints.fire("conn.send", msg.get("t"))
        except failpoints.FailpointError:
            if release is not None:
                release()
            raise
        if act is None or act == "delay":
            return None
        if act == "drop":
            # Frame silently lost on the wire: the release hook still runs
            # (bytes are "gone"), nothing reaches the peer.
            if release is not None:
                release()
            return act
        if act == "short":
            self._fp_short_write(msg, buffers)
            if release is not None:
                release()
            return act
        if act == "disconnect":
            self._abort_transport()
            if release is not None:
                release()
            return act
        return None

    def outstanding_bytes(self) -> int:
        """Unsent bytes queued on this connection (coalescing buffer +
        transport write buffer) — the pubsub slow-subscriber backpressure
        signal (``_private/pubsub.py``)."""
        n = (sum(len(b) for b in self._wbuf if not callable(b))
             if self._wbuf else 0)
        try:
            n += self.writer.transport.get_write_buffer_size()
        except Exception:
            pass
        return n

    def send(self, msg: dict, buffers=None, release=None):
        """Fire-and-forget send. ``buffers``: out-of-band memoryviews
        shipped in a scatter-gather frame (zero-copy write side).
        ``release``: invoked once the frame's bytes were handed to the
        transport (or are known never to go out) — the unpin hook for
        buffers aliasing pinned store memory (chunk serving)."""
        if self._closed:
            if release is not None:
                release()
            raise ConnectionError("connection closed")
        try:
            _maybe_inject_failure(msg)
        except ConnectionError:
            if release is not None:
                release()
            raise
        if failpoints.active() and self._fp_outbound(msg, buffers,
                                                     release) is not None:
            return
        ev = _events()
        if buffers:
            parts = pack_with_buffers(msg, buffers)
            if ev is not None and ev._enabled:
                ev.count("proto.send.frame", key=msg.get("t") or "",
                         nbytes=len(parts[0]) + sum(len(b)
                                                    for b in buffers))
            if release is not None:
                parts.append(release)
            self._write_parts(parts)
        else:
            data = pack(msg)
            if ev is not None and ev._enabled:
                ev.count("proto.send.frame", key=msg.get("t") or "",
                         nbytes=len(data))
            self._write_frame(data)
            if release is not None:
                release()

    def request_nowait(self, msg: dict, buffers=None) -> asyncio.Future:
        """Synchronously send a request; returns the reply future.

        The synchronous send preserves caller ordering (the analog of the
        reference's sequenced actor submit queue,
        ``transport/actor_task_submitter.h:75``). ``buffers``: out-of-band
        payload memoryviews (scatter-gather frame — the direct-lane arg
        path).
        """
        if self._closed:
            raise ConnectionError("connection closed")
        _maybe_inject_failure(msg)
        rid = next(self._req_ids)
        msg["i"] = rid
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        if failpoints.active() and self._fp_outbound(msg, buffers,
                                                     None) is not None:
            # Request frame lost/truncated: the reply future stays pending
            # (dropped frame) or fails via _mark_closed (disconnect/short)
            # — exactly what the caller's timeout/retry path must absorb.
            return fut
        ev = _events()
        if buffers:
            parts = pack_with_buffers(msg, buffers)
            if ev is not None and ev._enabled:
                ev.count("proto.send.frame", key=msg.get("t") or "",
                         nbytes=len(parts[0]) + sum(len(b)
                                                    for b in buffers))
            self._write_parts(parts)
        else:
            data = pack(msg)
            if ev is not None and ev._enabled:
                ev.count("proto.send.frame", key=msg.get("t") or "",
                         nbytes=len(data))
            self._write_frame(data)
        return fut

    async def request(self, msg: dict, timeout: Optional[float] = None) -> dict:
        """Send a message and await the correlated reply."""
        fut = self.request_nowait(msg)
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    def request_stream(self, msg: dict) -> asyncio.Queue:
        """Send a streaming request; returns the chunk queue.

        The peer answers with any number of ``{"i": rid, "sc": 1, ...}``
        chunk frames followed by one normal reply frame that closes the
        stream (("end", msg) in the queue).
        """
        if self._closed:
            raise ConnectionError("connection closed")
        _maybe_inject_failure(msg)
        rid = next(self._req_ids)
        msg["i"] = rid
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        self._write_frame(pack(msg))
        return q

    def reply(self, req: dict, msg: dict, buffers=None, release=None):
        """Send the reply to a received request. ``buffers``/``release``
        as in :meth:`send` (scatter-gather replies — chunk serving)."""
        msg["i"] = req["i"]
        msg["r"] = 1
        self.send(msg, buffers=buffers, release=release)

    async def drain(self):
        await self.writer.drain()

    async def close(self):
        if self._wbuf and not self._closed:
            # Final flush hands EVERYTHING to the transport, bypassing the
            # bounded batching / congestion parking (steady-state
            # machinery): transport.close() drains its own buffer before
            # closing the socket, so nothing queued here is dropped.
            parts, self._wbuf = self._wbuf, []
            self._flush_scheduled = True  # suppress a pending tick flush
            self._transport_write_batch(parts)
        if self._read_task is not None:
            self._read_task.cancel()
        self._mark_closed()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


def widen_for_serving(conn: Connection):
    """Raise a chunk-serving connection's write-buffer ceilings (transport
    pause/resume limits + the connection's own congestion thresholds).

    The asyncio default high water (64KB) drains the pipe to near-empty
    between multi-MB chunk frames, so every chunk pays a full drain
    round-trip and fan-out serving collapses (measured: a 3-puller
    fan-out at ~1/3 the per-stream rate). A pull-window of chunks per
    puller bounds what actually accumulates here."""
    from .config import config as _cfg

    high = max(1 << 20, _cfg().obj_serve_buffer)
    try:
        conn.writer.transport.set_write_buffer_limits(high=high,
                                                      low=high // 2)
    except (AttributeError, RuntimeError, OSError):
        pass
    conn._SEND_HIGH_WATER = high
    conn._SEND_BATCH = high


async def reconnect_with_retry(attempt, *, should_stop=None,
                               attempts: int = 0, delay: float = 0.0) -> bool:
    """Shared reconnect policy for every GCS client (driver, worker, node
    agent): retry ``attempt`` (an async callable performing connect +
    re-hello) within a ``~attempts*delay`` second budget, returning True
    on success. One place to tune the retry budget for all peers.

    Delays ride the shared jittered-exponential ladder
    (``_private/backoff.py``) capped at ``delay``: a GCS restart drops
    EVERY peer at once, and fixed-step retries from dozens of workers
    would thunder back in lockstep against the recovering instance."""
    if not attempts or not delay:
        from .config import config as _cfg

        attempts = attempts or _cfg().reconnect_attempts
        delay = delay or _cfg().reconnect_delay_s
    from .backoff import Backoff

    deadline = (asyncio.get_running_loop().time()
                + max(1, attempts) * max(delay, 1e-3))
    backoff = Backoff(cap=delay)
    while asyncio.get_running_loop().time() < deadline:
        if should_stop is not None and should_stop():
            return False
        await asyncio.sleep(backoff.next_delay())
        try:
            await attempt()
            return True
        except (OSError, ConnectionError, asyncio.TimeoutError):
            continue
    return False


# StreamReader buffer limit. The asyncio default (64KB) forces ~2 read
# wakeups per 100KB data-plane frame (flow control pauses the transport at
# 2x the limit); 1MB lets a whole direct-lane frame arrive in one recv.
_READ_LIMIT = 1 << 20


async def connect(address: str) -> tuple:
    """Open a stream to ``address`` — 'unix:<path>' or 'host:port'."""
    if address.startswith("unix:"):
        return await asyncio.open_unix_connection(address[5:],
                                                  limit=_READ_LIMIT)
    host, _, port = address.rpartition(":")
    return await asyncio.open_connection(host, int(port), limit=_READ_LIMIT)


async def serve(
    address: str, client_connected_cb: Callable
) -> asyncio.AbstractServer:
    if address.startswith("unix:"):
        path = address[5:]
        try:
            # Stale socket file from a crashed/restarted server: closing an
            # asyncio unix server does not unlink its path.
            os.unlink(path)
        except OSError:
            pass
        return await asyncio.start_unix_server(client_connected_cb, path,
                                               limit=_READ_LIMIT)
    host, _, port = address.rpartition(":")
    return await asyncio.start_server(client_connected_cb, host, int(port),
                                      limit=_READ_LIMIT)
