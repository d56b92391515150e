"""Cooperative pipelined object broadcast (the P2P bulk-object plane).

The dominant bulk-payload shape in a production jax_graft stack is one
large blob (model weights, checkpoint shards, KV pages) produced once and
fetched by every node: RL learner->actor weight refresh (Podracer, arxiv
2104.06272), serve replica model load, train restore. The naive pull —
every node fetches the whole object from the one registered holder —
makes an N-node broadcast N full transfers out of a single source's
egress (the reference baseline: 1 GiB -> 50 nodes at 0.83 GB/s aggregate,
BASELINE.md).

This module turns that into a cooperative pipeline, three pieces:

* **Chunk-level holder registration** — a puller reports chunk-bitmap
  progress to the GCS object directory mid-pull (``obj_progress``), so a
  node holding the first k chunks serves them to later pullers
  immediately. An N-node broadcast becomes a relay chain whose wall clock
  approaches ONE transfer time instead of N.
* **Multi-source striping** (:class:`StripedPull`) — the pull engine
  stripes its chunk window across every advertised holder (full holders
  and partial holders constrained to their bitmaps), claims chunks
  greedily per source (fast sources naturally carry more), retries a
  failed or short chunk on another holder at CHUNK granularity instead of
  restarting the object, and completes only when every chunk landed.
  Chunk order is rotated by a random offset per puller so concurrent
  pullers quickly hold DISJOINT chunk ranges and can serve each other
  (the rarest-first idea, cheap version).
* **Zero-copy chunk serving** (:func:`serve_obj_fetch` +
  :class:`ChunkClient`) — the serve side ships the chunk as a raw
  scatter-gather buffer section sliced straight out of the pinned arena
  view (no per-chunk ``bytes()`` copy; the pin is released only after the
  bytes were handed to the transport), and the receive side reads the
  payload straight into the destination arena range over a raw
  non-blocking socket (``loop.sock_recv_into`` — no StreamReader copy, no
  frame-buffer copy).

Wire format is the ordinary framed protocol (``protocol.py``): requests
are plain msgpack frames, chunk replies are scatter-gather frames. Only
the CLIENT read loop is special-cased here; any ``Connection``-based
server (the node agent, a worker serving its in-progress pull) answers.
"""

from __future__ import annotations

import asyncio
import socket
import threading
from collections import deque
from time import perf_counter as _perf_counter
from typing import Callable, Dict, List, Optional

import msgpack

from ray_tpu_torch.util import events as plane_events

from . import failpoints
from .protocol import _LEN, _SG_FLAG, MAX_FRAME, pack

# Per-source in-flight queue-depth gauge (flight-recorder telemetry;
# lazy + recorder-gated via events.gauge).
_set_inflight = plane_events.gauge(
    "bcast_inflight_chunks",
    "in-flight chunk fetches per broadcast source", tag_keys=("src",))


# ----------------------------------------------------------------- bitmaps


def bitmap_make(nchunks: int) -> bytearray:
    return bytearray((nchunks + 7) // 8)


def bitmap_set(bm: bytearray, i: int) -> None:
    bm[i >> 3] |= 1 << (i & 7)


def bitmap_clear(bm: bytearray, i: int) -> None:
    bm[i >> 3] &= ~(1 << (i & 7)) & 0xFF


def bitmap_test(bm, i: int) -> bool:
    return bool(bm[i >> 3] & (1 << (i & 7)))


# -------------------------------------------------------------- serve side


class ServeView:
    """Minimal view shim for serving chunks out of an in-progress pull
    buffer: same ``.data`` / ``.close()`` contract as
    ``object_store.PlasmaObjectView`` (close runs its callback exactly
    once — for SG replies only after the transport took the bytes)."""

    __slots__ = ("data", "_cb")

    def __init__(self, data, cb=None):
        self.data = data
        self._cb = cb

    def close(self):
        cb, self._cb = self._cb, None
        if cb is not None:
            cb()


def serve_obj_fetch(conn, msg: dict, view, *, miss: bool = False,
                    stats: Optional[dict] = None) -> None:
    """Answer one ``obj_fetch`` request on a framed connection.

    ``view`` exposes ``.data`` (a memoryview over the WHOLE object) and
    ``.close()`` (the reader pin release). For scatter-gather requests
    (``msg["sg"]``) the chunk rides as a raw buffer section aliasing the
    arena view — no ``bytes()`` copy — and ``close`` is invoked by the
    transport-handoff release callback, so the pin outlives any write
    parking. ``view=None`` sends a negative reply; ``miss=True`` marks a
    partial-holder chunk that has not landed yet (retryable elsewhere,
    the source stays alive).
    """
    if view is None:
        try:
            conn.reply(msg, {"ok": False, "miss": True} if miss
                       else {"ok": False})
        except ConnectionError:
            pass
        return
    off = int(msg.get("off", 0))
    length = int(msg.get("len", 0))
    total = len(view.data)
    if off < 0 or length < 0 or off + length > total:
        view.close()
        try:
            conn.reply(msg, {"ok": False})
        except ConnectionError:
            pass
        return
    if failpoints.active():
        # Chunk-serve boundary (framed relay path): ``drop`` answers a
        # retryable miss, ``short``/``disconnect`` die mid-reply — the
        # puller must fail over to another holder at CHUNK granularity.
        try:
            act = failpoints.fire("bcast.serve.chunk")
        except failpoints.FailpointError:
            view.close()
            raise
        if act == "drop":
            view.close()
            try:
                conn.reply(msg, {"ok": False, "miss": True})
            except ConnectionError:
                pass
            return
        if act == "short":
            reply = {"i": msg.get("i"), "r": 1, "ok": True,
                     "total": total, "off": off}
            part = view.data[off:off + length]
            try:
                conn._fp_short_write(reply, [part])
            finally:
                view.close()
            return
        if act == "disconnect":
            view.close()
            conn._abort_transport()
            return
    oid_hex = bytes(msg.get("oid") or b"").hex()[:12]
    if msg.get("sg") and length:
        try:
            # Materialize BEFORE committing to the reply: a spill-backed
            # view preads here and a short read (file evicted/truncated
            # under us) must become a retryable miss, not a framed reply
            # whose payload never arrives.
            part = view.data[off:off + length]
        except OSError:
            view.close()
            try:
                conn.reply(msg, {"ok": False, "miss": True})
            except ConnectionError:
                pass
            return
        if stats is not None:
            stats["bcast_sg_chunks_served"] += 1
            stats["bcast_bytes_served"] += length
        plane_events.emit("bcast.chunk.serve", plane="bcast",
                          tenant=plane_events.process_tenant(),
                          off=off, nbytes=length, oid=oid_hex)
        try:
            conn.reply(msg, {"ok": True, "total": total, "off": off},
                       buffers=[part], release=view.close)
        except ConnectionError:
            view.close()
        return
    # Legacy copy path (peers that didn't ask for SG frames).
    try:
        try:
            chunk = bytes(view.data[off:off + length]) if length else b""
        except OSError:
            conn.reply(msg, {"ok": False, "miss": True})
            return
        if stats is not None:
            stats["bcast_copy_chunks_served"] += 1
            stats["bcast_bytes_served"] += length
        conn.reply(msg, {"ok": True, "data": chunk, "total": total,
                         "off": off})
    except ConnectionError:
        pass
    finally:
        view.close()


def _recv_exact_blocking(sock: socket.socket, n: int) -> Optional[bytes]:
    """Blocking exact read; None on clean EOF at a frame boundary."""
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def _serve_conn_blocking(sock: socket.socket, resolve: Callable,
                         stats: Optional[dict]):
    """One chunk-serve connection, blocking IO.

    Requests are ordinary frames; replies go out with ``sendall`` straight
    from the pinned view — blocking sends release the GIL and skip the
    asyncio transport's buffering memcpy entirely (measured ~5x the
    per-process egress of the transport path on a sandboxed kernel).
    Replies stay FIFO per connection by construction."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    try:
        while True:
            head = _recv_exact_blocking(sock, 4)
            if head is None:
                return
            (length,) = _LEN.unpack(head)
            length &= ~_SG_FLAG
            if length > MAX_FRAME:
                return
            payload = _recv_exact_blocking(sock, length)
            if payload is None:
                return
            try:
                msg = msgpack.unpackb(payload, raw=False)
            except Exception:
                continue
            if not isinstance(msg, dict) or msg.get("t") != "obj_fetch":
                continue
            rid = msg.get("i")
            off = int(msg.get("off", 0))
            ln = int(msg.get("len", 0))
            view, miss = resolve(msg)
            if view is None:
                out = {"i": rid, "r": 1, "ok": False}
                if miss:
                    out["miss"] = True
                sock.sendall(pack(out))
                continue
            total = len(view.data)
            if off < 0 or ln < 0 or off + ln > total:
                view.close()
                sock.sendall(pack({"i": rid, "r": 1, "ok": False}))
                continue
            if failpoints.active():
                # Chunk-serve boundary (raw-socket path — the one the
                # 4-node broadcast actually rides): ``drop`` = retryable
                # miss; ``short`` = header claims the full chunk, half
                # the payload lands, socket dies (a holder crashing
                # mid-sendall); ``raise``/``disconnect`` = socket dies
                # cold. All must resolve as chunk-granular failover.
                try:
                    act = failpoints.fire("bcast.serve.chunk")
                except failpoints.FailpointError:
                    view.close()
                    raise  # ConnectionError -> outer OSError handler
                if act == "drop":
                    view.close()
                    sock.sendall(pack({"i": rid, "r": 1, "ok": False,
                                       "miss": True}))
                    continue
                if act in ("short", "disconnect"):
                    try:
                        if act == "short" and ln:
                            header = msgpack.packb(
                                {"i": rid, "r": 1, "ok": True,
                                 "total": total, "off": off, "bl": [ln]},
                                use_bin_type=True)
                            sock.sendall(
                                _LEN.pack((4 + len(header) + ln) | _SG_FLAG)
                                + _LEN.pack(len(header)) + header)
                            sock.sendall(view.data[off:off + ln // 2])
                    finally:
                        view.close()
                    return  # outer finally closes the socket mid-frame
            try:
                if msg.get("sg") and ln:
                    # Materialize the chunk BEFORE the header goes out: an
                    # arena view slices for free, a spill-backed view
                    # preads here — and a short pread (eviction racing the
                    # serve) must resolve as a retryable miss, not a
                    # header whose promised payload never follows.
                    try:
                        part = view.data[off:off + ln]
                    except OSError:
                        sock.sendall(pack({"i": rid, "r": 1, "ok": False,
                                           "miss": True}))
                        continue
                    header = msgpack.packb(
                        {"i": rid, "r": 1, "ok": True, "total": total,
                         "off": off, "bl": [ln]}, use_bin_type=True)
                    head = (_LEN.pack((4 + len(header) + ln) | _SG_FLAG)
                            + _LEN.pack(len(header)) + header)
                    sock.sendall(head)
                    # Straight from the pinned arena/pull buffer: the only
                    # user-space touch of the payload on the serve side.
                    sock.sendall(part)
                    if stats is not None:
                        stats["bcast_sg_chunks_served"] += 1
                        stats["bcast_bytes_served"] += ln
                    plane_events.emit(
                        "bcast.chunk.serve", plane="bcast",
                        tenant=plane_events.process_tenant(),
                        off=off, nbytes=ln,
                        oid=bytes(msg.get("oid") or b"").hex()[:12])
                else:
                    try:
                        chunk = bytes(view.data[off:off + ln]) if ln else b""
                    except OSError:
                        sock.sendall(pack({"i": rid, "r": 1, "ok": False,
                                           "miss": True}))
                        continue
                    if stats is not None:
                        stats["bcast_copy_chunks_served"] += 1
                        stats["bcast_bytes_served"] += ln
                    sock.sendall(pack({"i": rid, "r": 1, "ok": True,
                                       "data": chunk, "total": total,
                                       "off": off}))
            finally:
                view.close()
    except OSError:
        pass
    finally:
        try:
            sock.close()
        except OSError:
            pass


def start_serve_thread(host: str, resolve: Callable,
                       name: str = "obj-serve", stats: Optional[dict] = None):
    """Run a chunk-serve socket on dedicated OS threads (one acceptor,
    one blocking-IO thread per connection).

    Serving is memcpy + socket work; on the process's main IO loop it
    competes with exactly the paths a broadcast stresses (the puller's
    recv stripe, the head's control plane), and the asyncio transport
    adds a buffering copy under the GIL. Blocking ``sendall`` from a
    plain thread releases the GIL for the whole kernel copy.

    ``resolve(msg) -> (view|None, miss)`` must be thread-safe (the
    in-repo resolvers are: GIL + the serve lock in StripedPull).
    Returns ``(addr, server_socket)`` — ``(None, None)`` if binding
    failed.
    """
    try:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(128)
    except OSError:
        return None, None
    addr = f"{host}:{srv.getsockname()[1]}"

    def _accept_loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            threading.Thread(
                target=_serve_conn_blocking, args=(conn, resolve, stats),
                daemon=True, name=f"{name}-conn").start()

    threading.Thread(target=_accept_loop, daemon=True, name=name).start()
    return addr, srv


# ------------------------------------------------------------ chunk client


class ChunkClient:
    """Pull-side connection that receives chunk payloads straight into
    the destination buffer.

    Speaks the normal wire format but owns a raw non-blocking socket
    instead of an asyncio StreamReader: an SG reply's raw section is read
    with ``loop.sock_recv_into`` directly into the arena view the caller
    supplies — the kernel's copy into that range is the ONLY receive-side
    copy. Replies on one connection are FIFO (servers handle frames
    sequentially), so a single reader coroutine pairs requests and
    replies in order; a ChunkClient must not be shared by concurrent
    readers.
    """

    __slots__ = ("sock", "loop", "_closed", "_scratch")

    def __init__(self, sock: socket.socket, loop):
        self.sock = sock
        self.loop = loop
        self._closed = False
        self._scratch = None  # drain buffer, allocated on first need

    @classmethod
    async def connect(cls, addr: str, timeout: float = 10.0) -> "ChunkClient":
        loop = asyncio.get_running_loop()
        if addr.startswith("unix:"):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                await asyncio.wait_for(
                    loop.sock_connect(sock, addr[5:]), timeout)
            except BaseException:
                sock.close()
                raise
        else:
            host, _, port = addr.rpartition(":")
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                await asyncio.wait_for(
                    loop.sock_connect(sock, (host, int(port))), timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except BaseException:
                sock.close()
                raise
        return cls(sock, loop)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self.sock.close()
            except OSError:
                pass

    async def send(self, msg: dict) -> None:
        if self._closed:
            raise ConnectionError("chunk connection closed")
        try:
            await self.loop.sock_sendall(self.sock, pack(msg))
        except (OSError, ConnectionError):
            self.close()
            raise ConnectionError("chunk connection send failed")

    async def _recv_into(self, view: memoryview) -> None:
        got = 0
        n = len(view)
        while got < n:
            try:
                k = await self.loop.sock_recv_into(self.sock, view[got:])
            except (OSError, ConnectionError):
                self.close()
                raise ConnectionError("chunk connection read failed")
            if k == 0:
                self.close()
                raise ConnectionError("peer closed mid-frame")
            got += k

    async def _recv_exact(self, n: int) -> bytes:
        b = bytearray(n)
        await self._recv_into(memoryview(b))
        return bytes(b)

    async def _drain(self, n: int) -> None:
        if self._scratch is None:
            self._scratch = bytearray(64 * 1024)
        mv = memoryview(self._scratch)
        while n > 0:
            step = min(n, len(mv))
            await self._recv_into(mv[:step])
            n -= step

    async def read_reply(self, dest: Optional[Callable] = None):
        """Read one reply frame; returns ``(header, bytes_into_dest)``.

        For SG frames, ``dest(header)`` is called once the header is
        parsed and must return a writable memoryview exactly the first
        buffer's length (the payload is received INTO it) or None (the
        payload is drained and discarded). Non-SG frames (errors, legacy
        copy replies) come back as a plain dict with 0 dest bytes.
        """
        (length,) = _LEN.unpack(await self._recv_exact(4))
        sg = length & _SG_FLAG
        length &= ~_SG_FLAG
        if length > MAX_FRAME:
            self.close()
            raise ConnectionError(f"frame too large: {length}")
        if not sg:
            msg = msgpack.unpackb(await self._recv_exact(length), raw=False)
            if not isinstance(msg, dict):
                self.close()
                raise ConnectionError("non-dict chunk reply")
            return msg, 0
        (hlen,) = _LEN.unpack(await self._recv_exact(4))
        if hlen + 4 > length:
            self.close()
            raise ConnectionError("scatter-gather header overruns frame")
        msg = msgpack.unpackb(await self._recv_exact(hlen), raw=False)
        if not isinstance(msg, dict):
            self.close()
            raise ConnectionError("non-dict chunk reply")
        lens = msg.pop("bl", None) or []
        if 4 + hlen + sum(lens) != length:
            self.close()
            raise ConnectionError("scatter-gather length mismatch")
        view = dest(msg) if dest is not None else None
        wrote = 0
        for i, ln in enumerate(lens):
            if i == 0 and view is not None and len(view) == ln:
                await self._recv_into(view)
                wrote = ln
            else:
                await self._drain(ln)
        return msg, wrote


# -------------------------------------------------------------- pull engine


class _Source:
    __slots__ = ("addr", "has", "dead", "task", "cursor", "load",
                 "t_wait", "n_chunks", "avg_s", "pending")

    def __init__(self, addr: str, has: Optional[bytearray], load: int = 0):
        self.addr = addr
        self.has = has  # None = full holder; else chunk bitmap
        self.dead = False
        self.task: Optional[asyncio.Task] = None
        self.cursor = 0
        self.load = load
        self.t_wait = 0.0
        self.n_chunks = 0
        self.avg_s: Optional[float] = None  # EWMA chunk service time
        self.pending = 0  # claims in flight on this source


class StripedPull:
    """Multi-source chunk-striped pull of one object into ``buf``.

    Sources self-pace: each live source runs a coroutine that greedily
    claims the next chunk it can serve and keeps ``window`` requests in
    flight, so fast (lightly loaded) holders naturally carry more of the
    stripe. A failed source's claimed chunks return to the pool and are
    re-fetched from other holders — chunk-granular failover, never an
    object restart. A ``locate`` callback (optional) refreshes the holder
    set mid-pull so partial holders registered by concurrent pullers join
    the stripe; ``report`` (optional) publishes this puller's own
    completed-chunk progress.

    Also the serve-side registry entry for the pulling worker: ``covers``
    answers whether a byte range is fully landed, ``serving`` counts
    in-flight chunk serves out of ``buf`` (an abort must wait for zero).
    """

    def __init__(self, oid_b: bytes, nbytes: int, buf, *,
                 chunk_bytes: int, window: int = 4, max_sources: int = 8,
                 chunk_timeout_s: float = 30.0,
                 refresh_interval_s: float = 0.05,
                 progress_every: int = 4,
                 locate: Optional[Callable] = None,
                 report: Optional[Callable] = None,
                 conn_factory: Optional[Callable] = None,
                 conn_release: Optional[Callable] = None,
                 exclude_addrs=(), rotate: Optional[int] = None,
                 pidx: Optional[int] = None, npull: int = 1):
        self.oid_b = oid_b
        # Short object tag on every chunk event: the stripe-share report
        # groups claim/serve/steal/done rows per (object, source).
        self.oid_hex = bytes(oid_b).hex()[:12]
        self.nbytes = nbytes
        self.buf = buf if isinstance(buf, memoryview) else memoryview(buf)
        self.cs = max(int(chunk_bytes), 1)
        self.nchunks = max(1, (nbytes + self.cs - 1) // self.cs)
        self.window = max(1, int(window))
        self.max_sources = max(1, int(max_sources))
        self.chunk_timeout_s = chunk_timeout_s
        self.refresh_interval_s = refresh_interval_s
        self.progress_every = max(1, int(progress_every))
        self.locate = locate
        self.report = report
        self.conn_factory = (conn_factory if conn_factory is not None
                             else ChunkClient.connect)
        self.conn_release = conn_release
        self.exclude = set(exclude_addrs)
        self.done = bitmap_make(self.nchunks)
        self.ndone = 0
        self.claimed: set = set()
        # Global in-flight ceiling: per-source windows alone would let N
        # sources commit N*window chunks at once — most of the object
        # pinned to whichever source claimed it first, with the endgame
        # dragging on the slowest. Bound total commitment; the endgame
        # steal below re-fetches stragglers from faster sources.
        self.inflight = 0
        self.max_inflight = max(self.window, 3 * self.window // 2 + 4)
        if rotate is None:
            if pidx is not None:
                # Directory-assigned puller ordinal: golden-ratio stagger
                # spreads ANY number of concurrent pullers near-evenly
                # over the chunk ring (low-discrepancy), so their early
                # stripes are disjoint relay fodder. id()-derived offsets
                # cluster often enough that two pullers race the same
                # region and the source serves it twice.
                rotate = int((pidx * 0.6180339887498949 % 1.0)
                             * self.nchunks)
            else:
                rotate = (id(buf) >> 4) % self.nchunks
        start = rotate % self.nchunks
        self.order = list(range(start, self.nchunks)) + list(range(start))
        # Stripe ownership: with npull concurrent pullers, full-holder
        # (source) claims are soft-restricted to ~1/npull of the ring
        # ahead of our stagger offset — the rest is EXPECTED off relays.
        # _relax widens the stripe whenever a source idles with work
        # outstanding (relays not delivering: peers dead, no serve addrs)
        # so hold-back never wedges a pull.
        self.npull = max(1, int(npull))
        self.pidx = pidx  # directory-assigned puller ordinal (events tag)
        # Broadcast ramp: a directory-registered puller (pidx assigned)
        # that locates FIRST sees npull=1 — the directory can't know the
        # fan-out that is still arriving — and an unrestricted width lets
        # it commit the whole ring against the source before the first
        # refresh lands. Until a refresh confirms the real puller count,
        # width is computed against a minimum fan-out prior; a genuinely
        # solo pull loses only one refresh interval of full width, a
        # broadcast keeps its early stripes disjoint (the relay fodder).
        self._npull_prior = 4 if pidx is not None else 1
        self._npull_seen = False
        self._relax = 0
        self._idle_nd = -1
        self._idle_t0 = _perf_counter()
        self.sources: Dict[str, _Source] = {}
        self.src_bytes: Dict[str, int] = {}
        self._pending_report: List[int] = []
        self._done_ev: Optional[asyncio.Event] = None
        self.failed = False
        self.serving = 0  # chunk serves in flight out of buf (abort gate)
        self._closed_for_serve = False
        self._on_drained: Optional[Callable] = None
        # Serves may run on a dedicated serve thread while the pull runs
        # on the IO loop: the counter needs real mutual exclusion (+= on
        # an attribute is not atomic across threads).
        self._serve_lock = threading.Lock()
        self.fetches = 0
        self.retries = 0

    # ---------------------------------------------------- serve-side API

    def covers(self, off: int, length: int) -> bool:
        """Is [off, off+length) fully landed (serveable to a peer)?"""
        if off < 0 or length <= 0 or off + length > self.nbytes:
            return False
        first = off // self.cs
        last = (off + length - 1) // self.cs
        for i in range(first, last + 1):
            if not bitmap_test(self.done, i):
                return False
        return True

    def _serve_done(self):
        cb = None
        with self._serve_lock:
            self.serving -= 1
            if self.serving <= 0 and self._on_drained is not None:
                cb, self._on_drained = self._on_drained, None
        if cb is not None:
            cb()

    def serve_view(self, off: int, length: int) -> Optional[ServeView]:
        """A pinned view over the whole buffer if the range is landed.

        Safe from a serve thread: the done bit for a chunk is set (under
        the GIL) only AFTER its bytes landed, so a covers()=True read
        from another thread implies the data is visible."""
        if not self.covers(off, length):
            return None
        with self._serve_lock:
            if self._closed_for_serve:
                return None
            self.serving += 1
        return ServeView(self.buf[:self.nbytes], self._serve_done)

    def close_for_serve(self, on_drained: Callable) -> None:
        """Refuse new serves and run ``on_drained`` once no chunk serve
        aliases ``buf`` any more (immediately when none is in flight).
        The abort path's gate: a serve that raced past ``covers()`` but
        has not yet pinned would otherwise read a recycled buffer and
        ship another object's bytes; taking the same lock as
        ``serve_view`` makes refuse-or-count atomic."""
        with self._serve_lock:
            self._closed_for_serve = True
            if self.serving > 0:
                self._on_drained = on_drained
                return
        on_drained()

    # -------------------------------------------------------- scheduling

    def _src_window(self, src: _Source) -> int:
        """Effective claim window for one source.

        Self-pacing alone is not enough when sources differ widely in
        service time: a slow source with a full window holds claims that
        FASTER (often relay) sources could have carried, and the pull
        serializes on the stragglers. Sources measured well off the pace
        of the fastest live source keep only a shallow pipeline; a lone
        source always gets the full window."""
        live = [s for s in self.sources.values() if not s.dead]
        if len(live) <= 1 or src.avg_s is None:
            return self.window
        best = min((s.avg_s for s in live if s.avg_s is not None),
                   default=None)
        if best is not None and src.avg_s > 3.0 * best:
            return max(2, self.window // 4)
        return self.window

    def _claim(self, src: _Source, own=()) -> Optional[int]:
        n = self.nchunks
        order = self.order
        relays = None
        if src.has is None:
            # Full holder (the broadcast's contended resource): prefer
            # chunks no partial holder can relay — its egress goes to
            # chunks only it has, the relayable ones come off the peers
            # (rarest-first, cheap version). A relay-covered chunk comes
            # back to the full holder only when every live relay that has
            # it is saturated (window full) — an idle relay WILL claim it
            # on its next loop pass, and leaving it there is what turns
            # the source from N full transfers into ~one.
            relays = [s for s in self.sources.values()
                      if not s.dead and s.has is not None]
        # Full-holder stripe: claim from the source only the first
        # ~nchunks/npull positions of OUR rotation (+ pipeline margin) —
        # the rest of the ring belongs to other pullers' stripes and is
        # relayed off them once their progress reports land. This is what
        # turns N concurrent pulls into ~one source egress: without it
        # the source endpoints win every claim race long before peer
        # coverage reaches the directory.
        width = n
        npull = self.npull if self._npull_seen \
            else max(self.npull, self._npull_prior)
        if relays is not None and npull > 1:
            width = min(n, (n + npull - 1) // npull
                        + max(2, self.window // 2) + self._relax)
        fallback = None
        for step in range(n):
            pos = (src.cursor + step) % n
            i = order[pos]
            if i in self.claimed or bitmap_test(self.done, i):
                continue
            if src.has is not None and not bitmap_test(src.has, i):
                continue
            if pos >= width:
                continue
            if relays:
                covering = [s for s in relays if bitmap_test(s.has, i)]
                if covering:
                    if fallback is None and not any(
                            s.pending < self.window for s in covering):
                        fallback = (i, step)
                    continue
            src.cursor = (src.cursor + step + 1) % n
            self.claimed.add(i)
            plane_events.emit("bcast.chunk.claim", plane="bcast",
                              tenant=plane_events.process_tenant(),
                              src=src.addr, idx=i, pidx=self.pidx,
                              oid=self.oid_hex)
            return i
        if fallback is not None:
            i, step = fallback
            src.cursor = (src.cursor + step + 1) % n
            self.claimed.add(i)
            plane_events.emit("bcast.chunk.claim", plane="bcast",
                              tenant=plane_events.process_tenant(),
                              src=src.addr, idx=i, pidx=self.pidx,
                              oid=self.oid_hex)
            return i
        # Endgame steal: every remaining chunk is claimed by some OTHER
        # source — duplicate-fetch one of them rather than idle behind a
        # slow straggler (completion is idempotent; at most a few
        # duplicate chunks of waste, bounded by the steal window).
        remaining = self.nchunks - self.ndone
        if 0 < remaining <= max(2, 2 * len(self.live_addrs())):
            for i in range(n):
                if bitmap_test(self.done, i) or i in own:
                    continue
                if src.has is not None and not bitmap_test(src.has, i):
                    continue
                plane_events.emit("bcast.chunk.steal", plane="bcast",
                                  tenant=plane_events.process_tenant(),
                                  src=src.addr, idx=i, pidx=self.pidx,
                                  oid=self.oid_hex)
                return i
        return None

    def _note_idle(self, src: _Source):
        """A FULL holder idling under the stripe restriction while the
        pull as a whole makes NO progress: widen the stripe — the relays
        those chunks were saved for are not delivering (peers died, never
        advertised, stalled). While anything is landing, stay held back;
        the hold-back is a bandwidth policy, never a liveness hazard."""
        if src.has is not None or self.npull <= 1 or self.ndone >= self.nchunks:
            return
        now = _perf_counter()
        if self.ndone != self._idle_nd:
            self._idle_nd = self.ndone
            self._idle_t0 = now
            return
        if now - self._idle_t0 >= 0.05:
            self._idle_t0 = now
            self._relax += self.window

    def _unclaim(self, idx: int):
        self.claimed.discard(idx)
        self.retries += 1

    def _complete(self, idx: int, addr: str, nb: int):
        self.claimed.discard(idx)
        if not bitmap_test(self.done, idx):
            bitmap_set(self.done, idx)
            self.ndone += 1
            self.src_bytes[addr] = self.src_bytes.get(addr, 0) + nb
            self._pending_report.append(idx)
            # The FIRST landed chunk is reported immediately: it is what
            # registers this puller as a partial holder at all, and in a
            # simultaneous fan-out the relay mesh only forms as fast as
            # the first advertisements reach the directory.
            if self.report is not None and (
                    self.ndone == 1
                    or len(self._pending_report) >= self.progress_every
                    or self.ndone >= self.nchunks):
                idxs, self._pending_report = self._pending_report, []
                try:
                    self.report(idxs)
                except Exception:
                    pass
        if self.ndone >= self.nchunks and self._done_ev is not None:
            self._done_ev.set()

    def live_addrs(self) -> List[str]:
        return [a for a, s in self.sources.items() if not s.dead]

    def _note_source_dead(self):
        if (self.locate is None and self.ndone < self.nchunks
                and not self.live_addrs()):
            # No directory to discover replacements from: fail now.
            self.failed = True
            if self._done_ev is not None:
                self._done_ev.set()

    def _admit_sources(self, loc: dict) -> int:
        """Merge a directory reply into the source set; returns how many
        NEW sources were admitted (lowest advertised load first)."""
        npull = int(loc.get("npull") or 0)
        if npull > 0:
            self.npull = npull
        cands = []
        loads = loc.get("loads") or {}
        for addr in loc.get("addrs") or []:
            if addr in self.exclude or addr in self.sources:
                continue
            cands.append((int(loads.get(addr, 0)), addr, None))
        for item in loc.get("partial") or []:
            addr, bm, cs, load = item[0], item[1], item[2], item[3]
            if addr in self.exclude or cs != self.cs:
                continue
            src = self.sources.get(addr)
            if src is not None:
                # Known partial holder: fold in its newly-landed chunks.
                if src.has is not None and bm:
                    has = src.has
                    for j, byte in enumerate(bytearray(bm)[:len(has)]):
                        has[j] |= byte
                continue
            cands.append((int(load), addr, bytearray(bm)))
        added = 0
        live = len(self.live_addrs())
        for load, addr, has in sorted(cands, key=lambda c: c[0]):
            if live + added >= self.max_sources:
                break
            src = self.sources[addr] = _Source(addr, has, load)
            src.task = asyncio.ensure_future(self._source_loop(src))
            added += 1
        return added

    # --------------------------------------------------------- coroutines

    async def _source_loop(self, src: _Source):
        addr = src.addr
        client = None
        healthy = True
        inflight: deque = deque()
        try:
            client = await self.conn_factory(addr)
            while True:
                if self.ndone >= self.nchunks and not inflight:
                    break
                if self.failed:
                    break
                while (len(inflight) < self._src_window(src)
                       and self.inflight < self.max_inflight):
                    idx = self._claim(src, own=inflight)
                    if idx is None:
                        break
                    off = idx * self.cs
                    ln = min(self.cs, self.nbytes - off)
                    self.fetches += 1
                    # Account BEFORE the send await: the teardown paths
                    # below roll back exactly what is in ``inflight``, so
                    # a send that dies mid-write must find its claim there
                    # (or the chunk stays claimed-by-nobody forever).
                    self.inflight += 1
                    inflight.append(idx)
                    src.pending = len(inflight)
                    _set_inflight(src.pending, src=addr)
                    await client.send({
                        "t": "obj_fetch", "oid": self.oid_b, "off": off,
                        "len": ln, "nbytes": self.nbytes, "sg": 1,
                        "i": self.fetches})
                if not inflight:
                    if self.ndone >= self.nchunks or self.failed:
                        break
                    # Nothing claimable right now (other sources hold the
                    # remaining chunks, or this partial holder is waiting
                    # for a bitmap refresh): idle briefly.
                    self._note_idle(src)
                    await asyncio.sleep(0.01)
                    continue
                idx = inflight.popleft()
                self.inflight -= 1
                src.pending = len(inflight)
                _set_inflight(src.pending, src=addr)
                off = idx * self.cs
                want = min(self.cs, self.nbytes - off)

                def dest(hdr, off=off, want=want):
                    if not hdr.get("ok") or hdr.get("off") != off:
                        return None
                    return self.buf[off:off + want]

                _t0 = _perf_counter()
                try:
                    hdr, wrote = await asyncio.wait_for(
                        client.read_reply(dest), self.chunk_timeout_s)
                except BaseException:
                    # The popped claim is no longer in ``inflight``; hand
                    # it back explicitly before the source tears down.
                    self._unclaim(idx)
                    raise
                _dt = _perf_counter() - _t0
                src.t_wait += _dt
                src.n_chunks += 1
                src.avg_s = (_dt if src.avg_s is None
                             else 0.6 * src.avg_s + 0.4 * _dt)
                if hdr.get("ok") and hdr.get("total") == self.nbytes:
                    if wrote == want:
                        plane_events.emit(
                            "bcast.chunk.done", plane="bcast", dur=_dt,
                            src=addr, idx=idx, nbytes=want,
                            pidx=self.pidx, oid=self.oid_hex)
                        self._complete(idx, addr, want)
                        continue
                    data = hdr.get("data")  # legacy copy reply
                    if (data is not None and len(data) == want
                            and hdr.get("off", off) == off):
                        self.buf[off:off + want] = data
                        self._complete(idx, addr, want)
                        continue
                self._unclaim(idx)
                if hdr.get("miss"):
                    # Partial holder hasn't landed this chunk (stale
                    # directory bitmap): stop asking it for this chunk,
                    # keep the source for the chunks it does have.
                    if src.has is not None:
                        bitmap_clear(src.has, idx)
                    continue
                raise ConnectionError(f"bad chunk reply from {addr}")
        except asyncio.CancelledError:
            healthy = False
            self.inflight -= len(inflight)
            src.pending = 0
            for i in inflight:
                self._unclaim(i)
            raise
        except (ConnectionError, OSError, asyncio.TimeoutError,
                asyncio.IncompleteReadError, ValueError):
            healthy = False
            src.dead = True
            self.inflight -= len(inflight)
            src.pending = 0
            for i in inflight:
                self._unclaim(i)
            self._note_source_dead()
        finally:
            if client is not None:
                if self.conn_release is not None:
                    self.conn_release(addr, client,
                                      healthy and not client.closed)
                else:
                    client.close()

    async def _refresh_loop(self):
        stall = 0
        # First re-locate comes early: concurrent pullers advertise their
        # first landed chunks within a chunk service time or two, and a
        # puller that keeps hammering the full holders for a whole
        # refresh interval has already pulled much of a small object.
        delay = min(0.02, self.refresh_interval_s)
        while self._done_ev is not None and not self._done_ev.is_set():
            await asyncio.sleep(delay)
            delay = self.refresh_interval_s
            if self._done_ev.is_set():
                return
            if self.locate is None:
                return
            loc = None
            try:
                loc = await self.locate()
            except Exception:
                loc = None
            if loc:
                # The directory has now seen every concurrent
                # registration that beat this refresh: its npull is
                # authoritative, the broadcast ramp prior retires.
                self._npull_seen = True
            added = self._admit_sources(loc) if loc else 0
            if not self.live_addrs() and self.ndone < self.nchunks:
                stall = 0 if added else stall + 1
                if stall >= 3:
                    self.failed = True
                    self._done_ev.set()
                    return
            else:
                stall = 0

    async def run(self, loc: Optional[dict] = None) -> bool:
        """Pull until every chunk landed; returns success."""
        self._done_ev = asyncio.Event()
        if loc:
            self._admit_sources(loc)
        if not self.sources and self.locate is None:
            return False
        refresher = asyncio.ensure_future(self._refresh_loop())
        try:
            await self._done_ev.wait()
        finally:
            refresher.cancel()
            tasks = [s.task for s in self.sources.values()
                     if s.task is not None and not s.task.done()]
            if tasks:
                # Natural wind-down first (sources break when no work is
                # left), then cancel stragglers.
                await asyncio.wait(tasks, timeout=0.25)
                for t in tasks:
                    if not t.done():
                        t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
            await asyncio.gather(refresher, return_exceptions=True)
        return self.ndone >= self.nchunks
