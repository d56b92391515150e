"""Client-side runtime shared by drivers and worker processes.

This is the analog of the reference's ``CoreWorker``
(``src/ray/core_worker/core_worker.h:271``) + the Python driver glue
(``python/ray/_private/worker.py``): object put/get/wait, task submission,
actor calls, and reference counting. The C++ reference splits owner-side
bookkeeping (TaskManager, ReferenceCounter) from the Python frontend; here
both live in one class running an asyncio IO thread, with direct
worker-to-worker connections for actor calls (the reference's
``ActorTaskSubmitter`` direct gRPC path, ``transport/actor_task_submitter.h:75``).
"""

from __future__ import annotations

import asyncio
import os
import threading
import time
from collections import deque
from concurrent.futures import Future as SyncFuture
from concurrent.futures import TimeoutError as SyncTimeoutError
from typing import Any, Dict, List, Optional, Tuple

from . import failpoints, protocol, serialization
from .ids import ActorID, ObjectID, TaskID, WorkerID, _Counter
from .object_store import make_store
from .serialization import (
    ActorDiedError,
    GetTimeoutError,
    TaskError,
    deserialize,
    serialize,
)

_global_worker: Optional["Worker"] = None


def global_worker() -> "Worker":
    if _global_worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first.")
    return _global_worker


def set_global_worker(w: Optional["Worker"]):
    global _global_worker
    _global_worker = w


class ObjectRef:
    """A reference to an eventually-available remote value.

    Analog of the reference's ``ObjectRef`` (``python/ray/_raylet.pyx`` +
    ``reference_count.h:64``): hashable, serializable (with borrower
    incref at pickling time), awaitable via ``get``.
    """

    __slots__ = ("id", "_worker", "__weakref__")

    def __init__(self, object_id: ObjectID, worker: Optional["Worker"] = None,
                 *, borrowed: bool = False):
        self.id = object_id
        self._worker = worker if worker is not None else _global_worker
        if self._worker is not None:
            self._worker.note_ref_live(object_id, +1)
            if borrowed:
                self._worker.queue_ref_delta(object_id, +1)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def task_id(self) -> TaskID:
        return self.id.task_id()

    def future(self) -> SyncFuture:
        """Public bridge to a real ``concurrent.futures.Future`` (usable
        with ``asyncio.wrap_future`` / ``concurrent.futures.wait``); the
        internal resolution path runs on SlimFuture."""
        fut = self._worker.object_future(self.id)
        out = SyncFuture()

        def _copy(f, out=out):
            if out.set_running_or_notify_cancel():
                exc = f.exception()
                if exc is not None:
                    out.set_exception(exc)
                else:
                    out.set_result(f._value)

        fut.add_done_callback(_copy)
        return out

    def __reduce__(self):
        # A serialized ref must be resolvable by the receiver: values held
        # only in this process's memory store are promoted to the GCS
        # first. The borrow incref happens HERE on the sender (sent
        # immediately, ahead of any message carrying the ref) — a
        # receiver-side incref would leave a window where the owner drops
        # its last ref and the object is evicted in transit. The
        # receiver's wrapper queues the matching -1 when it dies.
        if self._worker is not None:
            self._worker.promote_on_serialize(self.id)
            self._worker.send_ref_incref_now(self.id)
            # Balance this +1 if serialize() retries with cloudpickle
            # after a failed stdlib attempt (serialization._REDUCE_LEDGER).
            serialization.note_reduce_undo(
                lambda w=self._worker, oid=self.id:
                    w.send_ref_decref_now(oid))
        return (_deserialize_object_ref, (self.id.binary(),))

    def __del__(self):
        w = self._worker
        if w is not None and not w.closed:
            w.note_ref_live(self.id, -1)
            w.queue_ref_delta(self.id, -1)

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __await__(self):
        return self._await_impl().__await__()

    async def _await_impl(self):
        fut = self.future()
        where, payload = await asyncio.wrap_future(fut)
        return self._worker._resolve_value(self.id, where, payload)


def _deserialize_object_ref(id_bytes: bytes) -> ObjectRef:
    # borrowed=False: the SENDER already sent this copy's +1 at pickle
    # time (ObjectRef.__reduce__); this wrapper's __del__ sends the -1.
    return ObjectRef(ObjectID(id_bytes), borrowed=False)


class ObjectRefGenerator:
    """Iterable of a dynamic-returns task's per-item refs (reference:
    ``ObjectRefGenerator``, ``_raylet.pyx:281`` — ``num_returns="dynamic"``
    tasks resolve to one of these; iterate and ``get`` each ref)."""

    def __init__(self, refs):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self):
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]



_SLIM_EVENT_LOCK = threading.Lock()


class SlimFuture:
    """Single-waiter future for the object-resolution path.

    ``concurrent.futures.Future`` allocates a ``Condition`` (lock + waiter
    list) per instance — measurable at benchmark rates, since EVERY task
    return and actor call allocates one (PROFILE_nn_r05). The driver's
    dominant access pattern is one producer (IO loop) and at most one
    blocked consumer (``get``), so this slim variant defers its
    ``threading.Event`` until someone actually blocks; the sequential-get
    fast path (result already set when ``get`` arrives) never allocates
    any synchronization object at all.

    Thread-safety leans on the GIL plus write ordering: the producer
    stores value/exception BEFORE flipping ``_done``; consumers re-check
    ``_done`` after publishing their event/callback, so a completion
    racing either registration is never lost (both sides drain callbacks
    via an atomic list swap, so each callback runs exactly once).
    """

    __slots__ = ("_done", "_value", "_exc", "_event", "_cbs")

    def __init__(self):
        self._done = False
        self._value = None
        self._exc = None
        self._event = None
        self._cbs = None

    def done(self) -> bool:
        return self._done

    def set_result(self, value):
        self._value = value
        self._finish()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._finish()

    def _finish(self):
        self._done = True
        ev = self._event
        if ev is not None:
            ev.set()
        self._drain_cbs()

    def _drain_cbs(self):
        with _SLIM_EVENT_LOCK:
            cbs, self._cbs = self._cbs, None
        if cbs:
            for cb in cbs:
                try:
                    cb(self)
                except Exception:
                    pass

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            with _SLIM_EVENT_LOCK:
                # Cold path only (a consumer actually blocking): the
                # shared lock serializes concurrent waiters creating the
                # event, so none can strand on an overwritten one.
                ev = self._event
                if ev is None:
                    ev = self._event = threading.Event()
            if self._done:  # completed while publishing the event
                ev.set()
            if not ev.wait(timeout):
                raise TimeoutError()
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: Optional[float] = None):
        if not self._done:
            try:
                self.result(timeout)
            except Exception:
                pass  # a stored exception is RETURNED, never raised here
            # KeyboardInterrupt/SystemExit propagate (interruptibility,
            # matching concurrent.futures.Future.exception()).
            if not self._done:
                raise TimeoutError()
        return self._exc

    def add_done_callback(self, fn):
        if self._done:
            fn(self)
            return
        # The shared lock makes registration atomic against the
        # producer's _drain_cbs swap — without it an append can land in
        # an already-detached (drained) list and the callback is lost.
        with _SLIM_EVENT_LOCK:
            if not self._done:
                if self._cbs is None:
                    self._cbs = []
                self._cbs.append(fn)
                return
        fn(self)  # completed while acquiring: run inline, like done()

    def remove_done_callback(self, fn):
        """Best-effort deregistration (wait() detaches its wakers so a
        polling loop doesn't accumulate dead callbacks per call)."""
        with _SLIM_EVENT_LOCK:
            if self._cbs is not None:
                try:
                    self._cbs.remove(fn)
                except ValueError:
                    pass


class _Lease:
    """A worker leased to this process for one scheduling class."""

    __slots__ = ("wid", "addr", "conn", "busy", "dead", "idle_handle",
                 "gpus")

    def __init__(self, wid: bytes, addr: str, gpus=None):
        self.wid = wid
        self.addr = addr
        self.gpus = gpus  # GPU ids the GCS pinned the worker to
        self.conn: Optional[protocol.Connection] = None
        self.busy = 0
        self.dead = False
        self.idle_handle = None


class _TaskClass:
    """Driver-side state for one scheduling class: pending queue + leases.

    The analog of the reference's per-scheduling-class lease pools in
    ``NormalTaskSubmitter`` (``transport/normal_task_submitter.h:74,108``):
    tasks of a class share leased workers; tasks are pushed directly to
    the leased worker and the lease is reused until the queue drains.
    """

    __slots__ = ("key", "wire", "queue", "leases", "demand", "avg_s")

    def __init__(self, key: str, wire: dict):
        self.key = key
        self.wire = wire  # res/sched/pg/bix for lease_req
        self.queue: deque = deque()  # _TaskItem
        self.leases: Dict[bytes, _Lease] = {}
        self.demand = 0  # leases requested but not yet granted
        # EWMA of observed task duration: the adaptive pipeline window
        # only deepens for classes whose tasks are measured FAST (deep
        # commitment behind a slow task would defeat load balancing).
        self.avg_s: Optional[float] = None


class _TaskItem:
    __slots__ = ("msg", "oids", "retries", "cancelled", "name", "created",
                 "deps_left", "args_pins")

    def __init__(self, msg: dict, oids: List[ObjectID], retries: int,
                 name: str):
        self.msg = msg
        self.oids = oids
        self.retries = retries
        self.cancelled = False
        self.name = name
        self.created = time.time()
        self.deps_left = 0
        # Reasons the task's arg bundle must stay alive: one pin for the
        # in-flight execution (held through retries/resubmissions until a
        # terminal disposition) plus one per retained lineage spec. The
        # bundle releases when the count reaches zero — never while a
        # reconstruction resubmission is in flight or any spec remains.
        self.args_pins = 1


# In-flight pipeline depth per leased worker: >1 overlaps the push/reply
# hop with execution (flags in _private/config.py: RAY_TPU_TORCH_LEASE_WINDOW,
# RAY_TPU_TORCH_MAX_LEASES_PER_CLASS, RAY_TPU_TORCH_LEASE_IDLE_RETURN_S). Snapshotted
# into constants for the hot loops; the refresh hook re-snapshots when
# ``init(_system_config=...)`` overrides flags post-import.
from .config import config as _cfg, on_config_change as _on_cfg_change

_LEASE_WINDOW = _cfg().lease_window
_LEASE_WINDOW_MAX = _cfg().lease_window_max
_MAX_LEASES_PER_CLASS = _cfg().max_leases_per_class
_LEASE_IDLE_RETURN_S = _cfg().lease_idle_return_s


def _refresh_flags():
    global _LEASE_WINDOW, _LEASE_WINDOW_MAX, _MAX_LEASES_PER_CLASS, \
        _LEASE_IDLE_RETURN_S
    _LEASE_WINDOW = _cfg().lease_window
    _LEASE_WINDOW_MAX = _cfg().lease_window_max
    _MAX_LEASES_PER_CLASS = _cfg().max_leases_per_class
    _LEASE_IDLE_RETURN_S = _cfg().lease_idle_return_s
    Worker._PULL_CHUNK = _cfg().pull_chunk_bytes
    Worker._PULL_WINDOW = _cfg().pull_window


_on_cfg_change(_refresh_flags)


def pull_deadline_s(nbytes: int) -> float:
    """Whole-pull deadline, scaled by object size: a flat cap either
    aborts multi-GB pulls on slow links or lets tiny pulls hang for
    minutes — base covers control latency, the size term covers the
    transfer at the assumed worst-case bandwidth."""
    c = _cfg()
    return c.pull_timeout_base_s + nbytes / max(c.pull_min_bandwidth, 1)


def chunk_timeout_s(chunk_bytes: int, window: int) -> float:
    """Per-chunk reply deadline: a full window of chunks may be queued
    ahead of the one being awaited, so the budget covers the whole
    window's bytes at worst-case bandwidth (x4 slack)."""
    c = _cfg()
    return max(c.pull_chunk_timeout_floor_s,
               4.0 * max(window, 1) * chunk_bytes
               / max(c.pull_min_bandwidth, 1))


class _ActorChannel:
    """Per-actor direct connection plus its FIFO submission queue.

    The reference keeps per-actor ordered queues in ``ActorTaskSubmitter``
    (``transport/actor_task_submitter.h:75``); here the queue holds calls
    made before the direct connection is up — once established, calls are
    sent synchronously from the IO loop in submission order.
    """

    __slots__ = ("conn", "sendq", "connecting", "addr")

    def __init__(self):
        self.conn: Optional[protocol.Connection] = None
        self.sendq: deque = deque()
        self.connecting = False
        self.addr: Optional[str] = None


class Worker:
    """Per-process runtime: IO thread + GCS connection + object store."""

    def __init__(self, role: str = "driver"):
        self.role = role
        self.worker_id = WorkerID.from_random()
        self.namespace = "default"
        # Admission-control state pushed by the GCS (backpressure frames):
        # while True, lease growth pauses; existing leases keep draining.
        self._gcs_backpressured = False
        self.closed = False
        self.client_mode = False
        self.session_name: Optional[str] = None
        self.session_dir: Optional[str] = None
        self.node_id: Optional[bytes] = None
        self.gcs: Optional[protocol.Connection] = None
        self._store_obj = None
        self._store_factory = None  # lazy open (see `store` property)
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._put_counter = _Counter()
        # oid -> SlimFuture resolving to ("inline", bytes) | ("shm", nbytes)
        self._object_futures: Dict[ObjectID, "SlimFuture"] = {}
        self._memory_store: Dict[ObjectID, bytes] = {}
        self._ref_deltas: Dict[ObjectID, int] = {}
        # Count-only corrections (failed-serialize incref undos queued
        # while the GCS link was down): flushed with _ref_deltas but NEVER
        # treated as local ref releases (no lineage-spec drop).
        self._pure_deltas: Dict[ObjectID, int] = {}
        # Net live local refs per object — the resync payload that rebuilds
        # GCS refcounts after a control-plane restart.
        self._live_refs: Dict[ObjectID, int] = {}
        # Actor id -> ctor arg-bundle ObjectID (>INLINE_THRESHOLD ctor
        # args); released when the actor is PERMANENTLY dead (restarts
        # resend the same creation msg, so the bundle must outlive them).
        self._actor_ctor_args: Dict[ActorID, ObjectID] = {}
        self._ref_lock = threading.Lock()
        self._actor_chans: Dict[ActorID, _ActorChannel] = {}
        self._dead_actors: Dict[ActorID, str] = {}
        # P2P pull-connection cache: addr -> idle ChunkClients. A client
        # is checked OUT for the duration of one pull's source stripe
        # (FIFO reply pairing forbids sharing), checked back in healthy,
        # and evicted on node-DEAD/DRAINING pushes or when the cache
        # exceeds ``max_peer_conns``.
        self._peer_conns: Dict[str, list] = {}
        # In-progress pulls serveable to peers: oid -> StripedPull engine
        # (chunk-level holder registration — we serve chunks we already
        # hold while the rest are still arriving).
        self._partials: Dict[ObjectID, Any] = {}
        # Concurrent-get coalescing: oid -> in-flight pull future.
        self._pull_lock = threading.Lock()
        self._pull_inflight: Dict[ObjectID, "SlimFuture"] = {}
        # Batched reference plane: unresolved ids parked for the next
        # coalesced obj_waits subscribe (one frame per burst, not per ref).
        self._wait_lock = threading.Lock()
        self._wait_buf: List[ObjectID] = []
        self._wait_flush_scheduled = False
        # Where peers can fetch our partial chunks (worker_main sets this
        # to the worker's listening socket; drivers don't serve).
        self.serve_addr: Optional[str] = None
        # Outbound message queue: producer threads enqueue, a single loop
        # wakeup drains the burst (write coalescing in protocol.Connection
        # then collapses the burst into one syscall).
        self._out_q: deque = deque()
        self._out_lock = threading.Lock()
        self._drain_scheduled = False  # a _drain_out wakeup is pending
        # Direct task path (worker leases).
        self._task_classes: Dict[str, _TaskClass] = {}
        self._leases_by_wid: Dict[bytes, tuple] = {}  # wid -> (cls, lease)
        self._inflight: Dict[bytes, tuple] = {}  # tid -> (cls, lease, item)
        self._task_specs: Dict[bytes, tuple] = {}  # oid -> (key, wire, item)
        self._task_notes: deque = deque()
        self._registered_inline: set = set()
        self._promote_pending: set = set()
        # Durable-export shadow: (ns, key) -> blob for function/class
        # exports this process kv_put into the GCS. A GCS that crashed
        # BEFORE WAL-appending an export loses it durably, and the
        # exporters' session-level "already registered" caches would
        # never re-send — the resync replays this shadow (chaos-found,
        # bounded: export blobs only, not user KV).
        self._kv_exports: Dict[tuple, bytes] = {}
        self._flusher_handle = None

    @property
    def store(self):
        """Host shm store, opened on FIRST USE. Worker boot sets only a
        factory: actors that never touch the object plane (the common
        launch-storm case) skip the arena open + mmap (~5 ms CPU each,
        material when hundreds of workers start on a small host).
        Lock-guarded: first use can race between executor pool threads,
        and a double-open would leak an arena mapping."""
        s = self._store_obj
        if s is None and self._store_factory is not None:
            with self._ref_lock:
                s = self._store_obj
                if s is None:
                    s = self._store_obj = self._store_factory()
        return s

    @store.setter
    def store(self, value):
        self._store_obj = value

    # ------------------------------------------------------------ lifecycle

    def connect(self, gcs_address: str,
                loop: Optional[asyncio.AbstractEventLoop] = None,
                node_id: Optional[bytes] = None,
                client_mode: bool = False):
        """Connect to the GCS. If ``loop`` is None an IO thread is started.

        ``client_mode`` is the ``ray://`` remote-driver path (reference:
        Ray Client, ``python/ray/util/client/``): this process does NOT
        share a host shm store with any cluster node, so it uses a private
        store namespace and every non-inline object moves through the GCS
        object-transfer relay (obj_pull / obj_upload).
        """
        self.gcs_address = gcs_address
        self.node_id = node_id
        self.client_mode = client_mode
        if loop is None:
            self.loop = asyncio.new_event_loop()
            self._loop_thread = threading.Thread(
                target=self._run_loop, name="ray_tpu_torch-io", daemon=True)
            self._loop_thread.start()
        else:
            self.loop = loop
        # A fresh session's GCS KV has no defexports: drop tokens cached
        # against a previous cluster (notebook re-init case).
        serialization.reset_export_cache()
        hello = self.run_async(self._connect_async(gcs_address))
        self.session_name = hello["session"]
        self.session_dir = hello["session_dir"]
        store_ns = self.session_name
        if client_mode:
            store_ns = f"{self.session_name}-c{self.worker_id.hex()[:8]}"
        self.store = make_store(store_ns)
        if self.role == "driver":
            # Export the driver's import path so workers can unpickle
            # functions defined in driver-side modules (the reference ships
            # the working_dir / py_modules runtime env for this; same-host
            # workers just need the path list).
            import json
            import sys

            paths = [os.getcwd()] + [p for p in sys.path if p]
            blob = json.dumps(paths).encode()
            self.kv_put("driver_sys_path", blob)
            # Replayed on GCS-restart resync like the code exports: a
            # crash that loses this key's WAL append would otherwise
            # leave workers unable to unpickle driver-module functions.
            self.note_export("", "driver_sys_path", blob)
            # Driver-side plane events (broadcast pulls, serve handles)
            # flush on the metrics tick — start it with the session, not
            # on first Metric creation (a driver may emit events without
            # ever declaring a metric). Also restart it when metrics
            # from a PREVIOUS session in this process exist: disconnect
            # joins the flusher, and those Metric objects never re-call
            # _ensure_flusher — without this, a reinit with the recorder
            # disabled would silently stop flushing them.
            from ray_tpu_torch.util import events as _events
            from ray_tpu_torch.util import metrics as _metrics

            if _events.enabled() or _metrics._registry:
                _metrics._ensure_flusher()
        return hello

    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run_async(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the IO loop from any thread and wait."""
        if (threading.current_thread() is self._loop_thread):
            raise RuntimeError("run_async called from the IO thread")
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    async def _connect_async(self, gcs_address: str) -> dict:
        reader, writer = await protocol.connect(gcs_address)
        self.gcs = protocol.Connection(
            reader, writer, handler=self._on_gcs_push,
            on_close=self._on_gcs_close)
        self.gcs.start()
        hello = {
            "t": "hello", "role": self.role,
            "worker_id": self.worker_id.binary(),
            "pid": os.getpid(),
            # Tenant identity: quotas and named-actor isolation key on
            # the namespace this driver connected under.
            "namespace": getattr(self, "namespace", "default"),
        }
        if self.node_id is not None:
            hello["node_id"] = self.node_id
        reply = await self.gcs.request(hello, timeout=30)
        self._gcs_epoch = reply.get("epoch")
        self._flusher_handle = self.loop.call_later(0.1, self._flush_refs_cb)
        return reply

    def _on_gcs_close(self):
        if self.closed:
            return
        # The control plane may be restarting (GCS fault tolerance,
        # reference: test_gcs_fault_tolerance.py driver reconnect): retry
        # before failing the world. Workers spawned by worker_main manage
        # their own reconnect; this path serves drivers and ray:// clients.
        self.loop.create_task(self._reconnect_gcs())

    async def _reconnect_gcs(self):
        async def attempt():
            reader, writer = await protocol.connect(self.gcs_address)
            conn = protocol.Connection(
                reader, writer, handler=self._on_gcs_push,
                on_close=self._on_gcs_close)
            conn.start()
            try:
                reply = await conn.request({
                    "t": "hello", "role": self.role,
                    "worker_id": self.worker_id.binary(),
                    "pid": os.getpid(),
                    "namespace": getattr(self, "namespace", "default"),
                    **({"node_id": self.node_id}
                       if self.node_id is not None else {}),
                }, timeout=30)
            except (ConnectionError, asyncio.TimeoutError):
                await conn.close()
                raise
            self.gcs = conn
            new_epoch = reply.get("epoch")
            restarted = new_epoch != getattr(self, "_gcs_epoch", None)
            self._gcs_epoch = new_epoch
            self._resync_after_reconnect(gcs_restarted=restarted)

        ok = await protocol.reconnect_with_retry(
            attempt, should_stop=lambda: self.closed)
        if ok or self.closed:
            return
        # Reconnect window exhausted: the cluster is really gone.
        for fut in list(self._object_futures.values()):
            if not fut.done():
                fut.set_exception(
                    ConnectionError("lost connection to the cluster"))

    def _resync_after_reconnect(self, gcs_restarted: bool = True):
        """Rebuild GCS-side state that only this process knows.

        0. Admission state: a fresh (or resynced) GCS has no memory of
           having backpressured us, and would never send the 'off'
           frame — a stale flag would freeze lease growth forever.
        1. Live ref counts — ONLY when the GCS actually restarted (epoch
           changed): a fresh instance starts all refcounts at zero.
           Replaying them into a surviving GCS after a mere link blip
           would double-count.
        2. obj_wait re-subscriptions for every unresolved future.
        3. Owned inline values not yet re-registered (promote-pending).
        Lease demand refreshes itself on the next pump.
        """
        self._gcs_backpressured = False
        if gcs_restarted:
            with self._ref_lock:
                # Queued deltas are already folded into _live_refs; the
                # fresh instance gets the snapshot, not the stream. Pure
                # corrections balance increfs the dead GCS already saw —
                # meaningless to a fresh instance.
                self._ref_deltas.clear()
                self._pure_deltas.clear()
                live = [(oid.binary(), n)
                        for oid, n in self._live_refs.items()]
            if live:
                self._send_gcs({"t": "ref", "d": live})
            # Retained outbound "ref" frames (pickled-copy increfs queued
            # while the link was down) would double-count against the
            # snapshot just replayed: drop them, exactly as the delta
            # queues above were cleared. Other retained frames (obj_put
            # registrations etc.) still replay.
            with self._out_lock:
                kept = [m for m in self._out_q
                        if not (isinstance(m, dict) and m.get("t") == "ref")]
                if len(kept) != len(self._out_q):
                    self._out_q.clear()
                    self._out_q.extend(kept)
            # Re-register owned inline values (chaos-found): put()
            # registrations and lazy ownership promotions are fire-and-
            # forget, so a GCS that died before WAL-appending one loses it
            # — and this owner, believing it already promoted
            # (_registered_inline), would never re-send. A borrower's
            # obj_waits on the fresh instance then pends forever. Replay
            # is idempotent (duplicate registrations collapse GCS-side);
            # shm objects need none of this — the arena outlives the GCS
            # and is rescanned/re-reported. Sent BEFORE the wait
            # re-subscriptions below: same-connection FIFO guarantees
            # registration-before-wait on the fresh instance.
            # Replay code exports (fn/class blobs + __main__ export
            # tokens): a crash before their WAL append loses them
            # durably, and the exporters' "already registered" caches
            # would never re-send — workers would then fail every task
            # of that class with "function not found". Fire-and-forget
            # (kv_put replies only when asked) and idempotent.
            for (ns, key), blob in list(self._kv_exports.items()):
                self._send_gcs({"t": "kv_put", "ns": ns, "k": key,
                                "v": blob})
            rows = []
            # list(): user threads put()/promote concurrently with this
            # loop-side resync — never iterate the live set.
            for oid in list(self._registered_inline):
                data = self._memory_store.get(oid)
                if data is not None:
                    # "rs" (resync): the fresh GCS must NOT pin the
                    # owner's initial reference for these — the live-ref
                    # snapshot sent above already carries every local
                    # ref, and pinning again would leak +1 per object.
                    rows.append({"oid": oid.binary(), "nbytes": len(data),
                                 "data": bytes(data), "rs": 1})
            for i in range(0, len(rows), 512):
                self._send_gcs({"t": "obj_puts", "objs": rows[i:i + 512]})
        # Re-subscribe every unresolved future — one batched wait-group
        # frame (the fresh GCS lost all per-request wait groups).
        unresolved = [oid for oid, fut in self._object_futures.items()
                      if not fut.done() and oid not in self._memory_store]
        if unresolved:
            if _cfg().batched_obj_wait:
                batch = max(1, _cfg().obj_waits_max_batch)
                for i in range(0, len(unresolved), batch):
                    self.loop.create_task(
                        self._obj_waits_request(unresolved[i:i + batch]))
            else:
                for oid in unresolved:
                    self.loop.create_task(
                        self._wait_remote(oid, self._object_futures[oid]))
        if gcs_restarted:
            # Re-claim leases this driver still holds: the fresh GCS
            # re-registered resyncing workers as IDLE (their hello has no
            # lease state — only the lessee knows), so without this claim
            # it would double-book them under other drivers while we keep
            # pushing work over the surviving direct connections.
            claims = []
            for cls in self._task_classes.values():
                for lease in cls.leases.values():
                    if not lease.dead:
                        claims.append([lease.wid, cls.wire.get("res")
                                       or {"CPU": 1.0}, lease.gpus or []])
            if claims:
                self._send_gcs({"t": "lease_claim", "leases": claims})
        for cls in self._task_classes.values():
            cls.demand = 0
            self._pump_class(cls)
        # Flush messages retained while the link was down.
        self.loop.call_soon(self._drain_out)

    def disconnect(self):
        if self.closed:
            return
        # Final metric/plane-event push + flusher stop BEFORE closing:
        # flush_now() no-ops once ``closed`` is set, and the joined
        # flusher thread is the no-leaked-thread shutdown posture.
        import sys as _sys

        _metrics = _sys.modules.get("ray_tpu_torch.util.metrics")
        _events = _sys.modules.get("ray_tpu_torch.util.events")
        for mod, fn in ((_metrics, "flush_now"), (_events, "flush_now")):
            if mod is not None:
                try:
                    getattr(mod, fn)()
                except Exception:
                    pass
        if _metrics is not None:
            try:
                _metrics.shutdown_flusher()
            except Exception:
                pass
        self.closed = True
        try:
            self.run_async(self._disconnect_async(), timeout=5)
        except Exception:
            pass
        if self._loop_thread is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._loop_thread.join(timeout=5)
        if self._store_obj is not None:
            self._store_obj.close()

    async def _disconnect_async(self):
        # Push out anything still parked in the outbound queue (e.g. a
        # fire-and-forget pg_remove issued just before shutdown).
        self._drain_out()
        self._flush_refs()
        if self.gcs is not None:
            await self.gcs.close()
        for pool in self._peer_conns.values():
            for cl in pool:
                cl.close()
        self._peer_conns.clear()
        for ch in self._actor_chans.values():
            if ch.conn is not None:
                await ch.conn.close()
        for cls, lease in list(self._leases_by_wid.values()):
            if lease.conn is not None:
                await lease.conn.close()

    # ----------------------------------------------------------- ref counts

    def note_ref_live(self, object_id: ObjectID, delta: int):
        """Local ObjectRef liveness bookkeeping (no wire traffic): the
        count a resync replays to rebuild GCS refcounts after a
        control-plane restart."""
        with self._ref_lock:
            live = self._live_refs.get(object_id, 0) + delta
            if live > 0:
                self._live_refs[object_id] = live
                return
            self._live_refs.pop(object_id, None)
        # The last local ref went: a resolved future has nothing left to
        # serve (a later ref to the id re-subscribes), and keeping it
        # grew the dict by every result this process ever read.
        fut = self._object_futures.get(object_id)
        if fut is not None and fut.done():
            self._object_futures.pop(object_id, None)

    def queue_ref_delta(self, object_id: ObjectID, delta: int):
        if self.closed:
            return
        with self._ref_lock:
            self._ref_deltas[object_id] = self._ref_deltas.get(object_id, 0) + delta

    def release_task_args(self, msg: dict):
        """Drop the owner's reference on a task's shm-resident argument
        bundle once the task reached a terminal state (the executing worker
        only borrows it — reference: ``DependencyResolver`` releases inlined
        dependencies after dispatch, ``transport/dependency_resolver.h``).
        Without this, every >100KB-arg call leaks an arena block for the
        driver's lifetime. Idempotent per task via a flag on the retained
        msg dict (retries re-use the same dict; the flag is only set once
        no resend can happen)."""
        ab = msg.get("argsref")
        if ab is None or msg.get("_args_rel"):
            return
        msg["_args_rel"] = True
        self._release_arg_ref(ObjectID(bytes(ab)))

    def _release_arg_ref(self, oid: ObjectID):
        """Drop one owner reference on an argument bundle: the liveness
        note (resync honesty) and the batched GCS decrement, together —
        every arg-release site must use this pair."""
        self.note_ref_live(oid, -1)
        self.queue_ref_delta(oid, -1)

    def _flush_refs_cb(self):
        self._flush_refs()
        if not self.closed:
            self._flusher_handle = self.loop.call_later(0.1, self._flush_refs_cb)

    def _flush_refs(self):
        # Deltas are only dequeued once actually SENT: dropping them while
        # the GCS link is down (reconnect in progress) would permanently
        # skew refcounts on a surviving GCS — the epoch-gated resync
        # replays live counts only after a real GCS restart.
        if self.gcs is None or self.gcs.closed:
            return
        # Queued fire-and-forget frames can hold pickled-copy increfs
        # (send_ref_incref_now rides the outbound queue): they must hit
        # the wire before any decref deltas below, or a fast
        # serialize-then-drop could underflow the GCS count.
        self._drain_out()
        with self._ref_lock:
            deltas = [(oid.binary(), d) for oid, d in self._ref_deltas.items()
                      if d != 0]
            pure = [(oid.binary(), d) for oid, d in self._pure_deltas.items()
                    if d != 0]
            self._ref_deltas.clear()
            self._pure_deltas.clear()
        if deltas or pure:
            try:
                self.gcs.send({"t": "ref", "d": deltas + pure})
            except ConnectionError:
                with self._ref_lock:
                    for oid_b, d in deltas:
                        oid = ObjectID(oid_b)
                        self._ref_deltas[oid] = \
                            self._ref_deltas.get(oid, 0) + d
                    for oid_b, d in pure:
                        oid = ObjectID(oid_b)
                        self._pure_deltas[oid] = \
                            self._pure_deltas.get(oid, 0) + d
                return
            for oid_b, d in deltas:
                if d < 0:
                    # Released refs no longer need lineage specs — and a
                    # dropped spec un-pins its task's argument bundle.
                    # (pure deltas are count corrections, not releases —
                    # they must not drop specs.)
                    spec = self._task_specs.pop(oid_b, None)
                    if spec is not None:
                        self._args_unpin(spec[2])
        self._flush_notes()

    def _queue_task_note(self, note: tuple):
        self._task_notes.append(note)
        if len(self._task_notes) == 1:
            self.loop.call_soon(self._flush_notes)

    def _flush_notes(self):
        if self._task_notes and self.gcs is not None and not self.gcs.closed:
            notes = list(self._task_notes)
            self._task_notes.clear()
            try:
                # Positional rows, not dicts: the head decodes thousands of
                # these per second and string-key decoding is the dominant
                # cost of the observability plane on a busy host.
                self.gcs.send({"t": "task_notes", "n": notes})
            except ConnectionError:
                pass

    # -------------------------------------------------------------- objects

    def object_future(self, object_id: ObjectID) -> "SlimFuture":
        fut = self._object_futures.get(object_id)
        if fut is None:
            fut = self.object_futures((object_id,))[0]
        return fut

    def object_futures(self, object_ids) -> List["SlimFuture"]:
        """Futures for a whole batch of ids, subscribing every unresolved
        one through ONE ``obj_waits`` frame (the vectorized reference
        plane). ``get``/``wait`` over n refs used to issue n ``obj_wait``
        round trips and n cross-thread coroutine handoffs; a batch costs
        one of each regardless of n."""
        out = []
        remote: Optional[List[ObjectID]] = None
        # get-or-create under the lock: two threads racing get() on the
        # same unseen ref must share ONE future — resolution goes through
        # the dict only (the per-ref lane carried each future into its
        # own coroutine, so a lost-race duplicate still resolved; here an
        # overwritten future would hang its waiter forever). Inline
        # results are set BEFORE publication, so no one observes an
        # unresolved future for a locally-available value.
        with self._wait_lock:
            for oid in object_ids:
                fut = self._object_futures.get(oid)
                if fut is None:
                    fut = SlimFuture()
                    data = self._memory_store.get(oid)
                    if data is not None:
                        fut.set_result(("inline", data))
                    else:
                        if remote is None:
                            remote = []
                        remote.append(oid)
                    self._object_futures[oid] = fut
                out.append(fut)
        if remote:
            if _cfg().batched_obj_wait:
                self._queue_obj_waits(remote)
            else:
                for oid in remote:
                    asyncio.run_coroutine_threadsafe(
                        self._wait_remote(oid, self._object_futures[oid]),
                        self.loop)
        return out

    def _queue_obj_waits(self, oids: List[ObjectID]):
        """Park unresolved ids for the next batched subscribe flush. A
        burst of subscriptions (one big get, or many small ones racing)
        coalesces into one loop wakeup and one ``obj_waits`` frame."""
        with self._wait_lock:
            self._wait_buf.extend(oids)
            wake = not self._wait_flush_scheduled
            if wake:
                self._wait_flush_scheduled = True
        if wake:
            try:
                self.loop.call_soon_threadsafe(self._flush_waits)
            except RuntimeError:
                pass  # loop shut down: disconnect fails the futures

    def _flush_waits(self):  # runs on the IO loop
        with self._wait_lock:
            self._wait_flush_scheduled = False
            oids, self._wait_buf = self._wait_buf, []
        todo = []
        for oid in oids:
            # .get, not []: maybe_reconstruct swaps futures out of the
            # dict from other threads; a KeyError here would discard the
            # whole already-swapped batch and strand every other oid.
            fut = self._object_futures.get(oid)
            if fut is not None and not fut.done():
                todo.append(oid)
        if not todo:
            return
        batch = max(1, _cfg().obj_waits_max_batch)
        for i in range(0, len(todo), batch):
            self.loop.create_task(self._obj_waits_request(todo[i:i + batch]))

    async def _obj_waits_request(self, oids: List[ObjectID]):
        """One wait-group subscription: N oids, one frame. The worker
        lane always passes num_returns=1 — blocking is per-FUTURE here,
        so the reply must carry whatever is resolvable NOW (all rows when
        everything is ready — still one frame) and later resolutions
        stream back as coalesced ``obj_res`` pushes; a higher threshold
        would hold ready rows hostage to the group's stragglers and
        stall ``wait(num_returns=1)`` behind its slowest ref."""
        serialization.TRANSPORT_STATS["obj_waits_frames"] += 1
        try:
            reply = await self.gcs.request(
                {"t": "obj_waits", "oids": [oid.binary() for oid in oids],
                 "nr": 1})
        except asyncio.CancelledError:
            for oid in oids:
                fut = self._object_futures.get(oid)
                if fut is not None and not fut.done():
                    fut.set_exception(ConnectionError("wait cancelled"))
        except ConnectionError:
            # GCS link blip: futures stay PENDING — the reconnect resync
            # re-subscribes every unresolved future (same contract as the
            # per-ref lane).
            pass
        else:
            if reply.get("ok"):
                self._apply_res_rows(reply.get("rows") or ())
            else:
                # The directory could not take the group (internal error):
                # fall back to the per-ref lane rather than stranding the
                # futures.
                for oid in oids:
                    fut = self._object_futures.get(oid)
                    if fut is not None and not fut.done():
                        self.loop.create_task(self._wait_remote(oid, fut))

    def _apply_res_rows(self, rows):
        """Resolve per-oid futures from wait-group resolution rows
        (positional: ``[oid, code, payload]`` — 1=inline data, 2=shm
        nbytes, 0=lost err string)."""
        for r in rows:
            oid = ObjectID(bytes(r[0]))
            with self._wait_lock:
                fut = self._object_futures.get(oid)
                if fut is None:
                    fut = SlimFuture()
                    self._object_futures[oid] = fut
            if fut.done():
                continue
            code = r[1]
            if code == 1:
                fut.set_result(("inline", r[2]))
            elif code == 2:
                fut.set_result(("shm", r[2]))
            else:
                fut.set_exception(
                    serialization.ObjectLostError(str(r[2])))

    async def _wait_remote(self, object_id: ObjectID, fut: SyncFuture):
        serialization.TRANSPORT_STATS["obj_wait_frames"] += 1
        try:
            reply = await self.gcs.request(
                {"t": "obj_wait", "oid": object_id.binary()})
            if fut.done():
                return
            if not reply.get("ok"):
                fut.set_exception(serialization.ObjectLostError(
                    reply.get("err", "object lost")))
            elif reply["where"] == "inline":
                fut.set_result(("inline", reply["data"]))
            else:
                fut.set_result(("shm", reply["nbytes"]))
        except asyncio.CancelledError:
            if not fut.done():
                fut.set_exception(ConnectionError("wait cancelled"))
        except ConnectionError:
            # GCS link blip: leave the future PENDING — the reconnect
            # resync re-subscribes every unresolved future on the fresh
            # connection, and _reconnect_gcs fails them only after the
            # whole retry window is exhausted. Failing here would turn a
            # seconds-long control-plane restart into user-visible
            # ConnectionErrors (and poison the cached future for later
            # gets of the same ref).
            pass

    def _resolve_value(self, object_id: ObjectID, where: str, payload) -> Any:
        if where == "inline":
            value = deserialize(memoryview(payload))
        else:
            view = self.store.get(object_id, payload)
            if view is None:
                # Not in this host's store: pull through the GCS relay
                # (other host / remote client / spilled).
                view = self._pull_object(object_id)
            if isinstance(view, (bytes, bytearray, memoryview)):
                value = deserialize(memoryview(view))
            else:
                # Zero-copy read: the arena pin transfers to the value's
                # buffers and drops when they are garbage-collected.
                pin_cb = view.transfer()
                try:
                    value = deserialize(view.data, pin=pin_cb)
                except ValueError:
                    # Lost the race with eviction/spill: the index entry
                    # matched but the block was recycled before the pin
                    # landed (corrupt header => deserialize raised BEFORE
                    # consuming the pin, so release it here). The GCS
                    # relay restores from spill or a holder node — the
                    # object-recovery retry path
                    # (object_recovery_manager.h:41).
                    try:
                        pin_cb()
                    except Exception:
                        pass
                    view = self._pull_object(object_id)
                    if isinstance(view, (bytes, bytearray, memoryview)):
                        value = deserialize(memoryview(view))
                    else:
                        value = deserialize(view.data,
                                            pin=view.transfer())
        if isinstance(value, serialization.DynamicReturns):
            # Dynamic generator task: primary return resolves to the
            # per-item ref generator (descriptor may be inline or shm).
            # borrowed=True: each wrapper queues -1 at GC, so each
            # construction must queue its matching +1 (re-resolving the
            # descriptor would otherwise underflow the GCS refcount).
            return ObjectRefGenerator(
                [ObjectRef(ObjectID(b), self, borrowed=True)
                 for b in value.oids])
        if isinstance(value, TaskError):
            raise value.cause if isinstance(value.cause, Exception) else value
        if isinstance(value, Exception):
            raise value
        return value

    def _pull_object(self, object_id: ObjectID):
        """Fetch an object from another node; cache locally.

        Concurrent gets of the same not-yet-local object coalesce behind
        a single in-flight pull (the reference's PullManager dedups by
        object id the same way, ``object_manager/pull_manager.h:52``) —
        without this, racing threads both run the transfer and race
        ``store.create`` on the same id.
        """
        with self._pull_lock:
            fut = self._pull_inflight.get(object_id)
            owner = fut is None
            if owner:
                fut = self._pull_inflight[object_id] = SlimFuture()
        if not owner:
            serialization.TRANSPORT_STATS["pull_dedup_hits"] += 1
            while True:
                try:
                    kind, payload = fut.result(pull_deadline_s(1 << 30))
                    break
                except TimeoutError:
                    with self._pull_lock:
                        still = self._pull_inflight.get(object_id) is fut
                    if still:
                        # Owner still actively pulling. Its own deadlines
                        # scale with the TRUE object size (ours used a
                        # 1 GiB guess): keep waiting — racing a duplicate
                        # pull would collide on store.create, the exact
                        # race the dedup exists to prevent. The owner
                        # cannot wedge unboundedly: every path inside
                        # _pull_object_impl is deadline-bounded and
                        # always resolves the future.
                        continue
                    # Owner finished between our timeout and the check:
                    # its result is set (or microseconds away).
                    try:
                        kind, payload = fut.result(5.0)
                    except TimeoutError:
                        kind, payload = None, None
                    break
            if kind == "view":
                view = self.store.get(object_id, payload)
                if view is not None:
                    return view
            elif kind == "bytes":
                return payload
            # Sealed copy evicted between pulls (or the owner vanished
            # without a result): re-enter the dedup gate so exactly one
            # retrier becomes the registered owner — an unregistered
            # direct pull here would race a fresh owner on store.create,
            # the collision this method exists to prevent.
            return self._pull_object(object_id)
        try:
            result = self._pull_object_impl(object_id)
        except BaseException as e:
            if owner:
                with self._pull_lock:
                    self._pull_inflight.pop(object_id, None)
                fut.set_exception(e)
            raise
        if owner:
            if isinstance(result, (bytes, bytearray, memoryview)):
                fut.set_result(("bytes", result))
            else:
                fut.set_result(("view", len(result.data)))
            with self._pull_lock:
                self._pull_inflight.pop(object_id, None)
        return result

    def _pull_object_impl(self, object_id: ObjectID):
        """One actual transfer: striped P2P pull, else the GCS relay.

        Client-side half of the reference's object-manager Pull
        (``object_manager/pull_manager.h:52``): locate holders via the
        GCS object directory, then stripe CHUNKS across every advertised
        holder — full holders AND mid-pull partial holders — peer-to-peer
        (bulk bytes never transit the head). Falls back to the GCS relay
        (spilled objects, no serving agent). Returns a store view
        (zero-copy, pinned) when caching succeeds, else raw bytes.
        """
        nbytes = None
        if not self.client_mode:
            try:
                # Every downstream path retires the pull=1 registration:
                # the striped path via _pull_from_peers' error handlers +
                # _finish_pull, the no-holder case via the pidx branch
                # below, and a registration-less reply (inline data /
                # error) never creates one — split responsibility the
                # per-function pass cannot see.
                loc = self.request_gcs(  # raylint: disable=RTL161 (retired by _pull_from_peers error paths / pidx branch below)
                    {"t": "obj_locate", "oid": object_id.binary(),
                     "pull": 1},
                    timeout=_cfg().pull_timeout_base_s)
            except (ConnectionError, TimeoutError) as e:
                raise serialization.ObjectLostError(
                    f"locate of {object_id.hex()} failed: {e}")
            if loc.get("ok") and loc.get("data") is not None:
                return loc["data"]  # inline value
            if loc.get("ok"):
                nbytes = loc["nbytes"]
                if loc.get("addrs") or loc.get("partial"):
                    try:
                        view = self._pull_from_peers(loc, object_id, nbytes)
                        if view is not None:
                            return view
                    except (ConnectionError, OSError, asyncio.TimeoutError,
                            TimeoutError, SyncTimeoutError, MemoryError):
                        # py<3.11: concurrent.futures.TimeoutError (what a
                        # timed-out cfut.result raises) is NOT the builtin
                        # — without it a slow striped pull skips the GCS
                        # relay fallback and surfaces a raw timeout.
                        # MemoryError: a full local store cannot host the
                        # striped copy, but the relay below still hands
                        # the caller raw bytes (its store.create cache is
                        # best-effort).
                        pass
                elif loc.get("pidx") is not None:
                    # Locate registered us as an active puller but the
                    # striped path never ran (no serving holders): retire
                    # the registration so this object's npull doesn't
                    # count a long-lived worker forever. (The striped
                    # path retires via _finish_pull; a duplicate done is
                    # a no-op.)
                    try:
                        self.loop.call_soon_threadsafe(
                            self._send_gcs,
                            {"t": "obj_progress",
                             "oid": object_id.binary(), "done": True,
                             "ok": False})
                    except RuntimeError:
                        pass
        try:
            reply = self.request_gcs(
                {"t": "obj_pull", "oid": object_id.binary()},
                timeout=pull_deadline_s(nbytes or (64 << 20)))
        except (ConnectionError, TimeoutError) as e:
            raise serialization.ObjectLostError(
                f"pull of {object_id.hex()} failed: {e}")
        if not reply.get("ok") or reply.get("data") is None:
            raise serialization.ObjectLostError(
                f"object {object_id.hex()} missing from the local store and "
                f"unpullable: {reply.get('err', 'no data')}")
        data = reply["data"]
        try:
            # Cache in our host store so repeat reads are zero-copy local.
            buf = self.store.create(object_id, len(data))
            buf[:len(data)] = data
            self.store.seal(object_id)
            view = self.store.get(object_id, len(data))
            if view is not None:
                return view
        except Exception:
            pass
        return data

    _PULL_CHUNK = _cfg().pull_chunk_bytes  # per-fetch bytes (ref: 5 MiB)
    _PULL_WINDOW = _cfg().pull_window  # outstanding chunks per source

    def _pull_from_peers(self, loc: dict, object_id: ObjectID, nbytes: int):
        """Cooperative striped pull into the local store; seal + register
        so this node becomes a holder too. Chunks are striped across all
        advertised holders (full AND mid-pull partial ones), and chunks
        that land here are immediately serveable to OTHER pullers
        (chunk-level holder registration via ``obj_progress``) — an
        N-node broadcast pipelines instead of serializing on the source's
        egress."""
        from . import broadcast

        cfg = _cfg()
        cs = int(loc.get("cs") or self._PULL_CHUNK)
        oid_b = object_id.binary()
        exclude = {self.serve_addr} if self.serve_addr else set()
        try:
            buf = self.create_in_store(object_id, nbytes)
        except BaseException:
            # The locate(pull=1) that routed us here already registered
            # this worker as an active puller; retire that registration
            # before bailing or the object's npull counts a phantom
            # puller (narrowing every later puller's stripe) until this
            # process disconnects.
            try:
                self.loop.call_soon_threadsafe(
                    self._send_gcs,
                    {"t": "obj_progress", "oid": oid_b,
                     "done": True, "ok": False})
            except RuntimeError:
                pass
            raise

        async def locate():
            return await self.gcs.request(
                {"t": "obj_locate", "oid": oid_b, "pull": 1}, timeout=5)

        engine = None
        try:
            engine = broadcast.StripedPull(
                oid_b, nbytes, buf, chunk_bytes=cs,
                window=self._PULL_WINDOW,
                max_sources=cfg.pull_max_sources,
                chunk_timeout_s=chunk_timeout_s(cs, self._PULL_WINDOW),
                refresh_interval_s=cfg.pull_refresh_interval_s,
                progress_every=cfg.pull_progress_chunks,
                locate=locate, conn_factory=self._chunk_conn,
                conn_release=self._release_chunk_conn,
                exclude_addrs=exclude,
                pidx=loc.get("pidx"), npull=int(loc.get("npull") or 1))

            def report(idxs, _e=engine):
                # Runs on the IO loop (engine context): publish our
                # chunk-bitmap progress + current sources (the
                # directory's per-holder load signal).
                msg = {"t": "obj_progress", "oid": oid_b, "cs": _e.cs,
                       "nbytes": nbytes, "add": idxs,
                       "srcs": _e.live_addrs()}
                if self.serve_addr:
                    msg["addr"] = self.serve_addr
                    if self.node_id is not None:
                        msg["node"] = self.node_id
                self._send_gcs(msg)

            engine.report = report
            if self.serve_addr and engine.nchunks > 1:
                self._partials[object_id] = engine
            cfut = asyncio.run_coroutine_threadsafe(engine.run(loc),
                                                    self.loop)
        except BaseException:
            # The engine never started (ctor raised, or the loop is
            # closed so the dispatch itself failed): the range can't
            # have in-flight serves — abort it and retire the puller
            # registration, exactly like the create-failure path above
            # (RTL161: the unprotected window stranded the range AND
            # left a phantom npull).
            if engine is not None:
                self._finish_pull(object_id, engine, ok=False)
            else:
                try:
                    self.store.abort(object_id)
                except Exception:
                    pass
                try:
                    self.loop.call_soon_threadsafe(
                        self._send_gcs,
                        {"t": "obj_progress", "oid": oid_b,
                         "done": True, "ok": False})
                except RuntimeError:
                    pass
            raise
        try:
            ok = cfut.result(pull_deadline_s(nbytes))
        except BaseException:
            # The engine must be DEAD before the buffer is recycled:
            # aborting while it still writes would corrupt whatever object
            # the arena hands this range to next.
            cfut.cancel()
            try:
                cfut.result(10)
            except Exception:
                pass
            self._finish_pull(object_id, engine, ok=False)
            raise
        serialization.TRANSPORT_STATS["bcast_chunk_retries"] += engine.retries
        if not ok:
            self._finish_pull(object_id, engine, ok=False)
            return None
        # Seal BEFORE dropping the partial registration: a peer request
        # landing in between is served from the sealed store instead of
        # getting a spurious failure.
        self.store.seal(object_id)
        self._finish_pull(object_id, engine, ok=True)
        return self.store.get(object_id, nbytes)

    def _finish_pull(self, object_id: ObjectID, engine, ok: bool):
        """Terminal bookkeeping for a striped pull: directory updates
        (holder registration + partial-entry retirement, FIFO-ordered on
        the GCS conn so there is no holderless window) and, on failure, a
        serve-drain-guarded abort (recycling the buffer while a chunk
        serve still aliases it would corrupt the next object)."""
        self._partials.pop(object_id, None)
        oid_b = object_id.binary()

        def _send():
            if ok:
                self._send_gcs({"t": "obj_put", "oid": oid_b,
                                "nbytes": engine.nbytes, "shm": True})
            msg = {"t": "obj_progress", "oid": oid_b, "done": True,
                   "ok": ok, "src_bytes": engine.src_bytes}
            if self.serve_addr:
                msg["addr"] = self.serve_addr
            self._send_gcs(msg)

        try:
            self.loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass
        if not ok:
            # Recycle only after the engine refuses new serves AND every
            # in-flight serve released its view (close_for_serve takes the
            # serve lock, so there is no window where a serve slips past
            # the gate onto a recycled range). Bounded wait: a peer wedged
            # mid-sendall must not hang the failure path — skipping the
            # abort then leaks one arena range instead of corrupting
            # whatever object the range is handed to next.
            drained = threading.Event()
            engine.close_for_serve(drained.set)
            if drained.wait(10):
                self.store.abort(object_id)

    # ------------------------------------------------ chunk serving (P2P)

    def resolve_obj_fetch(self, msg: dict):
        """Resolve an obj_fetch to ``(view, miss)`` — from an IN-PROGRESS
        pull's landed chunks (chunk-level relay) or from the sealed local
        store. Thread-safe: called by the dedicated serve threads."""
        oid = ObjectID(bytes(msg["oid"]))
        engine = self._partials.get(oid)
        if engine is not None:
            view = engine.serve_view(int(msg.get("off", 0)),
                                     int(msg.get("len", 0)))
            return view, view is None
        view = (self.store.get(oid, msg.get("nbytes", 0))
                if self.store is not None else None)
        if view is None and self.session_dir and _cfg().spill_serve:
            # Serve-from-spill fallback (idle workers are advertised as
            # extra serve endpoints): pread chunks off the GCS's
            # deterministic spill file; absent file = retryable miss.
            from .object_store import open_spilled

            try:
                sview = open_spilled(self.session_dir, oid,
                                     int(msg.get("nbytes", 0)))
            except Exception:
                sview = None
            return sview, sview is None
        return view, False

    def handle_obj_fetch(self, conn, msg: dict):
        """Framed-connection serve fallback (UDS direct socket). Runs
        synchronously on the IO loop so replies stay FIFO per connection
        (the ChunkClient read side relies on it)."""
        from . import broadcast

        if not getattr(conn, "_obj_serve_widened", False):
            conn._obj_serve_widened = True
            protocol.widen_for_serving(conn)
        view, miss = self.resolve_obj_fetch(msg)
        broadcast.serve_obj_fetch(conn, msg, view, miss=miss,
                                  stats=serialization.TRANSPORT_STATS)

    # ------------------------------------------- pull-connection caching

    async def _chunk_conn(self, addr: str):
        """Check out a pull connection for ``addr`` (reuse an idle cached
        one, else dial). Loop-only; a checked-out client is exclusive to
        one source stripe (FIFO reply pairing forbids sharing)."""
        from . import broadcast

        pool = self._peer_conns.get(addr)
        while pool:
            cl = pool.pop()
            if not pool:
                self._peer_conns.pop(addr, None)
            if not cl.closed:
                return cl
        return await broadcast.ChunkClient.connect(addr)

    def _release_chunk_conn(self, addr: str, client, healthy: bool):
        if not healthy or client.closed:
            client.close()
            return
        self._peer_conns.setdefault(addr, []).append(client)
        self._cap_peer_conns()

    def _cap_peer_conns(self):
        cap = max(1, _cfg().max_peer_conns)
        total = sum(len(v) for v in self._peer_conns.values())
        while total > cap and self._peer_conns:
            addr = next(iter(self._peer_conns))
            pool = self._peer_conns[addr]
            pool.pop(0).close()
            if not pool:
                del self._peer_conns[addr]
            total -= 1

    def _evict_peer_addrs(self, addrs):
        """Drop cached pull connections to nodes the control plane says
        are DEAD or DRAINING (lifecycle events): without this, dead
        peers leave closed-socket entries in the cache forever."""
        for addr in addrs or ():
            for cl in self._peer_conns.pop(addr, []):
                cl.close()

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        futs = self.object_futures([r.id for r in refs])
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r, fut in zip(refs, futs):
            for attempt in range(4):
                remaining = (None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
                try:
                    where, payload = fut.result(remaining)
                except serialization.ObjectLostError:
                    # Loss delivered through the wait lane (error row /
                    # not-ok reply resolved the future itself): same
                    # lineage-reconstruction path as a loss discovered
                    # at value resolution below.
                    if attempt == 3 or not self.maybe_reconstruct(r.id):
                        raise
                    fut = self.object_future(r.id)
                    continue
                except TimeoutError:
                    raise GetTimeoutError(
                        f"get timed out after {timeout}s waiting for {r}")
                try:
                    # Outside the timeout guard: a TASK that raised a
                    # TimeoutError subclass (e.g. a typed
                    # CollectiveTimeout) re-raises here — it must
                    # surface as itself, not be masked into "get timed
                    # out" when the get deadline never actually fired.
                    out.append(self._resolve_value(r.id, where, payload))
                    break
                except serialization.ObjectLostError:
                    # Owner-side lineage reconstruction: resubmit the
                    # producing task and wait again.
                    if attempt == 3 or not self.maybe_reconstruct(r.id):
                        raise
                    fut = self.object_future(r.id)
        return out

    def create_in_store(self, oid: ObjectID, nbytes: int):
        """store.create with backpressure: on allocator exhaustion, ask the
        GCS to evict/spill (reference: plasma ``CreateRequestQueue``
        backpressure, ``plasma/create_request_queue.h``) and retry."""
        if failpoints.active():
            failpoints.fire("store.create")
        from .backoff import Backoff

        # Consumers flush derefs every 0.1s: the retry window must span
        # several flush cycles or a streaming producer races the eviction
        # of just-consumed blocks — hence the 0.1s cap on the shared
        # jittered ladder.
        backoff = Backoff(cap=0.1)
        for _ in range(12):
            try:
                return self.store.create(oid, nbytes)
            except MemoryError:
                # Our own queued deref deltas may be what's blocking
                # eviction — push them out before asking the GCS to free.
                try:
                    self.loop.call_soon_threadsafe(self._flush_refs)
                except RuntimeError:
                    pass
                try:
                    self.request_gcs({"t": "store_pressure",
                                      "nbytes": nbytes}, timeout=30)
                except Exception:
                    pass
                time.sleep(backoff.next_delay())
        return self.store.create(oid, nbytes)

    def put(self, value: Any) -> ObjectRef:
        """Store a value, returning its ref.

        Registration with the GCS is fire-and-forget: frames on the GCS
        connection are FIFO, so any later message that could cause a
        borrower to resolve this ref (a submit carrying it, a serialized
        handoff) is ordered AFTER the registration — no ack round-trip
        needed (an RTT per put halves small-put throughput on a busy
        host; the reference's plasma create is similarly local-only).
        """
        oid = ObjectID.for_put(self._put_counter.next())
        sobj = serialize(value)
        # The registration below covers this object for borrowers:
        # serializing the returned ref later must not re-ship the payload
        # through promote_on_serialize (per-ref obj_put frames dominated
        # the contained-refs shapes before this mark).
        self._registered_inline.add(oid)
        if sobj.total_size <= serialization.INLINE_THRESHOLD:
            data = sobj.to_bytes()
            self._memory_store[oid] = data
            self.send_gcs_threadsafe({
                "t": "obj_put", "oid": oid.binary(),
                "nbytes": len(data), "data": data})
        else:
            buf = self.create_in_store(oid, sobj.total_size)
            # Create->seal window: ANY failure — not just an injected
            # one, the pre-RTL161 form only aborted under the failpoint
            # — must abort the unsealed allocation (no stranded arena
            # range) and back out the registration mark above, or the
            # failed ref would poison later borrower serialization.
            try:
                sobj.write_into(buf)
                if failpoints.active():
                    failpoints.fire("store.seal")
                self.store.seal(oid)
            except BaseException:
                self._registered_inline.discard(oid)
                try:
                    self.store.abort(oid)
                except Exception:
                    pass
                raise
            self.send_gcs_threadsafe({
                "t": "obj_put", "oid": oid.binary(),
                "nbytes": sobj.total_size, "shm": True})
        return ObjectRef(oid, self)

    def put_serialized(self, sobj: serialization.SerializedObject,
                       oid: Optional[ObjectID] = None,
                       register: bool = True) -> ObjectID:
        """Write an already-serialized object into the store.

        Safe from any thread: shm create/seal are plain syscalls and the GCS
        registration is marshalled onto the IO loop (asyncio transports are
        not thread-safe).
        """
        if oid is None:
            oid = ObjectID.for_put(self._put_counter.next())
        buf = self.create_in_store(oid, sobj.total_size)
        # Between create and seal: any failure must not strand the
        # unsealed allocation — abort reclaims the range (the
        # crashed-writer case plasma handles via client death; the
        # pre-RTL161 form covered only the injected failure).
        try:
            sobj.write_into(buf)
            if failpoints.active():
                failpoints.fire("store.seal")
            self.store.seal(oid)
        except BaseException:
            try:
                self.store.abort(oid)
            except Exception:
                pass
            raise
        if register:
            self._registered_inline.add(oid)
            self.loop.call_soon_threadsafe(self._send_gcs, {
                "t": "obj_put", "oid": oid.binary(),
                "nbytes": sobj.total_size, "shm": True})
        return oid

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        futs = self.object_futures([r.id for r in refs])
        # One shared Event woken by ANY completion (SlimFutures don't
        # support concurrent.futures.wait; a per-call Event matches its
        # single-waiter design). Still a real blocking wait — no busy-poll
        # (the reference blocks in plasma Wait the same way). Completions
        # feed a shared counter, so each wakeup costs O(1) instead of
        # recounting every future (O(n^2) across a batch of n
        # completions — the wait-at-scale pathology).
        ev = threading.Event()
        done_count = [0]
        count_lock = threading.Lock()

        def _wake(_f):
            # Count-then-set ordering pairs with the loop's
            # clear-then-read: a completion is either visible in the
            # count or re-sets the event — never silently lost.
            with count_lock:
                done_count[0] += 1
            ev.set()

        for f in futs:
            f.add_done_callback(_wake)
        try:
            while True:
                # Clear BEFORE reading the counter: a completion landing
                # after the read re-sets the event, so the wait below
                # returns promptly instead of losing that wakeup.
                ev.clear()
                n_done = done_count[0]
                if n_done >= num_returns or n_done >= len(futs):
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                ev.wait(remaining)
        finally:
            # Detach our waker: a polling loop (wait in a while-loop)
            # must not grow every pending future's callback list.
            for f in futs:
                f.remove_done_callback(_wake)
        done_idx = [i for i, f in enumerate(futs) if f.done()][:num_returns]
        done_set = set(done_idx)
        ready = [refs[i] for i in done_idx]
        not_ready = [r for i, r in enumerate(refs) if i not in done_set]
        return ready, not_ready

    # ---------------------------------------------------------------- tasks

    def send_ref_incref_now(self, object_id: ObjectID):
        """Immediate +1 for a pickled ref copy (see ObjectRef.__reduce__):
        bypasses the 0.1s delta flush so it cannot lose the race with the
        owner's decref while the message is in flight. The receiving
        process's wrapper owns (and eventually decrefs) this count, so
        local live-ref tracking here is untouched.

        Rides the outbound queue, NOT a per-ref loop wakeup: serializing
        an object that contains k nested refs (the 10k-refs shape) fires
        k of these back-to-back — ``_drain_out`` coalesces the run into
        ONE ``ref`` frame, and any later message carrying the ref is
        queued behind it, so the orders-before-carrier invariant holds.
        ``_flush_refs`` drains this queue before sending decref deltas,
        so a queued +1 can never lose to the owner's own -1 either."""
        if self.gcs is not None and not self.gcs.closed:
            self.send_gcs_threadsafe(
                {"t": "ref", "d": [(object_id.binary(), 1)]})
        else:
            # Link down (reconnect in progress): the receiver's wrapper
            # will still deliver its -1, so dropping this +1 would
            # underflow the count on a surviving GCS. Queue it through
            # the delta path — flushed on reconnect; cleared (correctly)
            # on a true GCS restart, where the receiver replays its own
            # live count in the snapshot resync.
            self.queue_ref_delta(object_id, +1)

    def send_ref_decref_now(self, object_id: ObjectID):
        """Balance a ``send_ref_incref_now`` whose pickled ref copy never
        left this process (serialize()'s stdlib attempt fired the incref,
        then fell back to cloudpickle which re-fires it). Must NOT go
        through ``queue_ref_delta``: ``_flush_refs`` reads queued -1s as
        local ref releases and drops the object's lineage spec — this
        decrement is pure count correction, the local ref is still alive."""
        if self.gcs is not None and not self.gcs.closed:
            self.loop.call_soon_threadsafe(
                self._send_gcs,
                {"t": "ref", "d": [(object_id.binary(), -1)]})
        else:
            with self._ref_lock:
                self._pure_deltas[object_id] = \
                    self._pure_deltas.get(object_id, 0) - 1

    def promote_on_serialize(self, object_id: ObjectID):
        """Register a locally-held inline value with the GCS so a borrower
        can resolve the ref (lazy ownership promotion)."""
        if object_id in self._registered_inline:
            return
        self._registered_inline.add(object_id)
        data = self._memory_store.get(object_id)
        if data is None:
            # Value not here yet (in-flight actor call) — promote on arrival.
            self._promote_pending.add(object_id)
            return
        # Outbound queue, not a per-ref wakeup: a serialize pass that
        # promotes many contained refs coalesces into one obj_puts frame.
        self.send_gcs_threadsafe({
            "t": "obj_put", "oid": object_id.binary(),
            "nbytes": len(data), "data": bytes(data)})

    def push_result(self, tid_bytes: bytes, results: List[dict]):
        """Handle a task_done push from the GCS (we are the owner)."""
        for r in results:
            oid = ObjectID(r["oid"])
            if r.get("data") is not None:
                self._memory_store[oid] = r["data"]
                payload: Tuple[str, Any] = ("inline", r["data"])
                if oid in self._promote_pending:
                    self._promote_pending.discard(oid)
                    self._send_gcs({"t": "obj_put", "oid": oid.binary(),
                                    "nbytes": len(r["data"]),
                                    "data": bytes(r["data"])})
            else:
                payload = ("shm", r["nbytes"])
            fut = self._object_futures.get(oid)
            if oid not in self._live_refs:
                # Every ref to this result went before it came: nothing
                # will read the future (a ref made later re-subscribes).
                if fut is not None:
                    self._object_futures.pop(oid, None)
                    if not fut.done():
                        fut.set_result(payload)
                continue
            if fut is None:
                fut = SlimFuture()
                self._object_futures[oid] = fut
            if not fut.done():
                fut.set_result(payload)

    async def _on_gcs_push(self, msg: dict):
        t = msg.get("t")
        if t is None:
            return  # empty/typeless frame: skip, never fall through
        if t == "task_done":
            self.push_result(msg["tid"], msg["results"])
        elif t == "obj_res":
            # Streamed wait-group resolutions (rows past the group's
            # num_returns threshold arrive as coalesced pushes).
            self._apply_res_rows(msg.get("rows") or ())
        elif t == "lease_grant":
            self._on_lease_grant(msg)
        elif t == "lease_dead":
            self._on_lease_dead(msg)
        elif t == "lease_revoked":
            self._on_lease_revoked(msg)
        elif t == "lease_nudge":
            self._on_lease_nudge()
        elif t == "backpressure":
            # GCS admission control: this tenant exceeded its in-flight
            # frame budget. The GCS has already stopped reading our
            # socket (kernel backpressure throttles the flood); the
            # advisory frame additionally pauses lease GROWTH — existing
            # leases keep draining, so progress continues at the current
            # allocation instead of amplifying the burst.
            self._gcs_backpressured = bool(msg.get("on"))
            if not self._gcs_backpressured:
                for cls in self._task_classes.values():
                    self._pump_class(cls)
        elif t == "lease_void":
            # The GCS voided our demand (e.g. the targeted placement
            # group was removed): queued tasks of this class can never
            # dispatch — fail them now instead of hanging.
            cls = self._task_classes.get(msg.get("key"))
            if cls is not None:
                cls.demand = 0
                while cls.queue:
                    self._finish_item_error(
                        cls.queue.popleft(),
                        ValueError(msg.get("err",
                                           "lease demand voided")))
        elif t == "obj_upload":
            # Serve our host store's bytes to the GCS object-transfer relay
            # (reference: object manager Push, object_manager.h:206).
            oid = ObjectID(msg["oid"])
            view = self.store.get(oid, msg.get("nbytes", 0))
            if view is None:
                self.gcs.reply(msg, {"ok": False})
            else:
                try:
                    self.gcs.reply(msg, {"ok": True,
                                         "data": bytes(view.data)})
                finally:
                    view.close()
        elif t == "node_addrs_gone":
            # Node lifecycle push (DEAD/DRAINING): retire cached pull
            # connections to its serve addresses.
            self._evict_peer_addrs(msg.get("addrs"))
        elif t == "actor_dead":
            aid = ActorID(msg["aid"])
            self._dead_actors[aid] = msg.get("cause", "actor died")
            ch = self._actor_chans.pop(aid, None)
            # Permanent death (the GCS only broadcasts actor_dead from
            # _cleanup_dead_actor): no restart will re-read the ctor arg
            # bundle — drop our pin.
            ctor_oid = self._actor_ctor_args.pop(aid, None)
            if ctor_oid is not None:
                self._release_arg_ref(ctor_oid)
            if ch is not None and ch.conn is not None:
                await ch.conn.close()
        elif t in ("exec", "actor_init", "cancel", "exit", "memdump"):
            # Only worker processes receive these; the executor overrides.
            await self.handle_control(msg)

    async def handle_control(self, msg: dict):  # overridden in worker_main
        pass

    def submit_task(self, fid: str, msg_args: dict, num_returns,
                    opts: dict) -> List[ObjectRef]:
        tid = TaskID.fast_unique()
        refs = []
        oids = []
        deps = msg_args.pop("deps", None)
        dynamic = num_returns == "dynamic"
        if dynamic:
            # One primary return: the DynamicReturns descriptor
            # (resolved to an ObjectRefGenerator at get). No opts copy:
            # the per-opts scheduling-class cache must keep working.
            num_returns = 1
        for i in range(num_returns):
            oid = ObjectID.for_task_return(tid, i + 1)
            fut = SlimFuture()
            self._object_futures[oid] = fut
            oids.append(oid)
            refs.append(ObjectRef(oid, self))
        if self.client_mode or opts.get("sched") == "SPREAD":
            # Remote (ray://) drivers cannot reach worker sockets: route
            # through the GCS scheduler (reference: Ray Client proxying).
            # SPREAD tasks route there too — placement is per TASK for
            # spread semantics, which lease reuse would defeat (every task
            # of the class would ride the first granted worker).
            msg = {"t": "submit", "tid": tid.binary(), "fid": fid,
                   "nret": "dyn" if dynamic else num_returns,
                   "opts": ({k: v for k, v in opts.items() if k != "_cls"}
                            if "_cls" in opts else opts), **msg_args}
            self.send_gcs_threadsafe(msg)
            return refs
        # Direct path: lease workers for this scheduling class and push
        # the task straight to one (reference hot path, §3.2: lease reuse
        # + PushTask, normal_task_submitter.h:108).
        msg = {"t": "exec", "tid": tid.binary(), "fid": fid,
               "nret": "dyn" if dynamic else num_returns,
               "opts": opts,
               "owner": self.worker_id.binary(), **msg_args}
        # Scheduling class key + lease_req fields: invariant per opts dict
        # (shared wire_opts cached on the RemoteFunction) — compute once.
        cached = opts.get("_cls")
        if cached is None:
            wire = {"res": opts.get("res") or {"CPU": 1.0}}
            for k in ("sched", "pg", "bix"):
                if opts.get(k) is not None:
                    wire[k] = opts[k]
            # Interpreter-level runtime envs (pip/uv) are satisfied at
            # worker SPAWN (dedicated venv workers), so the env is part of
            # the scheduling class: leases of different envs never mix.
            renv = opts.get("runtime_env")
            if renv:
                from .roadmap import not_ported

                raise not_ported("runtime_env", "runtime_env")
            key = repr((sorted(wire["res"].items()), wire.get("pg"),
                        wire.get("bix"), wire.get("sched"),
                        wire.get("env_key")))
            # Clean wire opts (no cache tuple): what actually ships in
            # every exec/submit frame — packing the cache itself would
            # add bytes + msgpack time per task.
            clean = {k: v for k, v in opts.items() if k != "_cls"}
            cached = opts["_cls"] = (key, wire, clean)
        key, wire, clean_opts = cached
        msg["opts"] = clean_opts
        item = _TaskItem(msg, oids, opts.get("retries", 0),
                         opts.get("name", ""))
        # Dependency resolution BEFORE dispatch (reference:
        # ``DependencyResolver``, transport/dependency_resolver.h): a task
        # whose ObjectRef args are still being computed must not occupy a
        # leased worker — it would block in arg-load while its producers
        # queue behind it, deadlocking multi-stage pipelines.
        unresolved: List[ObjectID] = []
        for oid_b in deps or ():
            d_oid = ObjectID(bytes(oid_b))
            if d_oid in self._memory_store:
                continue
            fut = self._object_futures.get(d_oid)
            if fut is None or not fut.done():
                unresolved.append(d_oid)
        if unresolved:
            self._defer_for_deps(key, wire, item, unresolved)
        else:
            with self._out_lock:
                self._out_q.append(("task", key, wire, item))
                wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
            if wake:
                self.loop.call_soon_threadsafe(self._drain_out)
        return refs

    def _defer_for_deps(self, key: str, wire: dict, item: _TaskItem,
                        deps: List[ObjectID]):
        item.deps_left = len(deps)

        def on_dep(_fut):
            with self._out_lock:
                item.deps_left -= 1
                if item.deps_left != 0:
                    return
                self._out_q.append(("task", key, wire, item))
                wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
            if wake:
                self.loop.call_soon_threadsafe(self._drain_out)

        for fut in self.object_futures(deps):
            fut.add_done_callback(on_dep)

    def _send_gcs(self, msg: dict):
        if self.gcs is not None and not self.gcs.closed:
            try:
                self.gcs.send(msg)
            except ConnectionError:
                pass

    def send_gcs_threadsafe(self, msg: dict):
        """Queue a fire-and-forget GCS message from any thread.

        A burst of messages (e.g. a submit loop) costs one loop wakeup and,
        with connection write coalescing, one syscall — the analog of the
        reference's batched gRPC stream writes."""
        with self._out_lock:
            self._out_q.append(msg)
            wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
        if wake:
            self.loop.call_soon_threadsafe(self._drain_out)

    # --------------------------------------------------- direct task leases

    def _pump_class(self, cls: _TaskClass):
        """Dispatch queued tasks onto leased workers; grow/shrink leases.

        The per-lease pipeline depth is ADAPTIVE: the base window bounds
        commitment for ordinary traffic, but for classes whose tasks are
        MEASURED fast (EWMA of observed durations) a backlog deepens the
        pipeline toward ``lease_window_max`` — each refill round-trip
        costs a driver<->worker scheduling ping-pong, the dominant
        per-task cost for tiny-task storms on few cores (measured: 8->32
        deep cut context switches per task 1.4->0.4 and lifted the
        microbench ~45%). Slow or not-yet-measured classes keep the base
        window, so a long task never gets a deep queue committed behind
        it. Scale-out demand is computed from the PRE-drain backlog
        against base-window capacity — deep pipelining never reduces the
        number of workers requested vs the fixed-window behavior."""
        live = [l for l in cls.leases.values()
                if not l.dead and (l.conn is None or not l.conn.closed)]
        n_leases = len(live)
        backlog0 = len(cls.queue)
        # Free capacity at the BASE window, measured before the drain:
        # scale-out fires whenever the backlog would not have fit in the
        # fixed-window regime, regardless of how deep the adaptive drain
        # below goes.
        free_base = sum(max(0, _LEASE_WINDOW - l.busy) for l in live)
        fast = cls.avg_s is not None and cls.avg_s < 0.005
        window = _LEASE_WINDOW
        if fast:
            window = min(max(_LEASE_WINDOW, backlog0 // max(n_leases, 1)),
                         _LEASE_WINDOW_MAX)
        for lease in list(cls.leases.values()):
            if lease.dead:
                cls.leases.pop(lease.wid, None)
                continue
            if lease.conn is None or lease.conn.closed:
                continue
            while cls.queue and lease.busy < window:
                if not self._send_exec(cls, lease, cls.queue.popleft()):
                    break  # lease broke mid-pump: stop dispatching to it
            if not cls.queue and lease.busy == 0 and lease.idle_handle is None:
                lease.idle_handle = self.loop.call_later(
                    _LEASE_IDLE_RETURN_S, self._return_lease, cls, lease)
        if backlog0:
            want = min(backlog0, _MAX_LEASES_PER_CLASS) - len(cls.leases) \
                - cls.demand
            if want > 0 and backlog0 > free_base \
                    and not self._gcs_backpressured:
                cls.demand += want
                self._send_gcs({"t": "lease_req", "key": cls.key,
                                "n": want, **cls.wire})

    def _send_exec(self, cls: _TaskClass, lease: _Lease,
                   item: _TaskItem) -> bool:
        """Returns False when the lease broke (caller must stop using it)."""
        if item.cancelled:
            self._finish_item_error(
                item, serialization.TaskCancelledError("cancelled"))
            return True
        if lease.idle_handle is not None:
            lease.idle_handle.cancel()
            lease.idle_handle = None
        if lease.gpus:
            item.msg["gpus"] = lease.gpus
        try:
            fut = lease.conn.request_nowait(item.msg)
        except ConnectionError:
            cls.queue.appendleft(item)
            self._on_lease_broken(cls, lease)
            return False
        lease.busy += 1
        self._inflight[item.msg["tid"]] = ("inflight", cls, lease, item)
        fut.add_done_callback(
            lambda f, c=cls, l=lease, it=item: self._on_exec_reply(f, c, l,
                                                                   it))
        return True

    def _on_exec_reply(self, fut: asyncio.Future, cls: _TaskClass,
                       lease: _Lease, item: _TaskItem):
        lease.busy -= 1
        tid = item.msg["tid"]
        self._inflight.pop(tid, None)
        if fut.cancelled() or fut.exception() is not None:
            # Worker died mid-task (lease conn broke): retry elsewhere.
            self._on_lease_broken(cls, lease)
            if item.cancelled:
                self._finish_item_error(
                    item, serialization.TaskCancelledError("cancelled"))
            elif item.retries != 0:
                item.retries -= 1 if item.retries > 0 else 0
                cls.queue.appendleft(item)
                self._inflight[tid] = ("queued", cls, item)
            else:
                self._finish_item_error(item, serialization.WorkerCrashedError(
                    "worker died while executing task"))
            self._pump_class(cls)
            return
        reply = fut.result()
        results = reply["results"]
        self.push_result(tid, results)
        # Observed duration feeds the adaptive pipeline window.
        dur = max(0.0, reply.get("t1", 0.0) - reply.get("t0", 0.0))
        cls.avg_s = dur if cls.avg_s is None else 0.8 * cls.avg_s + 0.2 * dur
        # Positional: (tid, name, error, created, start, end, wid).
        self._queue_task_note((
            tid, item.name, 1 if reply.get("err") else 0, item.created,
            reply.get("t0", 0.0), reply.get("t1", 0.0), lease.wid))
        # Keep the spec for owner-side lineage reconstruction
        # (reference: ObjectRecoveryManager, object_recovery_manager.h:41)
        # while the object may still be lost; dropped on ref release. A
        # retained spec pins the task's args too — a reconstruction resubmit
        # resends the same msg — so args release when the spec drops.
        if not reply.get("err") and item.retries != 0:
            for r in results:
                if not r.get("shm"):
                    continue
                # Only retain a spec while this process still holds a live
                # local ref to the result: a ref dropped BEFORE completion
                # already flushed its -1 (the spec-drop trigger), so a spec
                # retained now would never be un-pinned — leaking the spec
                # and the task's arg bundle.
                oid = ObjectID(bytes(r["oid"]))
                with self._ref_lock:
                    live = self._live_refs.get(oid, 0) > 0
                if live:
                    self._retain_spec(oid.binary(), cls.key, cls.wire,
                                      item)
        # Terminal disposition of this execution: drop its args pin.
        self._args_unpin(item)
        self._pump_class(cls)

    def _finish_item_error(self, item: _TaskItem, exc: Exception):
        err = serialize(exc).to_bytes()
        self.push_result(item.msg["tid"], [
            {"oid": oid.binary(), "nbytes": len(err), "data": err,
             "err": True}
            for oid in item.oids])
        self._queue_task_note((
            item.msg["tid"], item.name, 1, item.created, 0.0, 0.0, None))
        # Terminal disposition: drop the execution's args pin (other
        # outputs' retained specs may still hold their own pins).
        self._args_unpin(item)

    def _on_lease_broken(self, cls: _TaskClass, lease: _Lease):
        if lease.dead:
            return
        lease.dead = True
        cls.leases.pop(lease.wid, None)
        self._leases_by_wid.pop(lease.wid, None)
        if lease.idle_handle is not None:
            lease.idle_handle.cancel()
            lease.idle_handle = None
        if lease.conn is not None and not lease.conn.closed:
            self.loop.create_task(lease.conn.close())

    def _return_lease(self, cls: _TaskClass, lease: _Lease):
        lease.idle_handle = None
        if lease.dead or cls.queue or lease.busy > 0:
            self._pump_class(cls)
            return
        lease.dead = True
        cls.leases.pop(lease.wid, None)
        self._leases_by_wid.pop(lease.wid, None)
        self._send_gcs({"t": "lease_ret", "wid": lease.wid})
        if lease.conn is not None and not lease.conn.closed:
            self.loop.create_task(lease.conn.close())

    def _on_lease_grant(self, msg: dict):
        cls = self._task_classes.get(msg["key"])
        if cls is not None:
            cls.demand = max(0, cls.demand - 1)
        if cls is None or (not cls.queue and not cls.leases):
            # Demand evaporated — hand the worker straight back.
            self._send_gcs({"t": "lease_ret", "wid": msg["wid"]})
            return
        lease = _Lease(bytes(msg["wid"]), msg["addr"], msg.get("gpus"))
        cls.leases[lease.wid] = lease
        self._leases_by_wid[lease.wid] = (cls, lease)
        self.loop.create_task(self._connect_lease(cls, lease))

    async def _connect_lease(self, cls: _TaskClass, lease: _Lease):
        try:
            reader, writer = await protocol.connect(lease.addr)
        except OSError:
            self._on_lease_broken(cls, lease)
            self._send_gcs({"t": "lease_ret", "wid": lease.wid})
            self._pump_class(cls)
            return
        lease.conn = protocol.Connection(reader, writer)
        lease.conn.start()
        self._pump_class(cls)

    def _on_lease_dead(self, msg: dict):
        entry = self._leases_by_wid.get(bytes(msg["wid"]))
        if entry is None:
            return
        cls, lease = entry
        self._on_lease_broken(cls, lease)
        # In-flight replies fail via the closing conn; just refresh demand.
        self._pump_class(cls)

    def _on_lease_revoked(self, msg: dict):
        """Graceful lease revocation (node drain): stop pushing NEW tasks
        through this lease, but leave its connection OPEN so in-flight
        pushes finish normally — they have until the drain deadline. If
        the worker dies at the deadline instead, the connection errors
        and ``_on_exec_reply``'s normal retry path covers the remainder.
        Replacement capacity is re-requested immediately; the GCS grants
        it off the draining node."""
        entry = self._leases_by_wid.get(bytes(msg["wid"]))
        if entry is None:
            return
        cls, lease = entry
        if lease.dead:
            return
        lease.dead = True  # _pump_class skips + drops dead leases
        cls.leases.pop(lease.wid, None)
        self._leases_by_wid.pop(lease.wid, None)
        if lease.idle_handle is not None:
            lease.idle_handle.cancel()
            lease.idle_handle = None
        self._pump_class(cls)

    def _on_lease_nudge(self):
        """The GCS has blocked placement demand (a deferred placement
        group) while we hold warm-but-idle leases: return them now
        instead of at the ``lease_idle_return_s`` timer. Busy leases and
        classes with queued work keep their capacity — the nudge only
        surrenders what is idle at this instant, so task latency never
        pays for it (a later burst simply re-requests leases)."""
        for cls in list(self._task_classes.values()):
            if cls.queue:
                continue
            for lease in list(cls.leases.values()):
                if not lease.dead and lease.busy == 0:
                    if lease.idle_handle is not None:
                        lease.idle_handle.cancel()
                    self._return_lease(cls, lease)

    def _retain_spec(self, oid_b: bytes, key: str, wire: dict,
                     item: _TaskItem):
        old = self._task_specs.get(oid_b)
        if old is not None and old[2] is not item:
            self._args_unpin(old[2])
        if old is None or old[2] is not item:
            item.args_pins += 1
        self._task_specs[oid_b] = (key, wire, item)

    def _args_unpin(self, item: _TaskItem):
        item.args_pins -= 1
        if item.args_pins <= 0:
            self.release_task_args(item.msg)

    def maybe_reconstruct(self, object_id: ObjectID) -> bool:
        """Owner-side lineage reconstruction: resubmit the producing task
        for a lost object (reference: object_recovery_manager.h:41)."""
        spec = self._task_specs.pop(object_id.binary(), None)
        if spec is None:
            return False
        key, wire, item = spec
        # args_pins unchanged: the popped spec's pin transfers to the
        # resubmission now entering flight (its terminal disposition in
        # _on_exec_reply/_finish_item_error decrements it).
        with self._wait_lock:
            for oid in item.oids:
                self._object_futures[oid] = SlimFuture()
        item.retries -= 1 if item.retries > 0 else 0
        with self._out_lock:
            self._out_q.append(("task", key, wire, item))
            wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
        if wake:
            self.loop.call_soon_threadsafe(self._drain_out)
        return True

    def cancel_task(self, tid: TaskID, force: bool):
        entry = self._inflight.get(tid.binary())
        if entry is not None:
            def _do_cancel():
                e = self._inflight.get(tid.binary())
                if e is None:
                    return
                if e[0] == "queued":
                    _, cls, item = e
                    item.cancelled = True
                    try:
                        cls.queue.remove(item)
                    except ValueError:
                        pass
                    self._inflight.pop(tid.binary(), None)
                    self._finish_item_error(
                        item, serialization.TaskCancelledError(tid.hex()))
                else:
                    _, cls, lease, item = e
                    item.cancelled = True
                    if lease.conn is not None and not lease.conn.closed:
                        lease.conn.send({"t": "cancel",
                                         "tid": tid.binary(),
                                         "force": force})
            self.loop.call_soon_threadsafe(_do_cancel)
            return
        self.send_gcs_threadsafe(
            {"t": "task_cancel", "tid": tid.binary(), "force": force})

    # --------------------------------------------------------------- actors

    def create_actor_msg(self, fid: str, msg_args: dict, opts: dict) -> ActorID:
        aid = ActorID.from_random()
        # Same retry contract as the KV surface: the aid is OURS, so a
        # re-send across a GCS crash-restart is idempotent (the GCS
        # dedups actor_create by aid, re-linking the owner) — without
        # this, Actor.remote() during the restart window surfaced a raw
        # ConnectionError (found by a verify drive).
        reply = self._request_kv({
            "t": "actor_create", "aid": aid.binary(), "fid": fid,
            "opts": opts, **msg_args})
        if not reply.get("ok"):
            # The bundle will never be consumed — release it now.
            if msg_args.get("argsref") is not None:
                self._release_arg_ref(ObjectID(bytes(msg_args["argsref"])))
            raise ValueError(reply.get("err", "actor creation failed"))
        # A shm ctor-arg bundle must survive actor RESTARTS (the GCS
        # resends the same creation msg); release it only on permanent
        # death (the actor_dead push in _on_gcs_push).
        if msg_args.get("argsref") is not None:
            self._actor_ctor_args[aid] = ObjectID(bytes(msg_args["argsref"]))
        return aid

    def submit_actor_task_msg(self, actor_id: ActorID, method: str,
                              msg_args: dict, num_returns: int,
                              opts: dict) -> List[ObjectRef]:
        tid = TaskID.fast_unique()
        refs = []
        oids = []
        for i in range(num_returns):
            oid = ObjectID.for_task_return(tid, i + 1)
            fut = SlimFuture()
            self._object_futures[oid] = fut
            oids.append(oid)
            refs.append(ObjectRef(oid, self))
        # "_sg" (direct-lane SerializedObject, remote._prepare_args) stays
        # attached to the call dict: every send site strips it before
        # packing and hands its raw buffers to the transport out-of-band;
        # keeping it on the dict preserves the payload across the retry /
        # reconnect paths, which re-dispatch the same dict.
        call = {"t": "actor_call", "aid": actor_id.binary(),
                "tid": tid.binary(), "m": method,
                "nret": num_returns, "opts": opts,
                "owner": self.worker_id.binary(), **msg_args}
        item = ("actor", actor_id, call, oids, opts.get("retries", 0))
        with self._out_lock:
            self._out_q.append(item)
            wake = not self._drain_scheduled
            if wake:
                self._drain_scheduled = True
        if wake:
            self.loop.call_soon_threadsafe(self._drain_out)
        return refs

    def _drain_out(self):  # runs on the IO loop
        with self._out_lock:
            self._drain_scheduled = False
            if not self._out_q:
                return
            msgs = list(self._out_q)
            self._out_q.clear()
        pumped = set()
        gcs_down = self.gcs is None or self.gcs.closed
        retained: List[dict] = []
        # Frame coalescing for the contained-ref fan-in: a serialize pass
        # over an object holding k nested refs enqueues k "ref" increfs
        # (and up to k promote "obj_put"s) back-to-back. Within a
        # contiguous run of fire-and-forget ref/obj_put frames the two
        # kinds commute (the directory parks early deltas), so the run
        # collapses to ONE ref frame + ONE obj_puts frame — emitted
        # before the next non-mergeable message, preserving the
        # registration-before-carrier and incref-before-carrier orders.
        ref_rows: list = []
        put_objs: List[dict] = []

        def _flush_merged():
            if put_objs:
                if len(put_objs) == 1:
                    self._send_gcs(put_objs[0])
                else:
                    self._send_gcs({"t": "obj_puts", "objs": put_objs})
                put_objs.clear()  # pack() copied synchronously
            if ref_rows:
                self._send_gcs({"t": "ref", "d": ref_rows})
                ref_rows.clear()

        for m in msgs:
            if isinstance(m, dict):
                if gcs_down:
                    # Keep GCS-bound messages (put registrations, refs)
                    # until the reconnect lands — dropping them would
                    # orphan objects the user already holds refs to.
                    retained.append(m)
                    continue
                t = m.get("t")
                if m.get("i") is None:
                    if t == "ref":
                        ref_rows.extend(m["d"])
                        continue
                    if t == "obj_put":
                        put_objs.append(m)
                        continue
                    if t == "obj_puts":
                        put_objs.extend(m["objs"])
                        continue
                _flush_merged()
                self._send_gcs(m)
            elif m[0] == "actor":
                _flush_merged()
                self._dispatch_actor_call(*m[1:])
            else:  # ("task", key, wire, item)
                _flush_merged()
                _, key, wire, item = m
                cls = self._task_classes.get(key)
                if cls is None:
                    cls = self._task_classes[key] = _TaskClass(key, wire)
                cls.queue.append(item)
                self._inflight[item.msg["tid"]] = ("queued", cls, item)
                pumped.add(key)
        _flush_merged()
        if retained:
            with self._out_lock:
                # Prepend so original order holds when the link returns.
                for m in reversed(retained):
                    self._out_q.appendleft(m)
        for key in pumped:
            self._pump_class(self._task_classes[key])

    def _dispatch_actor_call(self, actor_id: ActorID, call: dict,
                             oids: List[ObjectID], retries: int):
        """Send an actor call, preserving per-actor FIFO submission order.

        Fast path (established connection, empty backlog): synchronous
        ``request_nowait`` — no coroutine, no lock; the reply resolves via a
        future callback. Calls made before the connection exists queue on
        the channel and are flushed in order by the connect task."""
        ch = self._actor_chans.get(actor_id)
        if ch is None:
            ch = self._actor_chans[actor_id] = _ActorChannel()
        if ch.conn is not None and not ch.conn.closed and not ch.sendq:
            try:
                fut = self._send_actor_call(ch.conn, call)
            except ConnectionError:
                self._actor_call_failed(actor_id, call, oids, retries,
                                        ConnectionError("connection closed"))
                return
            fut.add_done_callback(
                lambda f: self._on_actor_reply(f, actor_id, call, oids,
                                               retries))
            return
        ch.sendq.append((call, oids, retries))
        if not ch.connecting:
            ch.connecting = True
            self.loop.create_task(self._connect_and_flush(actor_id, ch))

    @staticmethod
    def _send_actor_call(conn: protocol.Connection,
                         call: dict) -> asyncio.Future:
        """Send one actor call, routing direct-lane args out-of-band.

        The "_sg" SerializedObject is stripped for the duration of the
        pack (it is not wire-serializable) and re-attached afterwards so
        a retry re-sends the same payload; its pickle5 buffers go to the
        transport as memoryviews — the zero-copy direct arg lane.
        """
        sobj = call.pop("_sg", None)
        try:
            if sobj is not None:
                return conn.request_nowait(call, buffers=sobj.buffers)
            return conn.request_nowait(call)
        finally:
            if sobj is not None:
                call["_sg"] = sobj

    async def _connect_and_flush(self, actor_id: ActorID, ch: _ActorChannel):
        try:
            if ch.conn is None or ch.conn.closed:
                if actor_id in self._dead_actors:
                    raise ActorDiedError(self._dead_actors[actor_id])
                reply = await self.gcs.request(
                    {"t": "actor_get", "aid": actor_id.binary()})
                if not reply.get("ok"):
                    self._dead_actors[actor_id] = reply.get("err",
                                                            "actor died")
                    raise ActorDiedError(self._dead_actors[actor_id])
                reader, writer = await protocol.connect(reply["addr"])
                conn = protocol.Connection(reader, writer)
                conn.start()
                ch.addr = reply["addr"]
                ch.conn = conn
        except (ConnectionError, OSError, ActorDiedError) as e:
            ch.connecting = False
            backlog, ch.sendq = list(ch.sendq), deque()
            exc = (e if isinstance(e, ActorDiedError)
                   else ConnectionError(str(e)))
            for call, oids, retries in backlog:
                self._actor_call_failed(actor_id, call, oids, retries, exc)
            return
        ch.connecting = False
        self._flush_channel(actor_id, ch)

    def _flush_channel(self, actor_id: ActorID, ch: _ActorChannel):
        """Send the channel's backlog synchronously — order preserved, one
        coalesced write for the whole burst."""
        while ch.sendq:
            call, oids, retries = ch.sendq.popleft()
            try:
                fut = self._send_actor_call(ch.conn, call)
            except ConnectionError as e:
                self._actor_call_failed(actor_id, call, oids, retries, e)
                continue
            fut.add_done_callback(
                lambda f, c=call, o=oids, r=retries:
                    self._on_actor_reply(f, actor_id, c, o, r))

    async def _get_actor_conn(self, actor_id: ActorID) -> _ActorChannel:
        """Resolve and return the actor's live channel (addr + conn).

        Cold-path helper for callers that need the raw connection (the
        compiled-DAG compiler); actor calls use ``_dispatch_actor_call``.
        """
        ch = self._actor_chans.get(actor_id)
        if ch is None:
            ch = self._actor_chans[actor_id] = _ActorChannel()
        while ch.connecting:
            await asyncio.sleep(0.005)
        if ch.conn is not None and not ch.conn.closed:
            return ch
        if actor_id in self._dead_actors:
            raise ActorDiedError(self._dead_actors[actor_id])
        ch.connecting = True
        try:
            reply = await self.gcs.request(
                {"t": "actor_get", "aid": actor_id.binary()})
            if not reply.get("ok"):
                self._dead_actors[actor_id] = reply.get("err", "actor died")
                raise ActorDiedError(self._dead_actors[actor_id])
            reader, writer = await protocol.connect(reply["addr"])
            ch.addr = reply["addr"]
            ch.conn = protocol.Connection(reader, writer)
            ch.conn.start()
        finally:
            ch.connecting = False
        # Calls queued by _dispatch_actor_call while we were connecting
        # would otherwise strand (their flush task was suppressed by the
        # connecting flag).
        self._flush_channel(actor_id, ch)
        return ch

    def _on_actor_reply(self, fut: asyncio.Future, actor_id: ActorID,
                        call: dict, oids: List[ObjectID], retries: int):
        if fut.cancelled():
            exc: Optional[BaseException] = ConnectionError("call cancelled")
        else:
            exc = fut.exception()
        if exc is not None:
            self._actor_call_failed(actor_id, call, oids, retries, exc)
            return
        reply = fut.result()
        results = reply["results"]
        # Register large (shm) actor-call results with the GCS: we are
        # the owner; this makes the ref resolvable by borrowers. One
        # coalesced frame for the whole result set (obj_puts) — a
        # num_returns=N call used to cost N object-plane frames.
        # ``nh`` (no holder): the object lives in the ACTOR's node
        # arena, not ours — the executing worker registers the true
        # holder on its own connection (worker_main
        # _register_shm_results). Recording the caller's node here made
        # every cross-node actor result unpullable (driver connections
        # carry no node_id → zero holders; worker callers recorded a
        # node whose arena never held the object). This frame still
        # matters for ordering: it rides OUR GCS connection ahead of
        # any locate/borrow traffic we emit for the ref.
        shm_rs = [r for r in results if r.get("shm")]
        if shm_rs:
            self._send_gcs({"t": "obj_puts", "objs": [
                {"oid": r["oid"], "nbytes": r["nbytes"], "shm": True,
                 "nh": 1}
                for r in shm_rs]})
        self.push_result(call["tid"], results)
        self.release_task_args(call)

    def _actor_call_failed(self, actor_id: ActorID, call: dict,
                           oids: List[ObjectID], retries: int,
                           exc: BaseException):
        if retries != 0 and isinstance(exc, (ConnectionError, ActorDiedError)):
            # Re-resolve (the actor may be restarting) and try again.
            ch = self._actor_chans.get(actor_id)
            if ch is not None and (ch.conn is None or ch.conn.closed):
                self._actor_chans.pop(actor_id, None)
            self.loop.call_later(
                0.05, self._dispatch_actor_call, actor_id, call, oids,
                retries - 1 if retries > 0 else retries)
            return
        cause = self._dead_actors.get(actor_id, str(exc) or "actor died")
        err = serialize(ActorDiedError(cause)).to_bytes()
        self.push_result(call["tid"], [
            {"oid": oid.binary(), "nbytes": len(err), "data": err}
            for oid in oids])
        self.release_task_args(call)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.loop.call_soon_threadsafe(self._send_gcs, {
            "t": "actor_kill", "aid": actor_id.binary(),
            "no_restart": no_restart})

    def get_actor_id_by_name(self, name: str, namespace: Optional[str]) -> ActorID:
        reply = self.run_async(self.gcs.request({
            "t": "actor_by_name", "name": name, "namespace": namespace}))
        if not reply.get("ok"):
            raise ValueError(reply.get("err"))
        return ActorID(reply["aid"])

    # ------------------------------------------------------------------ kv

    def _request_kv(self, msg: dict, timeout: float = 30.0) -> dict:
        """KV-surface request that rides out a GCS crash-restart.

        KV ops are idempotent (last-write-wins / pure reads), so
        retrying across the reconnect window is safe — and without it
        every driver-facing kv_put/kv_get during a restart surfaced a
        raw ConnectionError through public API calls like
        ``Actor.remote()`` (chaos: gcs_crash_mid_direct_args landed on
        the fn-export kv append). ``self.gcs`` is re-read per attempt:
        the reconnect task swaps in the fresh connection."""
        from .backoff import Backoff

        backoff = Backoff(cap=0.5)
        deadline = time.time() + 20.0
        attempts = 0
        while True:
            try:
                return self.run_async(self.gcs.request(dict(msg)), timeout)
            except (ConnectionError, SyncTimeoutError):
                attempts += 1
                # Always allow one retry even past the deadline: a
                # SyncTimeoutError burns the full per-attempt timeout
                # before it ever raises, which used to make the timeout
                # branch structurally unretryable (frame lost on a LIVE
                # connection surfaced raw after one attempt).
                if self.closed or (time.time() > deadline
                                   and attempts >= 2):
                    raise
                time.sleep(backoff.next_delay())

    def kv_put(self, key: str, value: bytes, ns: str = ""):
        self._request_kv({"t": "kv_put", "ns": ns, "k": key, "v": value})

    def note_export(self, ns: str, key: str, blob: bytes):
        """Shadow a code-export kv_put for GCS-restart replay (see
        ``_kv_exports``)."""
        self._kv_exports[(ns, key)] = blob

    def kv_get(self, key: str, ns: str = "") -> Optional[bytes]:
        reply = self.run_async(self.gcs.request(
            {"t": "kv_get", "ns": ns, "k": key}))
        return reply.get("v") if reply.get("ok") else None

    def kv_del(self, key: str, ns: str = ""):
        self.run_async(self.gcs.request({"t": "kv_del", "ns": ns, "k": key}))

    def kv_keys(self, prefix: str = "", ns: str = "") -> List[str]:
        reply = self.run_async(self.gcs.request(
            {"t": "kv_keys", "ns": ns, "prefix": prefix}))
        return reply.get("keys", [])

    # ----------------------------------------------------------- inspection

    def cluster_info(self) -> dict:
        return self.run_async(self.gcs.request({"t": "cluster_info"}))

    def request_gcs(self, msg: dict, timeout: Optional[float] = 60) -> dict:
        return self.run_async(self.gcs.request(msg), timeout)

    def request_gcs_future(self, msg: dict):
        """Fire a GCS request from any thread without blocking; returns a
        ``concurrent.futures.Future`` resolving to the reply dict (the
        placement-group create path — callers that want a handle now and
        the reply later, without a helper thread per call)."""
        return asyncio.run_coroutine_threadsafe(
            self.gcs.request(msg), self.loop)
