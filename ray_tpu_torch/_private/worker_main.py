"""Worker process: task/actor executor.

Analog of the reference's worker-side CoreWorker loop
(``CoreWorker::RunTaskExecutionLoop`` ``core_worker.h:326`` +
``TaskReceiver::HandleTask`` ``transport/task_receiver.h:91``): receives
tasks from the GCS scheduler over its control connection, receives direct
actor calls on its own listening socket, executes Python functions on an
executor thread (sequential per actor, matching the reference's
``ActorSchedulingQueue`` ordering), and writes results inline or to the
shared-memory store.

Workers deliberately do NOT import jax/numpy at startup: heavyweight imports
happen inside user functions, so per-task ``runtime_env['env_vars']`` (e.g.
``JAX_PLATFORMS``) set before the import still takes effect.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import os
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch.util import events as plane_events

from . import failpoints, protocol, serialization
from .ids import ActorID, ObjectID, TaskID, WorkerID
from .serialization import deserialize, pack_error, serialize
from .worker import ObjectRef, Worker, set_global_worker


_MISSING = object()


def _boot_ts(label: str):
    """Env-gated boot diagnostics (RAY_TPU_TORCH_BOOT_TS=1): prints this
    process's cumulative CPU at each boot phase to the worker log — the
    tool that found the 87 ms/actor launch-storm costs (arena walk,
    per-child module imports)."""
    if os.environ.get("RAY_TPU_TORCH_BOOT_TS"):
        import resource

        r = resource.getrusage(resource.RUSAGE_SELF)
        print(f"BOOT {label} cpu={r.ru_utime + r.ru_stime:.3f} "
              f"flt={r.ru_minflt}", file=sys.stderr, flush=True)


class Executor:
    def __init__(self, worker: Worker, listen_path: str):
        self.worker = worker
        self.listen_path = listen_path
        self.fn_cache: Dict[str, Any] = {}
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self.actor_opts: dict = {}
        # Sequential executor preserves actor method ordering.
        self.pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="exec")
        # Plain (non-actor) tasks run concurrently: the lease window
        # pipelines several pushes onto this worker, and a BLOCKING task
        # (collective rendezvous, sleep, IO) must not wedge the ones queued
        # behind it — the thread pool gives queued tasks their own stack
        # while the GIL keeps CPU-bound work effectively serial.
        from .config import config as _cfg

        self.task_pool = ThreadPoolExecutor(
            max_workers=_cfg().task_pool_threads, thread_name_prefix="task")
        self.async_sem: Optional[asyncio.Semaphore] = None
        self.running_tasks: Dict[bytes, int] = {}  # tid -> thread ident
        self.cancelled: set = set()
        self.die_after_task = False
        self.pinned_gpus: Optional[List[str]] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._direct_q: deque = deque()  # (conn, msg) leased exec pushes
        # Batched sync actor-call pump (see _drain_sync_calls).
        self._sync_calls: deque = deque()
        self._sync_pump_running = False
        self._batch_sync = False
        # method name -> (underlying function, is_sync): caches only the
        # iscoroutinefunction verdict (the inspect flag walk was ~6% of
        # worker CPU in the n:n profile), validated per call against the
        # re-resolved attribute's function identity so rebinds recompute.
        self._method_sync_cache: Dict[str, tuple] = {}
        # Batched task-completion delivery (see _flush_exec_replies).
        self._exec_done: deque = deque()
        self._exec_wake_scheduled = False
        self._exec_wake_lock = threading.Lock()
        self._draining = False
        self.dags: Dict[str, dict] = {}  # compiled-DAG stage plans
        # TaskEventBuffer (reference: task_event_buffer.h:220): bounded local
        # buffer of profile events, flushed to the GCS periodically.
        self.events: List[dict] = []

    def record_event(self, tid: bytes, name: str, kind: str,
                     start: float, end: float, ok: bool):
        # Positional rows; per-worker constants (wid/nid/pid) ride once per
        # flushed batch, not once per event — this runs on every task.
        if len(self.events) < 10_000:
            self.events.append((bytes(tid), name, kind, start, end,
                                1 if ok else 0))

    def flush_events(self):
        # Piggyback tracing spans (one-shot die_after_task workers exit
        # right after this — the 0.5s flush loop won't get another tick).
        tracing = sys.modules.get("ray_tpu_torch.util.tracing")
        if tracing is not None and tracing.pending_spans():
            try:
                tracing.flush_to_kv(self.worker)
            except Exception:
                pass
        # Plane-event recorder rows ride the same coalesced cadence as
        # task_events: one drain + one frame per tick.
        if (plane_events.pending()
                and self.worker.gcs and not self.worker.gcs.closed):
            rows, drops = plane_events.drain()
            if rows or drops:
                try:
                    self.worker.gcs.send({
                        "t": "plane_events", "ev": rows, "drops": drops,
                        "nid": self.worker.node_id or b"",
                        "pid": os.getpid()})
                except ConnectionError:
                    pass
        if self.events and self.worker.gcs and not self.worker.gcs.closed:
            batch, self.events = self.events, []
            try:
                self.worker.gcs.send({
                    "t": "task_events", "ev": batch,
                    "wid": self.worker.worker_id.binary(),
                    "nid": self.worker.node_id or b"",
                    "pid": os.getpid()})
            except ConnectionError:
                pass

    async def start(self):
        self._server = await protocol.serve(
            "unix:" + self.listen_path, self._on_direct_client)

    async def _on_direct_client(self, reader, writer):
        conn = protocol.Connection(reader, writer)
        conn._handler = lambda msg: self._on_direct_msg(conn, msg)
        conn.start()

    async def _on_direct_msg(self, conn: protocol.Connection, msg: dict):
        t = msg.get("t")
        if t is not None and plane_events._enabled:
            # Worker dispatch lane: aggregate counter (per-frame plane —
            # this is the actor-call hot path).
            plane_events.count("proto.dispatch.worker", key=t)
        if t is None:
            # Empty/typeless frame (undecodable-frame placeholder from
            # protocol.read_frame, or a malformed peer): skip explicitly —
            # falling through the handler chain with t=None must never
            # match, and a reply-correlated fragment must not be executed.
            return
        if t in ("actor_call", "exec") and failpoints.active():
            # Worker-dispatch failpoints (the kill-mid-call chaos class):
            # ``worker.exec`` hits between the lease grant and the first
            # result; ``worker.direct_arg`` hits only calls whose args
            # rode the out-of-band direct lane — a SIGKILL here exercises
            # the owner's retry with the direct payload re-shipped.
            failpoints.fire("worker.exec", t)
            if msg.get("_bufs"):
                failpoints.fire("worker.direct_arg")
        if t == "actor_call":
            # Fast path for plain sync methods on a max_concurrency=1
            # actor: calls batch through ONE executor-thread hop per
            # burst (see _drain_sync_calls) — the per-call thread
            # round-trip (queue + loop self-wakeup + future) dominated
            # worker CPU in the n:n async benchmark. Async methods and
            # concurrency-group actors keep the general path.
            if self._batch_sync and self.actor_instance is not None:
                name = msg["m"]
                # Re-resolve the attribute per call (an actor may rebind
                # an instance-attribute callable mid-life); only the
                # iscoroutinefunction verdict is cached, validated by the
                # underlying function's identity so a rebind recomputes.
                method = getattr(self.actor_instance, name, None)
                fn = getattr(method, "__func__", method)
                cached = self._method_sync_cache.get(name)
                if cached is None or cached[0] is not fn:
                    cached = (fn, method is not None
                              and not asyncio.iscoroutinefunction(method))
                    self._method_sync_cache[name] = cached
                is_sync = cached[1]
                if is_sync:
                    self._sync_calls.append((conn, msg, method))
                    if not self._sync_pump_running:
                        self._sync_pump_running = True
                        asyncio.get_running_loop().run_in_executor(
                            self.pool, self._drain_sync_calls)
                    return
            asyncio.get_running_loop().create_task(
                self._run_actor_call(conn, msg))
        elif t == "exec":
            # Leased direct task push (reference: PushTask straight to the
            # leased worker, core_worker.proto:444) — the reply carries the
            # results back to the owner without a GCS hop.
            self._direct_q.append((conn, msg))
            if not self._draining:
                self._draining = True
                asyncio.get_running_loop().create_task(self._drain_execs())
        elif t == "stream_call":
            # Streaming actor call (reference: streaming generators,
            # _raylet.pyx:1079): generator results flow back as chunk
            # frames on this connection; a single non-generator value is
            # one chunk. The final reply frame closes the stream.
            asyncio.get_running_loop().create_task(
                self._run_stream_call(conn, msg))
        elif t == "cancel":
            self.cancel(msg["tid"], msg.get("force", False))
        elif t == "dag_input":
            asyncio.get_running_loop().create_task(
                self._run_dag_stage(conn, msg))
        elif t == "dag_setup":
            await self._dag_setup(conn, msg)
        elif t == "dag_register_sink":
            stages = self.dags.get(msg["dag"])
            if stages is not None:
                for d in stages.values():
                    if d["sink_outputs"]:
                        d["sink"] = conn
            conn.reply(msg, {"ok": stages is not None})
        elif t == "dag_teardown":
            stages = self.dags.pop(msg["dag"], None)
            for d in (stages or {}).values():
                for target, _, _ in d["next"]:
                    if not target.closed:
                        await target.close()
            conn.reply(msg, {"ok": True})
        elif t == "obj_fetch":
            # Chunk-level broadcast relay: serve landed chunks of an
            # in-progress pull (or a sealed local object) to peer
            # pullers. Synchronous — replies must stay FIFO per conn.
            self.worker.handle_obj_fetch(conn, msg)

    # ------------------------------------------------- compiled DAG stages
    # Reference: compiled actor pipelines bypassing the normal RPC path
    # (dag/compiled_dag_node.py:668) over shared-memory/NCCL channels
    # (experimental/channel/). Here a stage receives its input on its own
    # socket, executes, and forwards DIRECTLY to the next stage's socket —
    # one hop per stage instead of a driver round-trip per stage.

    async def _dag_setup(self, conn: protocol.Connection, msg: dict):
        """Register one stage of a compiled DAG on this actor.

        General topology (reference: arbitrary compiled DAGs with an
        execution schedule, ``dag/compiled_dag_node.py:668`` +
        ``dag_node_operation.py``): a stage declares how many value slots
        it gathers per sequence number, bound constants, and a fan-out
        list of downstream (addr, stage, slot) destinations and/or sink
        output indices. Execution fires when all slots for a seq arrived.
        """
        conns: Dict[str, protocol.Connection] = {}
        for dest in msg.get("next", []):
            addr = dest["addr"]
            if addr in conns:
                continue
            try:
                reader, writer = await protocol.connect(addr)
                c = protocol.Connection(reader, writer)
                c.start()
                conns[addr] = c
            except OSError as e:
                conn.reply(msg, {"ok": False, "err": str(e)})
                return
        self.dags.setdefault(msg["dag"], {})[msg["stage"]] = {
            "method": msg["m"],
            "slots": int(msg.get("slots", 1)),
            "consts": dict(msg.get("consts") or {}),
            "kwconsts": msg.get("kwconsts"),
            "next": [(conns[d["addr"]], d["stage"], d["slot"])
                     for d in msg.get("next", [])],
            "sink_outputs": list(msg.get("sink_outputs", [])),
            "sink": None,
            "pending": {},  # seq -> {slot: (blob, err)}
        }
        conn.reply(msg, {"ok": True})

    async def _run_dag_stage(self, conn: protocol.Connection, msg: dict):
        loop = asyncio.get_running_loop()
        stages = self.dags.get(msg["dag"])
        d = stages.get(msg["stage"]) if stages else None
        if d is None:
            return
        seq = msg["seq"]
        got = d["pending"].setdefault(seq, {})
        got[int(msg.get("slot", 0))] = (msg["val"], bool(msg.get("err")))
        if len(got) < d["slots"]:
            return
        d["pending"].pop(seq, None)
        upstream_err = next((v for v, e in got.values() if e), None)
        if upstream_err is not None:
            # Propagate the first upstream error without executing.
            payload, err = upstream_err, True
        else:
            try:
                payload = await loop.run_in_executor(
                    self.pool, self._dag_stage_sync, d,
                    [got[i][0] for i in range(d["slots"])])
                err = False
            except BaseException as e:  # noqa: BLE001
                payload = pack_error(d["method"], e).to_bytes()
                err = True
        for target, stage, slot in d["next"]:
            if not target.closed:
                try:
                    target.send({"t": "dag_input", "dag": msg["dag"],
                                 "stage": stage, "slot": slot, "seq": seq,
                                 "val": payload, "err": err})
                except ConnectionError:
                    pass
        sink = d.get("sink")
        if d["sink_outputs"] and sink is not None and not sink.closed:
            for out_idx in d["sink_outputs"]:
                try:
                    sink.send({"t": "dag_output", "dag": msg["dag"],
                               "out": out_idx, "seq": seq,
                               "val": payload, "err": err})
                except ConnectionError:
                    pass

    def _dag_stage_sync(self, d: dict, blobs: List[Any]) -> bytes:
        if self.actor_instance is None:
            raise serialization.ActorDiedError("actor not initialized")
        args: List[Any] = []
        consts = d["consts"]
        n_args = d["slots"] + len(consts)
        bi = 0
        for pos in range(n_args):
            c = consts.get(pos, consts.get(str(pos), _MISSING))
            if c is not _MISSING:
                args.append(deserialize(memoryview(c)))
            else:
                args.append(deserialize(memoryview(blobs[bi])))
                bi += 1
        kwargs = (deserialize(memoryview(d["kwconsts"]))
                  if d.get("kwconsts") else {})
        out = getattr(self.actor_instance, d["method"])(*args, **kwargs)
        return serialize(out).to_bytes()

    # ------------------------------------------------------------ functions

    def _sync_driver_sys_path(self):
        """Merge the driver's sys.path so by-reference pickles resolve.

        Re-fetched on every function-cache miss (rare) rather than latched:
        a new driver connecting to a long-lived cluster updates the key and
        existing workers must pick up its module directories.
        """
        import json

        from concurrent.futures import TimeoutError as _FutTimeout

        try:
            # Rides out a GCS outage like every infra-phase read: a
            # mid-restart ConnectionError here poisoned pure tasks with
            # a non-retryable error (chaos: gcs_crash_mid_rebalance).
            blob = self._kv_get_retry("driver_sys_path", ns="",
                                      window_s=10.0)
        except (ConnectionError, TimeoutError, _FutTimeout):
            blob = None
        if not blob:
            return
        try:
            paths = json.loads(bytes(blob))
        except Exception:
            return
        for p in paths:
            if p not in sys.path:
                sys.path.append(p)

    def _get_function(self, fid: str):
        fn = self.fn_cache.get(fid)
        if fn is None:
            blob = self._kv_get_retry(fid, ns="fn")
            if blob is None:
                raise RuntimeError(f"function {fid} not found in GCS")
            self._sync_driver_sys_path()
            fn = cloudpickle.loads(blob)
            self.fn_cache[fid] = fn
        return fn

    def _kv_get_retry(self, key: str, ns: str,
                      window_s: float = 20.0) -> Optional[bytes]:
        """Control-plane KV read that rides out a GCS outage.

        A task can only be dispatched AFTER its function export landed
        (the exporter's kv_put is an awaited request), so a miss here
        means the control plane is mid-crash-recovery: either our link
        is down (ConnectionError) or the fresh instance hasn't received
        the owner's export replay yet (None). Both resolve within the
        reconnect budget — poll on the shared backoff ladder instead of
        poisoning the task with a permanent 'function not found' error
        (chaos-found: gcs_crash_pre_wal)."""
        from concurrent.futures import TimeoutError as _FutTimeout

        from .backoff import Backoff

        backoff = Backoff(cap=0.5)
        deadline = time.time() + window_s
        while True:
            try:
                blob = self.worker.kv_get(key, ns=ns)
            except (ConnectionError, TimeoutError, _FutTimeout):
                # _FutTimeout spelled out: on py3.10 (repo floor)
                # concurrent.futures.TimeoutError is NOT builtin
                # TimeoutError, and run_async re-raises the futures one.
                blob = None
            if blob is not None or time.time() > deadline:
                return blob
            time.sleep(backoff.next_delay())

    def _load_args_retry(self, msg: dict) -> Tuple[tuple, dict]:
        """_load_args that rides out control-plane outages: transient
        ConnectionErrors from arg resolution (obj_locate/pull requests on
        a closed GCS link mid-restart) retry on the shared backoff —
        they are SYSTEM faults, and surfacing one as the task's result
        would poison the caller with a non-retryable app error."""
        from .backoff import Backoff

        backoff = Backoff(cap=1.0)
        deadline = time.time() + 20.0
        while True:
            try:
                return self._load_args(msg)
            except ConnectionError:
                if time.time() > deadline:
                    raise
                time.sleep(backoff.next_delay())

    def _load_args_fast(self, msg: dict):
        """Loop-safe arg loading for coroutine dispatch: returns
        ``(args, kwargs, needs_resolve)`` when the argument BYTES can be
        materialized without blocking (no store read), else None and the
        caller takes the full executor path. ``needs_resolve`` is True
        when top-level ObjectRefs remain — the caller must finish with
        ``_resolve_top_refs`` in an executor (worker.get blocks), but
        NEVER by re-running ``_load_args``: deserializing the same
        payload twice would create two ref wrappers whose __del__ deltas
        double-debit the sender's single pickled incref.

        This is the async-def dispatch fix (MICROBENCH_r06 filed
        pathology: 0.33x the threaded-sync path): the old path paid a
        default-executor thread handoff per call — thread wake + loop
        wake back, ~50-100us — to load arguments that for the dominant
        call shapes (no args / small inline args / direct-lane args) are
        microseconds of pure CPU. Those now load inline on the actor's
        running loop."""
        ab = msg.get("args")
        bab = bytes(ab) if ab is not None else None  # one copy, reused
        if bab is not None and bab == serialization.empty_args_bytes():
            return (), {}, False
        if msg.get("argsref") is not None:  # raylint: disable=RTL123 (direct-lane field)
            return None  # shm/GCS fetch: may block
        # Definition-export references (__main__ classes/functions pickle
        # as `_load_export(token)` calls) may need a BLOCKING GCS KV
        # fetch on cache miss — run_async from the loop thread raises
        # (and blocking it would deadlock the reply delivery). Punt the
        # whole payload to the executor path BEFORE deserializing
        # anything: a partial inline unpickle that raises mid-stream
        # would already have materialized ObjectRef wrappers whose
        # __del__ debits the sender's single pickled incref, and the
        # executor retry would then double-debit it. Substring scan, so
        # a false positive (user bytes containing the marker) only costs
        # the earlier executor hop, never correctness.
        if msg.get("ap") is not None:  # raylint: disable=RTL123 (direct-lane field)
            import pickle

            bp = bytes(msg["ap"])  # raylint: disable=RTL123 (direct-lane field)
            if b"_load_export" in bp:
                return None
            args, kwargs = pickle.loads(bp,
                                        buffers=msg.get("_bufs") or [])
        elif ab is not None:
            if b"_load_export" in bab:
                return None
            args, kwargs = deserialize(memoryview(ab))
        else:
            return None
        need = any(isinstance(a, ObjectRef) for a in args) or \
            any(isinstance(v, ObjectRef) for v in kwargs.values())
        return tuple(args), kwargs, need

    def _load_args(self, msg: dict) -> Tuple[tuple, dict]:
        # No-arg calls (the hottest control-plane shape) carry one
        # canonical byte string (serialization.empty_args_bytes, shared
        # with remote._prepare_args): match it and skip the unpickle +
        # the ref-resolution scan entirely.
        ab = msg.get("args")
        if ab is not None and bytes(ab) == serialization.empty_args_bytes():
            return (), {}
        if msg.get("ap") is not None:
            # Direct-lane args (remote._prepare_args direct_ok): pickle
            # bytes in the frame header, pickle5 buffers sliced out of the
            # scatter-gather frame as memoryviews ("_bufs") — numpy/JAX
            # values rebuild over them without a copy (the frame payload
            # is immutable and stays alive through the buffer views).
            import pickle

            args, kwargs = pickle.loads(bytes(msg["ap"]),
                                        buffers=msg.get("_bufs") or [])
        elif msg.get("argsref") is not None:
            oid = ObjectID(msg["argsref"])
            view = self.worker.store.get(oid, msg.get("argsn", 0))
            if view is None:
                # Not local (other host) — fall back to a GCS fetch.
                ref = ObjectRef(oid, self.worker, borrowed=True)
                args, kwargs = self.worker.get([ref])[0]
                return args, kwargs
            args, kwargs = deserialize(view.data, pin=view.transfer())
        else:
            args, kwargs = deserialize(memoryview(msg["args"]))
        return self._resolve_top_refs(args, kwargs)

    def _resolve_top_refs(self, args, kwargs) -> Tuple[tuple, dict]:
        """Resolve top-level ObjectRef arguments (reference semantics:
        ``DependencyResolver`` inlines resolved args, nested refs stay
        refs). Positional and keyword refs resolve through ONE batched
        get — one wait-group frame for the whole argument list instead
        of a round trip per ref (the 10k-args-to-one-task shape).
        Blocking: runs off the loop."""
        flat = list(args)
        ref_idx = [i for i, a in enumerate(flat) if isinstance(a, ObjectRef)]
        kw_keys = [k for k, v in kwargs.items() if isinstance(v, ObjectRef)]
        if ref_idx or kw_keys:
            vals = self.worker.get([flat[i] for i in ref_idx]
                                   + [kwargs[k] for k in kw_keys])
            for i, v in zip(ref_idx, vals):
                flat[i] = v
            for k, v in zip(kw_keys, vals[len(ref_idx):]):
                kwargs[k] = v
        return tuple(flat), kwargs

    def _apply_runtime_env(self, opts: dict):
        renv = opts.get("runtime_env") or {}
        if not renv:
            return
        from ray_tpu_torch.runtime_env import setup_runtime_env

        ctx = setup_runtime_env(
            renv, fetch=lambda uri: self.worker.kv_get(uri, ns="pkg"),
            apply=False)
        self._hold_gpu_pin(ctx.env_vars)
        ctx.apply()
        # Env/cwd/sys.path mutations (e.g. CUDA_LAUNCH_BLOCKING) poison
        # this worker for other tasks — retire it after this task like the
        # reference's dedicated runtime-env workers.
        if ctx.taints_worker and self.actor_id is None:
            self.die_after_task = True  # raylint: disable=RTL151 (loop reads it only after the executor future resolves — happens-before)

    def _hold_gpu_pin(self, env_vars: dict):
        """``_pin_gpus`` ran first: a runtime env may not move a worker
        that holds GPUs to other cards, or its first CUDA call would use
        cards the GCS leased to someone else."""
        if self.pinned_gpus is None:
            return
        from ..accelerators import GPUPinConflictError, get_accelerator_manager

        var = get_accelerator_manager("GPU").get_visible_accelerator_ids_env_var()
        pinned = os.environ.get(var)
        if var in env_vars and str(env_vars[var]) != pinned:
            raise GPUPinConflictError(
                f"runtime_env env_vars sets {var}={env_vars[var]!r}, but "
                f"this worker's lease pinned it to GPUs {self.pinned_gpus} "
                f"({var}={pinned!r}); the lease's pin stays")

    def _pack_results(self, tid_bytes: bytes, values: List[Any],
                      register_shm: bool) -> List[dict]:
        tid = TaskID(tid_bytes)
        out = []
        for i, value in enumerate(values):
            oid = ObjectID.for_task_return(tid, i + 1)
            sobj = serialize(value)
            if sobj.total_size <= serialization.INLINE_THRESHOLD:
                out.append({"oid": oid.binary(), "nbytes": sobj.total_size,
                            "data": sobj.to_bytes()})
            else:
                buf = self.worker.create_in_store(oid, sobj.total_size)
                # A write_into/seal failure mid-result-set must abort
                # the unsealed allocation or the arena range strands for
                # the worker's lifetime (RTL161).
                try:
                    sobj.write_into(buf)
                    self.worker.store.seal(oid)
                except BaseException:
                    try:
                        self.worker.store.abort(oid)
                    except Exception:
                        pass
                    raise
                out.append({"oid": oid.binary(), "nbytes": sobj.total_size,
                            "shm": True})
        return out

    def _error_results(self, tid_bytes: bytes, nret: int, fn_name: str,
                       exc: BaseException) -> List[dict]:
        tid = TaskID(tid_bytes)
        blob = pack_error(fn_name, exc).to_bytes()
        return [{"oid": ObjectID.for_task_return(tid, i + 1).binary(),
                 "nbytes": len(blob), "data": blob, "_err": True}
                for i in range(nret)]

    # ---------------------------------------------------------- normal task

    async def _drain_execs(self):
        loop = asyncio.get_running_loop()
        try:
            while self._direct_q:
                conn, msg = self._direct_q.popleft()
                if self.die_after_task:
                    # Runtime-env-tainted worker retires: unprocessed
                    # pushes fail over to a fresh lease via the owner's
                    # retry path.
                    continue
                if (msg.get("opts") or {}).get("runtime_env"):
                    # runtime_env setup mutates process-global state (env
                    # vars, cwd, sys.path): run EXCLUSIVELY — drain
                    # in-flight tasks first, and hold new ones until it
                    # finishes (a tainting env then retires the worker
                    # before anything else runs under the wrong env).
                    while self.running_tasks:
                        await asyncio.sleep(0.005)
                    await loop.run_in_executor(
                        self.task_pool, self._exec_one, conn, msg, loop)
                    continue
                # Register BEFORE the pool picks it up: the exclusivity
                # poll above must see queued-but-not-yet-started tasks.
                self.running_tasks.setdefault(msg["tid"], 0)
                self.task_pool.submit(self._exec_one, conn, msg, loop)
        finally:
            self._draining = False

    def _send_exec_reply(self, conn, msg: dict, reply: dict):
        """Runs on the IO loop: register shm results, reply to the owner."""
        shm_rs = [r for r in reply["results"] if r.get("shm")]
        if shm_rs:
            # One coalesced registration frame for the whole result set —
            # the GCS decodes one message instead of N (obj_puts).
            self.worker.gcs.send({"t": "obj_puts", "objs": [
                {"oid": r["oid"], "nbytes": r["nbytes"], "shm": True,
                 "owner_wid": msg.get("owner")} for r in shm_rs]})
        if not conn.closed:
            conn.reply(msg, reply)
        if self.die_after_task:
            self.flush_events()
            loop = asyncio.get_running_loop()
            loop.call_later(0.01, os._exit, 0)

    def _exec_one(self, conn, msg: dict, loop):
        tid = msg["tid"]
        nret = msg.get("nret", 1)
        opts = msg.get("opts") or {}
        fn_name = opts.get("name", "unknown")
        t0 = time.time()
        try:
            results = self._execute_sync(msg, tid, nret, opts)
            err = any([r.pop("_err", False) for r in results])
        except Exception as e:  # noqa: BLE001
            results = self._error_results(
                tid, 1 if nret == "dyn" else nret, fn_name, e)
            for r in results:
                r.pop("_err", None)
            err = True
        t1 = time.time()
        self.record_event(tid, fn_name, "task", t0, t1, not err)
        # Completions from all pool threads funnel through ONE loop
        # wakeup per burst (the per-task self-pipe write was a visible
        # syscall cost at benchmark rates); replies then leave in one
        # coalesced socket write per connection.
        self._exec_done.append(
            (conn, msg, {"results": results, "err": err,
                         "t0": t0, "t1": t1}))
        with self._exec_wake_lock:
            if self._exec_wake_scheduled:
                return
            self._exec_wake_scheduled = True
        loop.call_soon_threadsafe(self._flush_exec_replies)

    def _flush_exec_replies(self):
        # Clear the flag BEFORE draining: an append landing mid-drain
        # either gets drained here or schedules its own wakeup — never
        # strands.
        with self._exec_wake_lock:
            self._exec_wake_scheduled = False
        while self._exec_done:
            conn, msg, reply = self._exec_done.popleft()
            self._send_exec_reply(conn, msg, reply)

    async def run_task(self, msg: dict):
        """GCS-dispatched execution (client-mode drivers and relays)."""
        loop = asyncio.get_running_loop()
        tid = msg["tid"]
        nret = msg.get("nret", 1)
        opts = msg.get("opts") or {}
        fn_name = opts.get("name", "unknown")
        t0 = time.time()
        err = False
        try:
            results = await loop.run_in_executor(
                self.pool, self._execute_sync, msg, tid, nret, opts)
            err = any([r.pop("_err", False) for r in results])
        except Exception as e:  # noqa: BLE001
            results = self._error_results(
                tid, 1 if nret == "dyn" else nret, fn_name, e)
            err = True
        self.record_event(tid, fn_name, "task", t0, time.time(), not err)
        self.worker.gcs.send({"t": "task_done", "tid": tid,
                              "results": results, "err": err})
        if self.die_after_task:
            self.flush_events()
            await asyncio.sleep(0.01)
            os._exit(0)

    def _execute_sync(self, msg: dict, tid: bytes, nret: int,
                      opts: dict) -> List[dict]:
        self.running_tasks[tid] = threading.get_ident()  # raylint: disable=RTL151 (GIL-atomic dict op; loop side only truthiness/get/setdefault, never iterates)
        fn_name = opts.get("name", "unknown")
        from .runtime_context import _clear_execution, _set_execution

        _set_execution(task_id=bytes(tid), resources=opts.get("res"))
        try:
            self._pin_gpus(msg)
            self._apply_runtime_env(opts)
            fn = self._get_function(msg["fid"])
            if opts.get("xlang"):
                # Cross-language call (C++ client): msgpack args in, raw
                # msgpack result bytes out — the owner is not a Python
                # process and reads the result directly
                # (ray_tpu_torch/cross_language.py).
                from ray_tpu_torch.cross_language import execute_xlang_task

                tid_obj = TaskID(tid)
                data = execute_xlang_task(fn, bytes(msg.get("args") or b""))
                return [{"oid": ObjectID.for_task_return(
                    tid_obj, 1).binary(), "nbytes": len(data),
                    "data": data}]
            args, kwargs = self._load_args(msg)
            if opts.get("tp"):
                # Tracing enabled: adopt the caller's span context so
                # nested .remote() calls chain (util/tracing.py). The
                # span must also cover asyncio.run for async remote fns —
                # fn(...) alone just returns the unstarted coroutine.
                from ray_tpu_torch.util import tracing

                with tracing.adopt_and_span(opts["tp"], f"run:{fn_name}"):
                    value = fn(*args, **kwargs)
                    if asyncio.iscoroutine(value):
                        value = asyncio.run(value)
                    if nret == "dyn":
                        value = list(value)
            else:
                value = fn(*args, **kwargs)
                if asyncio.iscoroutine(value):
                    value = asyncio.run(value)
                if nret == "dyn":
                    value = list(value)
            if nret == "dyn":
                # Dynamic generator returns (reference: num_returns=
                # "dynamic"): each yielded item is its own return object
                # (indices 2..n+1); the primary return (index 1) is the
                # descriptor the driver turns into an ObjectRefGenerator.
                from .serialization import DynamicReturns

                tid_obj = TaskID(tid)
                oids = [ObjectID.for_task_return(tid_obj, i + 2).binary()
                        for i in range(len(value))]
                values = [DynamicReturns(oids)] + value
            else:
                values = self._split_returns(value, nret)
            return self._pack_results(tid, values, register_shm=False)
        except BaseException as e:  # noqa: BLE001
            if isinstance(e, (KeyboardInterrupt, SystemExit)):
                e = serialization.TaskCancelledError(str(e))
            if opts.get("xlang"):
                import msgpack

                data = msgpack.packb(
                    {"__xlang_error__": f"{type(e).__name__}: {e}"},
                    use_bin_type=True)
                return [{"oid": ObjectID.for_task_return(
                    TaskID(tid), 1).binary(), "nbytes": len(data),
                    "data": data, "_err": True}]
            return self._error_results(
                tid, 1 if nret == "dyn" else nret, fn_name, e)
        finally:
            _clear_execution()
            self.running_tasks.pop(tid, None)  # raylint: disable=RTL151 (GIL-atomic dict op; loop side only truthiness/get/setdefault, never iterates)

    @staticmethod
    def _split_returns(value: Any, nret: int) -> List[Any]:
        if nret == 1:
            return [value]
        vals = list(value)
        if len(vals) != nret:
            raise ValueError(
                f"task declared num_returns={nret} but returned {len(vals)}")
        return vals

    # --------------------------------------------------------------- actors

    async def init_actor(self, msg: dict):
        loop = asyncio.get_running_loop()
        self.actor_id = ActorID(msg["aid"])
        self.actor_opts = msg.get("opts") or {}
        max_c = self.actor_opts.get("max_concurrency")
        if max_c and max_c > 1:
            self.pool = ThreadPoolExecutor(max_workers=max_c,
                                           thread_name_prefix="exec")
        self.async_sem = asyncio.Semaphore(max_c or 1000)
        # Concurrency groups (reference: ConcurrencyGroupManager,
        # core_worker/transport/concurrency_group_manager.h): named
        # per-group limits for async actor methods; methods tagged with
        # @ray_tpu_torch.method(concurrency_group=...) draw from their group's
        # semaphore instead of the default.
        self.group_sems = {
            name: asyncio.Semaphore(int(limit))
            for name, limit in
            (self.actor_opts.get("concurrency_groups") or {}).items()}
        # Sync methods run on the thread pool: their groups enforce via
        # threading semaphores (same limits).
        self.group_thread_sems = {
            name: threading.Semaphore(int(limit))
            for name, limit in
            (self.actor_opts.get("concurrency_groups") or {}).items()}
        # Sync-call batching only where it cannot reduce concurrency: a
        # single-threaded actor with no concurrency groups.
        self._batch_sync = (not max_c or max_c <= 1) \
            and not self.group_thread_sems
        try:
            await loop.run_in_executor(self.pool, self._init_actor_sync, msg)
            _boot_ts("actor_ready")
            self.worker.gcs.send({"t": "actor_ready",
                                  "aid": msg["aid"]})
        except Exception as e:  # noqa: BLE001
            tb = traceback.format_exc()
            self.worker.gcs.send({"t": "actor_init_err", "aid": msg["aid"],
                                  "err": f"{e}\n{tb}"})
            self.actor_id = None

    def _pin_gpus(self, msg: dict):
        """Pin this process to the GPU ids the GCS assigned (C3's fix:
        the reference's ``set_visible_accelerators`` had no caller).
        Runs before the user code, so before its first CUDA call; a
        pinned worker is retired when its lease or actor ends, so it is
        never asked for other cards."""
        ids = msg.get("gpus")
        if not ids:
            return
        from ..accelerators import get_accelerator_manager

        if self.pinned_gpus is None:
            torch = sys.modules.get("torch")
            if torch is not None and torch.cuda.is_initialized():
                raise RuntimeError("worker initialised CUDA before it was "
                                   "pinned to its GPUs")
            get_accelerator_manager("GPU").set_visible_accelerators(
                os.environ, list(ids))
            self.pinned_gpus = list(ids)
        elif self.pinned_gpus != list(ids):
            raise RuntimeError(f"worker pinned to GPUs {self.pinned_gpus} "
                               f"was asked for {list(ids)}")

    def _init_actor_sync(self, msg: dict):
        self._pin_gpus(msg)
        self._apply_runtime_env(msg.get("opts") or {})
        cls = self._get_function(msg["fid"])
        if (msg.get("opts") or {}).get("xlang"):
            # Non-Python owner (C++ client): args are a msgpack array.
            import msgpack

            args = tuple(msgpack.unpackb(bytes(msg.get("args") or b"\x90"),
                                         raw=False))
            kwargs = {}
        else:
            args, kwargs = self._load_args(msg)
        self.actor_instance = cls(*args, **kwargs)  # raylint: disable=RTL151 (loop awaits the init executor future before any call dispatch — happens-before)

    async def _run_actor_call(self, conn: protocol.Connection, msg: dict):
        loop = asyncio.get_running_loop()
        tid = msg["tid"]
        nret = msg.get("nret", 1)
        method_name = msg["m"]
        t0 = time.time()
        ok = True
        try:
            if self.actor_instance is None:
                raise serialization.ActorDiedError("actor not initialized")
            method = getattr(self.actor_instance, method_name)
            if asyncio.iscoroutinefunction(method):
                group = getattr(method, "_concurrency_group", None)
                sem = self.group_sems.get(group, self.async_sem) \
                    if getattr(self, "group_sems", None) else self.async_sem
                from .runtime_context import _set_execution

                _set_execution(task_id=bytes(tid),
                               actor_id=(self.actor_id.binary()
                                         if self.actor_id else None),
                               resources=(self.actor_opts or {}).get("res"))
                async with sem:
                    fast = self._load_args_fast(msg)
                    if fast is None:
                        args, kwargs = await loop.run_in_executor(
                            None, self._load_args, msg)
                    elif fast[2]:
                        # Refs present: only the blocking RESOLUTION
                        # hops to a thread — never a re-deserialize.
                        args, kwargs = await loop.run_in_executor(
                            None, self._resolve_top_refs, fast[0],
                            fast[1])
                    else:
                        # Dispatch stays on the actor's running loop: no
                        # per-call thread handoff for args that load in
                        # microseconds (the async-def pathology fix).
                        args, kwargs = fast[0], fast[1]
                    tp = (msg.get("opts") or {}).get("tp")
                    if tp:
                        from ray_tpu_torch.util import tracing

                        with tracing.adopt_and_span(
                                tp, f"run:{method_name}"):
                            value = await method(*args, **kwargs)
                    else:
                        value = await method(*args, **kwargs)
                    values = self._split_returns(value, nret)
                    results = self._pack_results(tid, values, True)
            else:
                results = await loop.run_in_executor(
                    self.pool, self._execute_method_sync, method, msg, tid,
                    nret)
        except serialization.ActorExitSignal:
            # exit_actor(): the call completes normally, then the
            # process leaves once the reply has drained.
            results = self._pack_results(
                tid, self._split_returns(None, nret), True)
            self._exit_requested = True
        except BaseException as e:  # noqa: BLE001
            results = self._actor_error_results(msg, tid, nret, e)
            ok = False
        for r in results:
            r.pop("_err", None)
        self.record_event(tid, method_name, "actor_call", t0, time.time(), ok)
        self._register_shm_results(msg, results)
        if not conn.closed:
            conn.reply(msg, {"results": results})
        self._maybe_exit_after_reply()

    async def _run_stream_call(self, conn: protocol.Connection, msg: dict):
        loop = asyncio.get_running_loop()

        def send_chunk(value):
            if not conn.closed:
                try:
                    conn.send({"i": msg["i"], "sc": 1,
                               "val": serialize(value).to_bytes()})
                except ConnectionError:
                    pass

        def finish(err: Optional[str] = None):
            if not conn.closed:
                reply = {"end": True}
                if err is not None:
                    reply["err"] = err
                conn.reply(msg, reply)

        try:
            if self.actor_instance is None:
                raise serialization.ActorDiedError("actor not initialized")
            method = getattr(self.actor_instance, msg["m"])
            fast = self._load_args_fast(msg)
            if fast is None:
                args, kwargs = await loop.run_in_executor(
                    None, self._load_args, msg)
            elif fast[2]:
                args, kwargs = await loop.run_in_executor(
                    None, self._resolve_top_refs, fast[0], fast[1])
            else:
                args, kwargs = fast[0], fast[1]
            import inspect

            if inspect.isasyncgenfunction(method):
                out = method(*args, **kwargs)
            else:
                out = await loop.run_in_executor(
                    self.pool, lambda: method(*args, **kwargs))
            # Dispatch on what the call PRODUCED — wrappers (e.g. serve's
            # replica dispatcher) are sync functions that may hand back a
            # user generator/coroutine/async-generator.
            if inspect.isasyncgen(out):
                async for item in out:
                    send_chunk(item)
            elif inspect.iscoroutine(out):
                out = await out
                if inspect.isasyncgen(out):
                    async for item in out:
                        send_chunk(item)
                else:
                    send_chunk(out)
            elif inspect.isgenerator(out):
                def drain(gen=out):
                    for item in gen:
                        loop.call_soon_threadsafe(send_chunk, item)

                await loop.run_in_executor(self.pool, drain)
            else:
                send_chunk(out)
            finish()
        except BaseException as e:  # noqa: BLE001
            finish(f"{type(e).__name__}: {e}")

    def _actor_error_results(self, msg: dict, tid: bytes, nret: int,
                             e: BaseException) -> List[dict]:
        """Error reply for a failed actor call — xlang callers get a
        msgpack ``__xlang_error__`` map (the shape the C++ client
        parses); Python callers get a packed exception. Shared by the
        per-call path and the batched sync pump."""
        if (msg.get("opts") or {}).get("xlang"):
            import msgpack

            data = msgpack.packb(
                {"__xlang_error__": f"{type(e).__name__}: {e}"},
                use_bin_type=True)
            return [{"oid": ObjectID.for_task_return(
                TaskID(tid), 1).binary(), "nbytes": len(data),
                "data": data}]
        return self._error_results(tid, nret, msg["m"], e)

    def _drain_sync_calls(self):
        """Executor-thread pump: run every queued sync actor call, then
        deliver all replies in one loop wakeup (write coalescing folds
        them into one socket send per connection). FIFO: appends happen
        only on the loop thread; the pump only pops; the running flag is
        cleared back on the loop thread so no call can strand between
        "pump saw empty" and "new call queued". The delivery wakeup is
        in a ``finally``: NOTHING may leave the pump flag stuck True, or
        every later sync call on this actor would hang."""
        out = []
        try:
            while self._sync_calls:
                conn, msg, method = self._sync_calls.popleft()
                tid = msg["tid"]
                nret = msg.get("nret", 1)
                t0 = time.time()
                ok = True
                try:
                    results = self._execute_method_sync(
                        method, msg, tid, nret)
                except serialization.ActorExitSignal:
                    results = self._pack_results(
                        tid, self._split_returns(None, nret), True)
                    self._exit_requested = True  # raylint: disable=RTL151 (monotonic bool flag, atomic rebind; loop polls it after the pump batch delivers)
                except BaseException as e:  # noqa: BLE001
                    ok = False
                    try:
                        results = self._actor_error_results(
                            msg, tid, nret, e)
                    except BaseException:  # even error FORMATTING failed
                        results = self._error_results(
                            tid, 1, str(msg.get("m", "?")),
                            RuntimeError("error formatting failed"))
                out.append((conn, msg, results, ok, t0, time.time()))
        finally:
            try:
                self.worker.loop.call_soon_threadsafe(
                    self._deliver_sync_batch, out)
            except RuntimeError:
                pass  # loop closed (shutdown)

    def _register_shm_results(self, msg: dict, results: List[dict]):
        """Register shm actor-call results from THIS process — the node
        whose arena actually holds them (mirror of the leased-exec
        ``_send_exec_reply`` registration; runs on the IO loop at both
        reply sites). The caller registers too, but holder-less
        (``nh``) and only for its own-connection FIFO ordering: before
        this, cross-node actor results had ZERO holders (driver
        connections carry no node_id) and every pull of one died with
        "no holder could serve" — found by a Podracer multi-node
        bench. ``owner_wid`` hands ownership (and the initial ref pin)
        to the calling worker/driver whichever registration lands
        first."""
        shm_rs = [r for r in results if r.get("shm")]
        if not shm_rs or self.worker.gcs is None or self.worker.gcs.closed:
            return
        try:
            self.worker.gcs.send({"t": "obj_puts", "objs": [
                {"oid": r["oid"], "nbytes": r["nbytes"], "shm": True,
                 "owner_wid": msg.get("owner")} for r in shm_rs]})
        except ConnectionError:
            # GCS blip: the caller's ordered registration plus the
            # restart-resync replay cover the entry; only the holder
            # hint is lost until rescan.
            pass

    def _maybe_exit_after_reply(self):
        if getattr(self, "_exit_requested", False):
            import os as _os

            # Give the just-written completion a beat to drain, then
            # leave; callers of FUTURE methods observe ActorDiedError.
            self.worker.loop.call_later(0.2, _os._exit, 0)
            self._exit_requested = False

    def _deliver_sync_batch(self, batch):
        for conn, msg, results, ok, t0, t1 in batch:
            for r in results:
                r.pop("_err", None)
            self.record_event(msg["tid"], msg["m"], "actor_call", t0, t1, ok)
            self._register_shm_results(msg, results)
            if not conn.closed:
                try:
                    conn.reply(msg, {"results": results})
                except ConnectionError:
                    pass
        # Cleared HERE (loop thread): a call that arrived while the pump
        # was finishing restarts it rather than stranding.
        self._maybe_exit_after_reply()
        self._sync_pump_running = False
        if self._sync_calls:
            self._sync_pump_running = True
            self.worker.loop.run_in_executor(self.pool,
                                             self._drain_sync_calls)

    def _execute_method_sync(self, method, msg: dict, tid: bytes,
                             nret: int) -> List[dict]:
        self.running_tasks[tid] = threading.get_ident()  # raylint: disable=RTL151 (GIL-atomic dict op; loop side only truthiness/get/setdefault, never iterates)
        from .runtime_context import _clear_execution, _set_execution

        _set_execution(task_id=bytes(tid),
                       actor_id=(self.actor_id.binary()
                                 if self.actor_id else None),
                       resources=(self.actor_opts or {}).get("res"))
        try:
            if (msg.get("opts") or {}).get("xlang"):
                # msgpack in / msgpack out so a non-Python caller reads
                # the result bytes directly (cross-language actor calls).
                import msgpack

                args = tuple(msgpack.unpackb(
                    bytes(msg.get("args") or b"\x90"), raw=False))
                value = method(*args)
                data = msgpack.packb(value, use_bin_type=True)
                return [{"oid": ObjectID.for_task_return(
                    TaskID(tid), 1).binary(), "nbytes": len(data),
                    "data": data}]
            args, kwargs = self._load_args(msg)
            group = getattr(method, "_concurrency_group", None)
            gsem = getattr(self, "group_thread_sems", {}).get(group)
            if gsem is not None:
                gsem.acquire()
            try:
                tp = (msg.get("opts") or {}).get("tp")
                if tp:
                    from ray_tpu_torch.util import tracing

                    with tracing.adopt_and_span(tp, f"run:{msg['m']}"):
                        value = method(*args, **kwargs)
                else:
                    value = method(*args, **kwargs)
            finally:
                if gsem is not None:
                    gsem.release()
            values = self._split_returns(value, nret)
            return self._pack_results(tid, values, register_shm=True)
        finally:
            _clear_execution()
            self.running_tasks.pop(tid, None)  # raylint: disable=RTL151 (GIL-atomic dict op; loop side only truthiness/get/setdefault, never iterates)

    # ---------------------------------------------------------------- misc

    def cancel(self, tid: bytes, force: bool):
        if force:
            os._exit(1)
        ident = self.running_tasks.get(tid)
        if ident:
            # Best-effort interrupt of the executing thread (the reference
            # raises KeyboardInterrupt in the worker the same way).
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(ident),
                ctypes.py_object(KeyboardInterrupt))


async def amain(args):
    _boot_ts("amain")
    worker = Worker(role="worker")
    worker.loop = asyncio.get_running_loop()
    worker._loop_thread = threading.main_thread()
    worker.node_id = bytes.fromhex(args.node_id)

    listen_path = os.path.join(
        args.session_dir, f"w_{worker.worker_id.hex()[:12]}.sock")
    executor = Executor(worker, listen_path)
    stop = asyncio.Event()

    async def handle_control(msg: dict):
        t = msg.get("t")
        if t is None:
            return  # empty/typeless frame: never dispatch (see protocol)
        if t == "exec":
            if failpoints.active():
                # GCS-dispatched task path: same kill-between-dispatch-
                # and-first-result class as the leased direct push above.
                failpoints.fire("worker.exec", "gcs_exec")
            asyncio.get_running_loop().create_task(executor.run_task(msg))
        elif t == "actor_init":
            asyncio.get_running_loop().create_task(executor.init_actor(msg))
        elif t == "cancel":
            executor.cancel(msg["tid"], msg.get("force", False))
        elif t == "memdump":
            # On-demand memory introspection (reference: memray drivers in
            # dashboard/modules/reporter/profile_manager.py): RSS + gc
            # stats + top tracemalloc sites when tracing is on.
            worker.gcs.reply(msg, _memdump())
        elif t == "exit":
            stop.set()

    def _memdump() -> dict:
        import gc
        import resource
        import tracemalloc

        try:  # CURRENT rss (ru_maxrss is the lifetime peak — useless
              # for watching memory recover or trend)
            with open("/proc/self/statm") as f:
                rss_kb = int(f.read().split()[1]) * (
                    os.sysconf("SC_PAGE_SIZE") // 1024)
        except (OSError, ValueError, IndexError):
            rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out: Dict[str, Any] = {
            "ok": True, "pid": os.getpid(),
            "rss_kb": rss_kb,
            "peak_rss_kb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss,
            "gc_objects": len(gc.get_objects()),
            "gc_counts": gc.get_count(),
            "tracemalloc": tracemalloc.is_tracing(),
        }
        if tracemalloc.is_tracing():
            snap = tracemalloc.take_snapshot()
            out["top"] = [
                {"site": str(s.traceback[0]), "kb": s.size // 1024,
                 "count": s.count}
                for s in snap.statistics("lineno")[:20]]
        return out

    worker.handle_control = handle_control
    await executor.start()

    # Dedicated TCP chunk-serve socket on its OWN thread + loop: peers
    # fetch this worker's landed chunks mid-pull (chunk-level broadcast
    # relay) and its sealed local objects here. TCP rather than the UDS
    # direct-call socket (per-process UDS throughput is a fraction of
    # loopback TCP on sandboxed kernels, and TCP stays reachable
    # cross-host); a separate thread so serve memcpys never steal cycles
    # from this worker's recv stripe or actor traffic.
    from . import broadcast
    from .node import get_node_ip_address

    from .serialization import TRANSPORT_STATS

    serve_host = ("127.0.0.1" if args.gcs.startswith("unix:")
                  else get_node_ip_address())
    serve_addr, _serve_sock = broadcast.start_serve_thread(
        serve_host, worker.resolve_obj_fetch, name="worker-obj-serve",
        stats=TRANSPORT_STATS)
    # Fallback: serve on the direct socket (the obj_fetch branch in
    # _on_direct_msg) when TCP binding failed.
    worker.serve_addr = serve_addr or ("unix:" + listen_path)

    # Loop-lag instrumentation on the worker's IO loop (the GCS has had
    # this since the drain PR): a sync call stalling an async actor's
    # loop shows up as lag here — the runtime corroboration of the
    # static RTL006 blocking-in-async rule. Exported through the normal
    # metrics push path so the dashboard/Prometheus surface it per
    # worker.
    from .thread_check import LoopMonitor

    loop_monitor = LoopMonitor(name="worker").start()
    from ray_tpu_torch.util.metrics import Gauge

    wid_tag = {"wid": worker.worker_id.hex()[:16]}
    lag_mean_g = Gauge("worker_loop_mean_lag_ms",
                       "mean event-loop tick lag of this worker's IO loop",
                       tag_keys=("wid",))
    lag_max_g = Gauge("worker_loop_max_lag_ms",
                      "max event-loop tick lag of this worker's IO loop",
                      tag_keys=("wid",))

    async def flush_events_loop():
        while not stop.is_set():
            await asyncio.sleep(0.5)
            # flush_events also drains tracing spans (gated on the module
            # having been imported by a traced call, not this process's
            # env var — the driver may enable tracing after worker spawn).
            executor.flush_events()
            stats = loop_monitor.stats()
            lag_mean_g.set(stats["mean_lag_ms"], tags=wid_tag)
            lag_max_g.set(stats["max_lag_ms"], tags=wid_tag)

    worker.gcs_address = args.gcs

    async def connect_gcs() -> dict:
        reader, writer = await protocol.connect(args.gcs)
        worker.gcs = protocol.Connection(
            reader, writer, handler=worker._on_gcs_push,
            on_close=on_gcs_close)
        worker.gcs.start()
        hello = {
            "t": "hello", "role": "worker",
            "worker_id": worker.worker_id.binary(),
            "node_id": worker.node_id,
            "addr": "unix:" + listen_path,
            "obj_addr": worker.serve_addr,
            "pid": os.getpid(),
            # Which interpreter-env pool this worker belongs to ("" =
            # base image; otherwise a pip/uv venv key set at spawn).
            "env_key": os.environ.get("RAY_TPU_TORCH_ENV_KEY", ""),
        }
        if executor.actor_id is not None:
            # Resync after a GCS restart: re-claim our live actor so the
            # restored record binds to this worker instead of restarting
            # (reference: worker resync after GCS failover).
            hello["actor_id"] = executor.actor_id.binary()
        if executor.pinned_gpus:
            # ... and the cards it is pinned to, which it keeps using.
            hello["gpus"] = executor.pinned_gpus
        reply = await worker.gcs.request(hello, timeout=30)
        # Epoch-gated resync (chaos-found): the WORKER lane was
        # re-helloing without ever running _resync_after_reconnect, so a
        # worker blocked resolving a task arg across a GCS crash never
        # re-subscribed its unresolved object futures on the fresh
        # instance — the executing task wedged forever (first red
        # schedule: gcs_crash_pre_wal). Workers borrow refs, hold live
        # refcounts, and own nested submissions exactly like drivers;
        # they need the same resync.
        new_epoch = reply.get("epoch")
        prev = getattr(worker, "_gcs_epoch", None)
        worker._gcs_epoch = new_epoch
        if prev is not None:
            worker._resync_after_reconnect(
                gcs_restarted=(new_epoch != prev))
        return reply

    def on_gcs_close():
        if not stop.is_set():
            asyncio.get_running_loop().create_task(reconnect_gcs())

    async def reconnect_gcs():
        def _give_up():
            # ppid==1 means our supervisor chain (agent, or the fork
            # zygote whose stdin pipe the agent held) is gone: either
            # the cluster is tearing down or this node was hard-killed.
            # Exiting NOW instead of burning the full reconnect budget
            # is what keeps SIGKILL'd nodes from stranding orphan
            # workers for ~15s (the chaos host invariant that caught
            # this: bcast_short_read teardown).
            return stop.is_set() or os.getppid() == 1

        ok = await protocol.reconnect_with_retry(
            connect_gcs, should_stop=_give_up)
        if not ok and not stop.is_set():
            stop.set()

    reply = await connect_gcs()
    _boot_ts("connected")
    worker.session_name = reply["session"]
    worker.session_dir = reply["session_dir"]
    from .object_store import make_store

    # Lazy factory: the arena opens on first object-plane use, not at
    # boot (launch storms of store-less actors skip it entirely).
    worker._store_factory = (
        lambda s=worker.session_name: make_store(s))
    _boot_ts("store")
    set_global_worker(worker)
    worker._flusher_handle = worker.loop.call_later(0.1, worker._flush_refs_cb)
    asyncio.get_running_loop().create_task(flush_events_loop())

    await stop.wait()
    loop_monitor.stop()
    executor.flush_events()
    worker._flush_refs()
    try:
        os.unlink(listen_path)
    except OSError:
        pass
    await asyncio.sleep(0.01)  # let final frames flush
    # Hard exit: ``ray.kill`` semantics are immediate termination — don't
    # wait for executor threads still running user code. Flush stdio first
    # so buffered task prints reach the worker log.
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    from . import node as _node

    if _node._profile_dump is not None:
        try:
            _node._profile_dump()  # os._exit skips finally: flush now
        except Exception:
            pass
    os._exit(0)


def main_from_req(req: dict):
    """Zygote fork entry: args ride the fork request — no argparse
    (building an ArgumentParser costs ~4 ms CPU per child, measured on
    the many-actors launch path)."""
    import types

    from .node import _run_with_optional_profile

    args = types.SimpleNamespace(gcs=req["gcs"], node_id=req["node_id"],
                                 session_dir=req["session_dir"])
    _boot_ts("pre-run")
    _run_with_optional_profile(lambda: amain(args), "worker")


def main():
    from .node import _run_with_optional_profile

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--session-dir", required=True)
    args = parser.parse_args()
    _run_with_optional_profile(lambda: amain(args), "worker")


if __name__ == "__main__":
    main()
