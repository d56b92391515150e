"""Compiled actor pipelines (aDAG equivalent).

Analog of the reference's ``CompiledDAG`` (``dag/compiled_dag_node.py:668``)
+ channel layer (``experimental/channel/shared_memory_channel.py``,
``nccl_group.py``): ``dag.experimental_compile()`` pre-resolves a linear
actor pipeline so each ``execute()`` flows input → stage0 → stage1 → … →
driver with ONE direct hop per stage (no per-stage driver round-trip, no
GCS involvement, no function-table lookups). The hops are the host-side
orchestration channel over the actors' own connections; tensors cross
them as host arrays (the reference's NCCL channels are not copied: the
card's collectives are ``torch.distributed`` process groups, see
ray_tpu_torch.parallel).
"""

from __future__ import annotations

import threading
import uuid
from concurrent.futures import Future as SyncFuture
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.worker import global_worker
from . import (ClassMethodNode, ClassNode, DAGNode, InputNode,
               MultiOutputNode, _HandleNode)


class AdmissionTimeout(TimeoutError):
    """``execute(timeout=...)`` could not admit within the window — the
    pipe is full (``max_inflight`` in-flight executions, none completed).
    Callers that must stay responsive to out-of-band fault signals while
    the pipe is backed up (the MPMD pipeline's member-loss/drain checks)
    admit with a short timeout in a loop instead of blocking forever on
    a chain whose downstream stage may be dead."""


class CompiledDAGRef:
    """Future-like handle for one compiled execution."""

    def __init__(self, fut: SyncFuture, dag: "CompiledDAG"):
        self._fut = fut
        self._dag = dag

    def get(self, timeout: Optional[float] = None) -> Any:
        parts = self._fut.result(timeout)
        values = []
        for blob, err in parts:
            value = serialization.deserialize(memoryview(blob))
            if err:
                if isinstance(value, serialization.TaskError):
                    raise value.cause if isinstance(value.cause, Exception) \
                        else value
                raise value if isinstance(value, Exception) \
                    else RuntimeError(str(value))
            values.append(value)
        return values if self._dag._multi else values[0]


class CompiledDAG:
    def __init__(self, dag: DAGNode, max_inflight: int = 10):
        self._dag = dag
        self._max_inflight = max_inflight
        self._dag_id = f"cdag_{uuid.uuid4().hex[:12]}"
        self._stages: List[dict] = []
        self._seq = 0
        self._futures: Dict[int, SyncFuture] = {}
        self._inflight = threading.Semaphore(max_inflight)
        self._partials: Dict[int, Dict[int, tuple]] = {}  # seq -> out->val
        self._torn_down = False
        self._lock = threading.Lock()
        self._compile()

    # ------------------------------------------------------------- compile

    def _plan(self):
        """Build the stage graph: arbitrary topology of actor-method nodes
        fed by one InputNode, ending at the root node (or MultiOutputNode
        bundling several terminals). Reference: general compiled DAGs +
        execution schedule (``dag/compiled_dag_node.py:668``)."""
        root = self._dag
        outputs: List[DAGNode]
        if isinstance(root, MultiOutputNode):
            outputs = list(root._bound_args)
            self._n_outputs = len(outputs)
            self._multi = True
        else:
            outputs = [root]
            self._n_outputs = 1
            self._multi = False
        order = [n for n in root.topo_order()
                 if isinstance(n, ClassMethodNode)]
        if not order:
            raise ValueError(
                "experimental_compile requires actor-method nodes "
                "(use ActorClass.bind() / method.bind())")
        for out in outputs:
            if not isinstance(out, ClassMethodNode):
                raise ValueError("DAG outputs must be actor-method nodes")
        stage_ids = {id(n): i for i, n in enumerate(order)}
        plan = []
        for n in order:
            inputs = []   # (slot_pos, "input" | src_stage_id)
            consts = {}   # arg position -> serialized constant
            for pos, a in enumerate(n._bound_args[1:]):
                if isinstance(a, InputNode):
                    inputs.append((pos, "input"))
                elif isinstance(a, ClassMethodNode):
                    inputs.append((pos, stage_ids[id(a)]))
                elif isinstance(a, DAGNode):
                    raise ValueError(
                        f"unsupported upstream node type {type(a).__name__}")
                else:
                    # str keys: msgpack peers reject int map keys
                    # (strict_map_key), and a crashed read loop looks like
                    # a silent hang.
                    consts[str(pos)] = serialization.serialize(a).to_bytes()
            if not inputs:
                raise ValueError(
                    "every compiled stage needs at least one DAG input")
            kwconsts = None
            if n._bound_kwargs:
                if any(isinstance(v, DAGNode)
                       for v in n._bound_kwargs.values()):
                    raise ValueError(
                        "compiled DAGs do not support DAG-valued kwargs")
                kwconsts = serialization.serialize(
                    dict(n._bound_kwargs)).to_bytes()
            plan.append({
                "node": n, "stage": stage_ids[id(n)], "inputs": inputs,
                "consts": consts, "kwconsts": kwconsts,
                "sink_outputs": [i for i, o in enumerate(outputs)
                                 if o is n],
            })
        return plan

    def _actor_handle(self, node: ClassMethodNode):
        parent = node._bound_args[0]
        if isinstance(parent, _HandleNode):
            return parent._handle
        if isinstance(parent, ClassNode):
            return parent._execute_self({}, (), {})
        raise ValueError("compiled stage must be bound to an actor")

    def _compile(self):
        w = global_worker()
        plan = self._plan()
        handles = [self._actor_handle(p["node"]) for p in plan]
        addrs = []
        for h in handles:
            ac = w.run_async(w._get_actor_conn(h._id))
            addrs.append(ac.addr)
        # Consumer map: src stage -> [(dest addr, dest stage, dest slot)].
        # A stage's value inputs are numbered by slot in arg order.
        consumers: Dict[int, List[dict]] = {p["stage"]: [] for p in plan}
        self._input_feeds = []  # [(stage, slot)] receiving the driver input
        for p in plan:
            for slot, (pos, src) in enumerate(p["inputs"]):
                if src == "input":
                    self._input_feeds.append((p["stage"], slot))
                else:
                    consumers[src].append({
                        "addr": addrs[p["stage"]], "stage": p["stage"],
                        "slot": slot})
        # Set up stages downstream-first so destination sockets exist.
        for p in reversed(plan):
            ac = w.run_async(w._get_actor_conn(handles[p["stage"]]._id))
            # Slot->arg-position mapping is implicit: value inputs retain
            # their relative arg order, constants fill fixed positions.
            reply = w.run_async(ac.conn.request({
                "t": "dag_setup", "dag": self._dag_id,
                "stage": p["stage"], "m": p["node"]._method,
                "slots": len(p["inputs"]),
                "consts": p["consts"], "kwconsts": p["kwconsts"],
                "next": consumers[p["stage"]],
                "sink_outputs": p["sink_outputs"]}))
            if not reply.get("ok"):
                raise RuntimeError(
                    f"dag_setup failed on stage {p['stage']}: "
                    f"{reply.get('err')}")
        # Dedicated driver connections: inputs + one sink per terminal.
        feed_addrs = {addrs[stage] for stage, _ in self._input_feeds}
        self._feed_conns = {a: w.run_async(self._open(a))
                            for a in feed_addrs}
        self._feed_targets = [(addrs[stage], stage, slot)
                              for stage, slot in self._input_feeds]
        sink_addrs = {addrs[p["stage"]] for p in plan if p["sink_outputs"]}
        self._sink_conns = []
        for a in sink_addrs:
            c = w.run_async(self._open(a, handler=self._on_sink))
            reply = w.run_async(c.request(
                {"t": "dag_register_sink", "dag": self._dag_id}))
            if not reply.get("ok"):
                raise RuntimeError("dag_register_sink failed")
            self._sink_conns.append(c)
        self._handles = handles

    async def _open(self, addr: str, handler=None) -> protocol.Connection:
        reader, writer = await protocol.connect(addr)
        conn = protocol.Connection(reader, writer, handler=handler)
        conn.start()
        return conn

    async def _on_sink(self, msg: dict):
        if msg.get("t") != "dag_output" or msg.get("dag") != self._dag_id:
            return
        seq = msg["seq"]
        parts = self._partials.setdefault(seq, {})
        parts[msg.get("out", 0)] = (msg["val"], msg.get("err", False))
        if len(parts) < self._n_outputs:
            return
        self._partials.pop(seq, None)
        fut = self._futures.pop(seq, None)
        if fut is not None and not fut.done():
            fut.set_result([parts[i] for i in range(self._n_outputs)])
        self._inflight.release()

    # ------------------------------------------------------------- execute

    def execute(self, value: Any,
                timeout: Optional[float] = None) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        if timeout is None:
            self._inflight.acquire()  # raylint: disable=RTL161 (released by the except wrap below and _on_sink on completion)
        elif not self._inflight.acquire(timeout=timeout):  # raylint: disable=RTL161 (the raise fires only when NOT acquired; successful acquires release via the except wrap below / _on_sink)
            raise AdmissionTimeout(
                f"pipe full: {self._max_inflight} executions in flight, "
                f"none completed within {timeout}s")
        seq = None
        # An unserializable input (or a closed loop) must hand the
        # inflight slot back — leaking one per failed execute() would
        # wedge the pipeline at max_inflight failures (RTL161).
        try:
            with self._lock:
                self._seq += 1
                seq = self._seq
            fut: SyncFuture = SyncFuture()
            self._futures[seq] = fut
            blob = serialization.serialize(value).to_bytes()
            w = global_worker()
            w.loop.call_soon_threadsafe(self._send_input, seq, blob)
            return CompiledDAGRef(fut, self)
        except BaseException:
            if seq is not None:
                self._futures.pop(seq, None)
            self._inflight.release()
            raise

    def _send_input(self, seq: int, blob: bytes):
        try:
            for addr, stage, slot in self._feed_targets:
                self._feed_conns[addr].send({
                    "t": "dag_input", "dag": self._dag_id, "stage": stage,
                    "slot": slot, "seq": seq, "val": blob, "err": False})
        except ConnectionError as e:
            fut = self._futures.pop(seq, None)
            if fut is not None and not fut.done():
                fut.set_exception(e)
            self._inflight.release()

    # ------------------------------------------------------------ teardown

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        w = global_worker()
        for h in getattr(self, "_handles", []):
            try:
                ac = w.run_async(w._get_actor_conn(h._id))
                w.run_async(ac.conn.request(
                    {"t": "dag_teardown", "dag": self._dag_id}), 5)
            except Exception:
                pass
        for conn in (list(getattr(self, "_feed_conns", {}).values())
                     + list(getattr(self, "_sink_conns", []))):
            try:
                w.run_async(conn.close())
            except Exception:
                pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
