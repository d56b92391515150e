"""Collective communication library over actors.

Analog of the reference's ``ray.util.collective``
(``python/ray/util/collective/collective.py:40-615``: ``init_collective_group``,
``allreduce``/``allgather``/``reducescatter``/``broadcast``/``send``/``recv``,
NCCL + Gloo backends):

* **"shm" backend** (default, the Gloo analog): host-memory collectives for
  control-plane / CPU tensors. A per-group coordinator actor rendezvouses
  all ranks per operation; payloads ride the shared-memory object store, so
  intra-host traffic is zero-copy and inter-host goes through the transfer
  relay.
* **device collectives** (``backend="nccl"``): the card's tensors meet in a
  ``torch.distributed`` process group, which ``ray_tpu_torch.parallel``
  builds as a ``Mesh`` (``parallel/mesh.py``, ``parallel/collectives.py``);
  ``init_collective_group`` refuses them with that pointer.

Semantics notes: every collective is a synchronous rendezvous (all ranks
must call it); operations on one group are sequenced by per-rank call
counts, so ranks must issue the same collectives in the same order — the
same contract NCCL/Gloo impose.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.util import events as plane_events


class ReduceOp:
    SUM = "sum"
    PRODUCT = "prod"
    MIN = "min"
    MAX = "max"


class CollectiveError(RuntimeError):
    """Base of the typed collective failure plane."""


class CollectiveMemberLost(CollectiveError):
    """A group member died while this collective was pending (or before
    it was issued). Pushed by the gang fault plane: the GCS publishes
    membership loss on the gang channel, the coordinator fails every
    pending op immediately, and every blocked rank raises THIS — naming
    the lost ranks and the gang generation — instead of waiting out
    ``collective_timeout_s``. The caller reshapes (re-forms the group at
    the surviving size from its last checkpoint) or fails the run."""

    def __init__(self, lost_ranks, generation: int = 0, cause: str = ""):
        self.lost_ranks = sorted(lost_ranks)
        self.generation = generation
        self.cause = cause
        super().__init__(
            f"collective member(s) {self.lost_ranks} lost "
            f"(gang generation {generation})"
            + (f": {cause}" if cause else ""))

    def __reduce__(self):
        return (type(self), (self.lost_ranks, self.generation, self.cause))


class StaleCollectiveGeneration(CollectiveError):
    """A rank from a superseded gang generation tried to join a
    collective (or a rank from a NEWER generation reached a coordinator
    that was never torn down). Generations are assigned monotonically by
    the GCS at gang registration; after a reshape the stale side must
    never be able to complete an op against the re-formed group."""

    def __init__(self, generation: int, current: int):
        self.generation = generation
        self.current = current
        super().__init__(
            f"stale collective generation {generation} "
            f"(coordinator is at generation {current})")

    def __reduce__(self):
        return (type(self), (self.generation, self.current))


class CollectiveTimeout(CollectiveError, TimeoutError):
    """A collective rendezvous exceeded ``collective_timeout_s`` with no
    membership-loss event: the missing ranks are alive but never issued
    the op (desynchronized program order, a wedged peer). Names the
    ranks that never arrived — the caller's escalation path probes gang
    membership to distinguish this from an undetected death."""

    def __init__(self, kind: str, seq: int, missing_ranks, timeout_s: float):
        self.kind = kind
        self.seq = seq
        self.missing_ranks = sorted(missing_ranks)
        self.timeout_s = timeout_s
        super().__init__(
            f"collective {kind!r} (seq {seq}) timed out after "
            f"{timeout_s:.0f}s: rank(s) {self.missing_ranks} never arrived")

    def __reduce__(self):
        return (type(self), (self.kind, self.seq, self.missing_ranks,
                             self.timeout_s))


# Broadcast payloads at least this large ride the object store as ONE
# shared object (cooperative chunk-striped pull) instead of being copied
# into every rank's rendezvous reply.
_BCAST_REF_MIN = 1 << 20

_REDUCERS = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
}


# Pending-rendezvous-ops queue-depth gauge (flight-recorder telemetry;
# lazy + recorder-gated via events.gauge).
_set_pending_ops = plane_events.gauge(
    "collective_pending_ops", "rendezvous ops awaiting contributions",
    tag_keys=("gang",))


class _Coordinator:
    """Per-group rendezvous actor (async). One instance per group name.

    Generation-aware and fail-fast: when formed for a registered gang,
    it subscribes to the gang's GCS channel — a member-death push fails
    every pending op with :class:`CollectiveMemberLost` in event time
    (never waiting out the rendezvous timeout), rejects new ops, and
    rejects any caller whose generation doesn't match the gang
    generation it was formed at (:class:`StaleCollectiveGeneration`)."""

    def __init__(self, world_size: int, gang: Optional[str] = None,
                 generation: int = 0, timeout_s: Optional[float] = None):
        from ray_tpu_torch._private.config import config as _cfg

        self.world = world_size
        self.gang = gang
        self.generation = generation
        self.timeout_s = (float(timeout_s) if timeout_s is not None
                          else _cfg().collective_timeout_s)
        self._ops: Dict[tuple, dict] = {}  # (kind, seq) -> state
        self._lost: Dict[int, str] = {}
        self._watch_started = False
        self._sub = None

    def _ensure_watch(self):
        """Start the gang-channel watcher (idempotent; lazy so it runs
        on the actor's loop). The Subscriber blocks on the worker IO
        loop during setup, so it is built from a helper thread and
        marshals events back with ``call_soon_threadsafe``."""
        if self._watch_started or not self.gang:
            return
        self._watch_started = True
        import asyncio

        loop = asyncio.get_running_loop()

        def pump():
            from ray_tpu_torch._private import failpoints
            from ray_tpu_torch._private.worker import global_worker
            from ray_tpu_torch.util.pubsub import Subscriber

            try:
                sub = Subscriber(f"gang:{self.gang}")
            except Exception:
                return  # no control plane (torn down mid-start)
            self._sub = sub
            # Close the subscribe/publish race: a member killed BEFORE
            # this subscription existed (the rendezvous-gap window)
            # already published its loss — probe the gang record once so
            # the push-before-subscribe case converges identically.
            try:
                info = global_worker().request_gcs(
                    {"t": "gang_info", "name": self.gang}, timeout=10)
                lost = info.get("lost") or []
                if (info.get("registered")
                        and info.get("generation") == self.generation
                        and lost):
                    causes = info.get("lost_causes") or {}
                    loop.call_soon_threadsafe(
                        self._apply_member_lost, lost,
                        next(iter(causes.values()), "member lost"))
            except Exception:
                pass
            for item in sub:
                m = item.get("message") or {}
                if (m.get("event") == "member_lost"
                        and m.get("generation") == self.generation):
                    failpoints.fire("collective.coord.push")
                    try:
                        loop.call_soon_threadsafe(
                            self._apply_member_lost,
                            m.get("lost_ranks") or m.get("ranks") or [],
                            str(m.get("cause") or "member lost"))
                    except RuntimeError:
                        return  # actor loop gone

        threading.Thread(target=pump, daemon=True,
                         name=f"gang-watch-{self.gang}").start()

    def _apply_member_lost(self, ranks, cause: str):
        """Fail every pending op NOW; GC op state whose remaining takers
        are all lost (a rank that died after contributing but before
        pickup would otherwise strand its (kind, seq) entry forever —
        the last-rank-out cleanup can no longer fire)."""
        plane_events.emit("coll.op.member_lost", plane="coll",
                          gang=self.gang or "", gen=self.generation,
                          ranks=[int(r) for r in ranks], cause=cause,
                          pending=len(self._ops))
        for r in ranks:
            self._lost.setdefault(int(r), cause)
        lost = set(self._lost)
        for key, st in list(self._ops.items()):
            if not st["event"].is_set():
                st["error"] = {"ranks": sorted(lost), "cause": cause}
                st["event"].set()
                self._ops.pop(key, None)
            elif st["expect"] - st.setdefault("taken", set()) <= lost:
                self._ops.pop(key, None)
        self._pending_gauge()

    def _check(self, generation: Optional[int]):
        if generation is not None and generation != self.generation:
            raise StaleCollectiveGeneration(generation, self.generation)
        if self._lost:
            raise CollectiveMemberLost(
                sorted(self._lost), self.generation,
                next(iter(self._lost.values())))

    async def member_lost(self, ranks, cause: str = "member lost",
                          generation: Optional[int] = None) -> bool:
        """Direct membership-loss push (the worker group's driver-side
        watcher uses this as belt-and-braces alongside the coordinator's
        own gang subscription; tests drive it directly)."""
        if generation is not None and generation != self.generation:
            return False
        self._apply_member_lost(list(ranks), cause)
        return True

    async def debug_state(self) -> dict:
        return {"generation": self.generation, "gang": self.gang,
                "world": self.world, "lost": sorted(self._lost),
                "pending_ops": sorted(
                    [list(k) for k in self._ops],
                    key=lambda k: (str(k[0]), k[1]))}

    def _get(self, kind: str, seq: int, expect=None) -> dict:
        import asyncio

        key = (kind, seq)
        st = self._ops.get(key)
        if st is None:
            st = {"parts": {}, "event": asyncio.Event(), "result": None,
                  "error": None, "t0": time.time(),
                  "expect": (set(expect) if expect is not None
                             else set(range(self.world)))}
            self._ops[key] = st
            plane_events.emit("coll.op.begin", plane="coll", kind=kind,
                              seq=seq, gang=self.gang or "",
                              gen=self.generation,
                              pending=len(self._ops))
            self._pending_gauge()
        return st

    def _pending_gauge(self):
        """Queue-depth telemetry: pending rendezvous ops on this
        coordinator (flows through the ordinary metrics push)."""
        _set_pending_ops(len(self._ops), gang=self.gang or "anon")

    async def collect(self, kind: str, seq: int, rank: int, data: Any,
                      op: str = "sum", src_rank: int = 0,
                      generation: Optional[int] = None) -> Any:
        """Generic all-to-one-to-all rendezvous; returns this rank's part."""
        import asyncio

        from ray_tpu_torch._private import failpoints

        # Chaos site: kill/delay the COORDINATOR mid-stream (the
        # coordinator-death-mid-allreduce schedule) — a kill here takes
        # the whole coordinator worker process with it.
        failpoints.fire("collective.coord.collect", key=kind)
        self._ensure_watch()
        self._check(generation)
        st = self._get(kind, seq)
        st["parts"][rank] = data
        plane_events.emit("coll.op.contribute", plane="coll", kind=kind,
                          seq=seq, rank=rank, gang=self.gang or "",
                          gen=self.generation,
                          have=len(st["parts"]), world=self.world)
        if len(st["parts"]) == self.world:
            parts = [st["parts"][r] for r in range(self.world)]
            if kind == "allreduce":
                st["result"] = _REDUCERS[op](np.stack(
                    [np.asarray(p) for p in parts]))
            elif kind == "allgather":
                st["result"] = [np.asarray(p) for p in parts]
            elif kind == "reducescatter":
                red = _REDUCERS[op](np.stack([np.asarray(p) for p in parts]))
                st["result"] = np.array_split(red, self.world)
            elif kind == "broadcast":
                arr = np.asarray(st["parts"][src_rank])
                if arr.nbytes >= _BCAST_REF_MIN and self.world > 1:
                    # Large broadcast: put ONCE and hand every rank the
                    # same ref — ranks pull the single object over the
                    # cooperative chunk-striped broadcast plane instead
                    # of each reply re-serializing the full payload.
                    st["result"] = ray_tpu_torch.put(arr)
                else:
                    st["result"] = arr
            elif kind == "barrier":
                st["result"] = True
            plane_events.emit("coll.op.complete", plane="coll",
                              kind=kind, seq=seq, gang=self.gang or "",
                              gen=self.generation,
                              dur=time.time() - st.get("t0", time.time()))
            st["event"].set()
        else:
            try:
                await asyncio.wait_for(st["event"].wait(),
                                       timeout=self.timeout_s)
            except (asyncio.TimeoutError, TimeoutError):
                missing = sorted(set(range(self.world))
                                 - set(st["parts"]))
                raise CollectiveTimeout(kind, seq, missing,
                                        self.timeout_s) from None
        if st["error"] is not None:
            raise CollectiveMemberLost(st["error"]["ranks"],
                                       self.generation,
                                       st["error"]["cause"])
        result = st["result"]
        # Last LIVE rank out cleans up (lost ranks can never pick up, so
        # they stop counting toward the takers the entry waits for).
        st.setdefault("taken", set()).add(rank)
        if st["expect"] - st["taken"] <= set(self._lost):
            self._ops.pop((kind, seq), None)
            self._pending_gauge()
        if kind == "reducescatter":
            return result[rank]
        return result

    async def send(self, seq: int, dst: int, data: Any,
                   generation: Optional[int] = None):
        self._ensure_watch()
        self._check(generation)
        st = self._get(f"p2p-{dst}", seq, expect={dst})
        st["result"] = data
        st["event"].set()

    async def recv(self, seq: int, dst: int,
                   generation: Optional[int] = None) -> Any:
        import asyncio

        self._ensure_watch()
        self._check(generation)
        st = self._get(f"p2p-{dst}", seq, expect={dst})
        try:
            await asyncio.wait_for(st["event"].wait(),
                                   timeout=self.timeout_s)
        except (asyncio.TimeoutError, TimeoutError):
            raise CollectiveTimeout(f"p2p-{dst}", seq, [],
                                    self.timeout_s) from None
        if st["error"] is not None:
            raise CollectiveMemberLost(st["error"]["ranks"],
                                       self.generation,
                                       st["error"]["cause"])
        self._ops.pop((f"p2p-{dst}", seq), None)
        return st["result"]


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int,
                 coordinator: "ray_tpu_torch.ActorHandle",
                 generation: Optional[int] = None):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.generation = generation
        self.seqs: Dict[str, int] = {}
        self.lock = threading.Lock()

    def next_seq(self, kind: str) -> int:
        with self.lock:
            s = self.seqs.get(kind, 0)
            self.seqs[kind] = s + 1
            return s


_groups: Dict[str, _GroupState] = {}


def init_collective_group(world_size: int, rank: int,
                          backend: str = "shm",
                          group_name: str = "default",
                          gang: Optional[str] = None,
                          generation: Optional[int] = None) -> None:
    """Join a collective group (call once per rank, any process).

    ``gang``/``generation`` bind the group to a GCS-registered gang
    (``WorkerGroup`` formation): the coordinator then fails pending ops
    on membership-loss pushes, and every op is stamped with this rank's
    generation so a superseded gang's ranks are rejected instead of
    deadlocking the re-formed group."""
    if backend in ("nccl", "cuda"):
        raise ValueError(
            "Device collectives run in a torch.distributed process group: "
            "use ray_tpu_torch.parallel (Mesh over the group's ranks, "
            "parallel.collectives) instead of a runtime collective group. "
            "The 'shm' backend covers host-memory tensors.")
    if backend not in ("shm", "gloo"):
        raise ValueError(f"unknown collective backend {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    name = f"_collective_{group_name}"
    try:
        coord = ray_tpu_torch.get_actor(name)
    except ValueError:
        try:
            ray_tpu_torch.remote(_Coordinator).options(
                name=name, lifetime="detached", num_cpus=0).remote(
                    world_size, gang=gang, generation=generation or 0)
        except Exception:
            pass  # lost the creation race — resolve below
        # Re-resolve through the name registry regardless of who won the
        # creation race: racing ranks must all converge on the REGISTERED
        # instance, not on their own provisional handle, or the rendezvous
        # deadlocks split across two coordinators.
        deadline = time.time() + 30
        while True:
            try:
                coord = ray_tpu_torch.get_actor(name)
                break
            except ValueError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
    _groups[group_name] = _GroupState(group_name, world_size, rank, coord,
                                      generation=generation)


def destroy_collective_group(group_name: str = "default") -> None:
    st = _groups.pop(group_name, None)
    if st is not None and st.rank == 0:
        try:
            ray_tpu_torch.kill(st.coordinator)
        except Exception:
            pass


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _groups[group_name].rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _groups[group_name].world_size


def _g(group_name: str) -> _GroupState:
    st = _groups.get(group_name)
    if st is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized in this "
            f"process; call init_collective_group first")
    return st


def _client_timeout() -> float:
    """Caller-side cap on coordinator round trips: the coordinator's own
    rendezvous timeout plus slack for the reply — the coordinator is the
    one that raises the TYPED timeout naming the missing ranks, so the
    client deadline must never beat it to the punch."""
    from ray_tpu_torch._private.config import config as _cfg

    return _cfg().collective_timeout_s + 30.0


def _rendezvous(kind: str, tensor, group_name: str, **kw):
    st = _g(group_name)
    seq = st.next_seq(kind)
    out = ray_tpu_torch.get(st.coordinator.collect.remote(
        kind, seq, st.rank, tensor, generation=st.generation, **kw),
        timeout=_client_timeout())
    if isinstance(out, ray_tpu_torch.ObjectRef):
        # Large-broadcast result: one shared object, pulled per node over
        # the cooperative broadcast plane. Copy out of the store view:
        # get() hands every same-node rank zero-copy views over the SAME
        # arena range, and broadcast() has always returned a private
        # mutable array per rank — in-place updates must not corrupt the
        # shared object (or trip read-only views) for the other ranks.
        out = np.array(ray_tpu_torch.get(out, timeout=_client_timeout()),
                       copy=True)
    return out


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM):
    """All ranks contribute; every rank gets the elementwise reduction."""
    out = _rendezvous("allreduce", np.asarray(tensor), group_name, op=op)
    return out


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    """Every rank gets the list of all ranks' tensors (rank order)."""
    return _rendezvous("allgather", np.asarray(tensor), group_name)


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM):
    """Reduce across ranks, then scatter row-chunks; rank i gets chunk i."""
    return _rendezvous("reducescatter", np.asarray(tensor), group_name,
                       op=op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Every rank gets ``src_rank``'s tensor."""
    return _rendezvous("broadcast", np.asarray(tensor), group_name,
                       src_rank=src_rank)


def barrier(group_name: str = "default") -> None:
    _rendezvous("barrier", None, group_name)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    st = _g(group_name)
    seq = st.next_seq(f"p2p-{dst_rank}")
    ray_tpu_torch.get(st.coordinator.send.remote(seq, dst_rank,
                                           np.asarray(tensor),
                                           generation=st.generation))


def recv(src_rank: int, group_name: str = "default"):
    """Receive the next tensor addressed to this rank.

    (Point-to-point ordering is per-destination FIFO; ``src_rank`` is
    accepted for API parity with the reference but delivery is by send
    order, matching single-sender usage.)
    """
    st = _g(group_name)
    seq = st.seqs.get(f"p2p-{st.rank}-recv", 0)
    st.seqs[f"p2p-{st.rank}-recv"] = seq + 1
    return ray_tpu_torch.get(st.coordinator.recv.remote(
        seq, st.rank, generation=st.generation),
        timeout=_client_timeout())
