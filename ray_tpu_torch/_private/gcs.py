"""Global control service: the cluster's single control-plane authority.

TPU-native re-design of the reference's GCS + raylet split
(``src/ray/gcs/gcs_server/gcs_server.cc``, ``src/ray/raylet/node_manager.h``).
The reference distributes scheduling across per-node raylets with worker
leases because its clusters are thousands of CPU nodes; a TPU cluster is a
small number of *hosts* (one per 4-8 chips) each fronting enormous compute,
so a centralized asyncio control plane comfortably covers the control-plane
rates that matter (§6 of SURVEY.md) while being radically simpler. The
sched­uler still implements the reference's policy surface: hybrid
pack-then-spread (``raylet/scheduling/policy/hybrid_scheduling_policy.h:50``),
SPREAD, node-affinity, and placement-group bundle placement with
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD (``policy/bundle_scheduling_policy.cc``).

Components in this process (each a manager class, mirroring the reference's
``gcs_server.h:128-161`` Init* list):
  * NodeDirectory    — node membership + resource accounting
  * WorkerDirectory  — worker registration, pools, liveness
  * TaskManager      — queueing, scheduling, retries, lineage for recon
  * ObjectDirectory  — object table, inline store, waiters, LRU eviction
  * ActorDirectory   — actor lifecycle state machine, named actors, restarts
  * PlacementGroups  — bundle reservation across nodes
  * KV               — namespaced key-value store (functions, metadata)
"""

from __future__ import annotations

import asyncio
import logging
import math
import os
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.util import events as plane_events

from . import failpoints, protocol
from .broadcast import bitmap_make, bitmap_set, bitmap_test
from .config import config as _cfg
from .gcs_shards import ShardedDict
from .ids import ActorID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from .object_store import make_store, spill_budget

logger = logging.getLogger(__name__)

# Worker states
W_STARTING = "starting"
W_IDLE = "idle"
W_BUSY = "busy"
W_ACTOR = "actor"
W_DEAD = "dead"

# Actor states (reference: gcs_actor_manager.h:89 state machine)
A_PENDING = "pending"
A_ALIVE = "alive"
A_RESTARTING = "restarting"
A_DEAD = "dead"

# Node lifecycle states (reference: the DrainNode protocol in
# autoscaler.proto + GCS node state transitions): ALIVE -> DRAINING ->
# DEAD. A DRAINING node accepts no new placements (tasks, actors, PG
# bundles); in-flight work gets until the drain deadline, after which the
# node is force-transitioned to DEAD and normal recovery (task retry,
# lineage reconstruction, actor restart) takes over.
N_ALIVE = "ALIVE"
N_DRAINING = "DRAINING"
N_DEAD = "DEAD"


def _read_spilled(path: str) -> bytes:
    """Blocking spilled-object read — always called via run_in_executor
    (the payload spilled because it was big; see _do_pull). Draws from
    the shared spill IO budget as a RESTORE lane so full-file relays and
    striped chunk serves are paced by one byte bucket."""
    n = max(1, os.path.getsize(path))
    budget = spill_budget()
    budget.acquire(n, "restore")
    try:
        with open(path, "rb") as f:
            return f.read()
    finally:
        budget.release(n)


def _res_fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in req.items())


def _res_sub(avail: Dict[str, float], req: Dict[str, float]):
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


def _res_add(avail: Dict[str, float], req: Dict[str, float]):
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) + v


# A staged copy of a node's resources carries each card's unleased share
# under this prefix + its id, so bundle staging places cards as well.
_CARD = "GPU#"
# How long a store block stays unreferenced before it is freed (_doom).
_ZERO_REF_FREE_S = 2.0


def _gpu_pick(free: Dict[str, float], want: float,
              prefer: Sequence[str] = ()) -> Optional[List[str]]:
    """The card ids a request for ``want`` GPUs takes from ``free`` (card
    id -> unleased share), or None when no card can take it: a fraction
    needs one card with that share free (the fullest such card, so 0.5 +
    0.5 share one), a whole count that many free cards. Cards in
    ``prefer`` (those a bundle's surviving holders still use) go first."""
    first = [i for i in prefer if i in free]
    order = first + [i for i in sorted(free, key=int) if i not in first]
    if want < 1.0:
        fits = [i for i in order if free[i] >= want - 1e-9]
        if any(i in first for i in fits):
            fits = [i for i in fits if i in first]
        return [min(fits, key=lambda i: free[i])] if fits else None
    whole = [i for i in order if free[i] >= 1.0 - 1e-9]
    n = math.ceil(want - 1e-9)
    return whole[:n] if len(whole) >= n else None


def _gpu_share(want: float) -> float:
    """What a request for ``want`` GPUs takes of each card it is given."""
    return want if want < 1.0 else 1.0


def _gpu_fits(free: Dict[str, float], want: float) -> bool:
    return want <= 0 or _gpu_pick(free, want) is not None


def _gpu_take(free: Dict[str, float], want: float,
              prefer: Sequence[str] = ()) -> Dict[str, float]:
    """Take a placeable request's cards out of ``free``: id -> share."""
    if want <= 0:
        return {}
    share = _gpu_share(want)
    taken = {i: share for i in _gpu_pick(free, want, prefer)}
    for i in taken:
        free[i] -= share
    return taken


class NodeInfo:
    def __init__(self, node_id: NodeID, resources: Dict[str, float], hostname: str,
                 agent_conn: Optional[protocol.Connection]):
        self.node_id = node_id
        self.total = dict(resources)
        self.avail = dict(resources)
        self.hostname = hostname
        self.agent_conn = agent_conn
        self.alive = True
        # Graceful drain (ALIVE -> DRAINING -> DEAD): while draining the
        # scheduler refuses new placements here; at drain_deadline the
        # node is forced DEAD (timer handle kept for cancellation).
        self.draining = False
        self.drain_reason = ""
        self.drain_deadline = 0.0
        self.drain_timer = None
        self.idle_workers: deque = deque()  # WorkerID
        self.workers: Set[WorkerID] = set()
        self.spawning = 0
        # Stale-spawn decay (chaos-found): a spawn request lost between
        # GCS and agent (dropped frame, agent crash mid-spawn) would pin
        # ``spawning`` forever — the health loop releases slots whose
        # worker hello never arrived within spawn_timeout_s.
        self.spawn_ts = 0.0
        self.last_active = time.time()  # autoscaler idle tracking
        # P2P object plane: the agent's chunk-serving address and which
        # arena it serves ("" = the head-host arena).
        self.obj_addr: Optional[str] = None
        self.store_suffix: str = ""
        # GPU id -> unleased share of that card (1.0 = free); ids are
        # indices into the node's visible cards.
        self.gpu_free: Dict[str, float] = {}
        self.sync_gpu_ids()

    def sync_gpu_ids(self):
        for i in range(int(self.total.get("GPU", 0.0))):
            self.gpu_free.setdefault(str(i), 1.0)

    def utilization(self) -> float:
        cpu_t = self.total.get("CPU", 0.0)
        if cpu_t <= 0:
            return 0.0
        return 1.0 - self.avail.get("CPU", 0.0) / cpu_t

    def lifecycle_state(self) -> str:
        if not self.alive:
            return N_DEAD
        return N_DRAINING if self.draining else N_ALIVE

    def schedulable(self) -> bool:
        return self.alive and not self.draining


class WorkerInfo:
    def __init__(self, worker_id: WorkerID, node_id: NodeID,
                 conn: protocol.Connection, addr: str, pid: int):
        self.worker_id = worker_id
        self.node_id = node_id
        self.conn = conn
        self.addr = addr
        self.pid = pid
        self.obj_addr = ""  # TCP chunk-serve endpoint (broadcast plane)
        self.env_key = ""  # interpreter env pool ("" = base image)
        self.state = W_IDLE
        self.current_task: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        self.acquired: Dict[str, float] = {}
        # Lease state (reference: worker leases granted by the raylet,
        # node_manager.h:522): while leased, the owner driver pushes tasks
        # directly to the worker and the GCS only tracks the grant.
        self.leased_to: Optional["ClientConn"] = None
        self.lease_ctx = None  # the LeaseDemand (for resource release)
        # GPU ids this worker holds, the share of each, the pool they
        # return to (the node's cards or a placement-group bundle's), and
        # whether it was ever pinned (a pinned worker is retired, never
        # reused).
        self.gpu_ids: List[str] = []
        self.gpu_share = 0.0
        self.gpu_pool: Optional[Dict[str, float]] = None
        self.gpu_pinned = False
        # The cards a worker that survived a GCS restart reports in its
        # resync hello: it holds them until its actor or lease ends.
        self.gpu_reported: List[str] = []


class TaskRecord:
    __slots__ = ("task_id", "msg", "owner", "retries_left", "state", "worker_id",
                 "cancelled", "resources", "pg", "bundle", "strategy", "returns",
                 "name", "ts_created", "ts_running", "ts_done", "error",
                 "node_id", "sig", "env_key", "env_spec")

    def __init__(self, task_id: TaskID, msg: dict, owner: "ClientConn"):
        self.task_id = task_id
        self.msg = msg
        self.owner = owner
        opts = msg.get("opts") or {}
        self.retries_left = opts.get("retries", 3)
        self.resources = opts.get("res") or {"CPU": 1.0}
        self.pg = opts.get("pg")
        self.bundle = opts.get("bix")
        self.strategy = opts.get("sched") or "DEFAULT"
        self.name = opts.get("name", "")
        # Scheduling class (reference: scheduling classes keyed by resource
        # shape in NormalTaskSubmitter): tasks with identical placement needs
        # share one pending queue, so a scheduling pass is O(dispatched +
        # distinct classes), never O(queue length).
        self.env_key = ""
        self.env_spec = None
        renv = opts.get("runtime_env")
        if renv:
            from .roadmap import not_ported

            raise not_ported("runtime_env", "runtime_env")
        strategy = self.strategy
        if isinstance(strategy, dict):
            strategy = tuple(sorted(strategy.items()))
        self.sig = (tuple(sorted(self.resources.items())), self.pg,
                    self.bundle, strategy, self.env_key)
        self.state = "pending"
        self.worker_id: Optional[WorkerID] = None
        self.node_id: Optional[NodeID] = None
        self.cancelled = False
        # Task-event timestamps (reference: per-task state-transition events
        # collected by GcsTaskManager, gcs_task_manager.h:86).
        self.ts_created = time.time()
        self.ts_running = 0.0
        self.ts_done = 0.0
        self.error = False
        self.returns: List[ObjectID] = [
            ObjectID.for_task_return(task_id, i + 1)
            for i in range(1 if msg.get("nret") == "dyn"
                           else msg.get("nret", 1))
        ]


class ObjectEntry:
    __slots__ = ("object_id", "nbytes", "ready", "inline", "on_shm", "refcount",
                 "waiters", "producing_task", "spilled", "holders", "owner",
                 "partial", "pullers", "cs", "pseq")

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id
        self.nbytes = 0
        self.ready = False
        self.inline: Optional[bytes] = None
        self.on_shm = False
        self.refcount = 0
        self.waiters: List[Tuple[protocol.Connection, dict]] = []
        self.producing_task: Optional[dict] = None  # retained spec for recon
        self.spilled: Optional[str] = None
        # Object-directory bits (reference: ObjectDirectory on the
        # object-location pubsub channel, object_manager/object_directory.h):
        # which nodes' host stores hold the bytes, and the owning client conn
        # (serves uploads for store namespaces no node shares, e.g. remote
        # ray:// client drivers).
        self.holders: Set[bytes] = set()
        self.owner: Optional["ClientConn"] = None
        # Chunk-level holder registration (cooperative broadcast): serve
        # addr -> [node_id_bytes, chunk bitmap, completed count] for
        # pullers that hold SOME chunks mid-pull, the object's canonical
        # chunk size (set by the first progress report), and each active
        # puller's [ordinal, current source set] (the stagger index for
        # stripe ownership + the per-holder in-flight serve load). All
        # lazily allocated — most objects are never broadcast.
        self.partial: Optional[Dict[str, list]] = None
        self.pullers: Optional[Dict[int, list]] = None
        self.cs = 0
        self.pseq = 0  # monotone puller-ordinal counter


class ActorRecord:
    def __init__(self, actor_id: ActorID, msg: dict, owner: "ClientConn"):
        self.actor_id = actor_id
        self.msg = msg
        self.owner = owner
        opts = msg.get("opts") or {}
        self.name: Optional[str] = opts.get("name")
        self.namespace: str = opts.get("namespace") or "default"
        self.detached: bool = opts.get("lifetime") == "detached"
        self.resources: Dict[str, float] = opts.get("res") or {"CPU": 1.0}
        self.max_restarts: int = opts.get("max_restarts", 0)
        self.restarts_used = 0
        self.pg = opts.get("pg")
        self.bundle = opts.get("bix")
        self.env_key = ""
        self.env_spec = None
        renv = opts.get("runtime_env")
        if renv:
            from .roadmap import not_ported

            raise not_ported("runtime_env", "runtime_env")
        self.state = A_PENDING
        self.worker_id: Optional[WorkerID] = None
        self.addr: Optional[str] = None
        self.node_id: Optional[NodeID] = None
        self.addr_waiters: List[Tuple[protocol.Connection, dict]] = []
        self.death_cause: Optional[str] = None
        # Set while the actor is proactively moved off a DRAINING node:
        # the next worker death is an orchestrated migration, not a crash
        # — restart without consuming the restart budget.
        self.migrating = False
        # GCS-restart recovery (owner re-linked by worker_id on driver
        # reconnect; ``restored`` marks records awaiting re-claim).
        self.owner_wid: Optional[bytes] = None
        self.restored = False


# Gang lifecycle (train fault plane): FORMING is client-side (the group
# registers once every member answered its formation ping), so the GCS
# only ever holds ACTIVE and DEGRADED records; RESHAPING is the window
# between a deregister/teardown and the next register, which lands as a
# NEW record at generation+1.
G_ACTIVE = "ACTIVE"
G_DEGRADED = "DEGRADED"


class GangRecord:
    """A gang-scheduled worker group's membership record.

    The fault-plane primitive: members (rank -> actor id) plus a
    per-name MONOTONIC generation number assigned by the GCS at
    registration (durable across control-plane restarts via WAL, so a
    superseded gang can never reuse a generation). Death and drain
    lifecycle events on any member PUSH a ``gang:<name>`` pubsub event
    to survivors — membership loss is detected in event time, never by
    waiting out a collective timeout."""

    __slots__ = ("name", "generation", "members", "lost", "status",
                 "owner", "ts")

    def __init__(self, name: str, generation: int,
                 member_aids: List[ActorID], owner: "ClientConn"):
        self.name = name
        self.generation = generation
        self.members: Dict[int, ActorID] = dict(enumerate(member_aids))
        self.lost: Dict[int, str] = {}
        self.status = G_ACTIVE
        self.owner = owner
        self.ts = time.time()


class ObsTaskRecord:
    """Observability-only task record built from owner task notes (the
    direct lease path never routes task state through the scheduler)."""

    __slots__ = ("task_id", "state", "name", "error", "node_id", "worker_id",
                 "resources", "ts_created", "ts_running", "ts_done",
                 "cancelled", "pg")

    def __init__(self, task_id: TaskID):
        self.task_id = task_id
        self.state = "pending"
        self.name = ""
        self.error = False
        self.node_id: Optional[NodeID] = None
        self.worker_id: Optional[WorkerID] = None
        self.resources: Dict[str, float] = {}
        self.ts_created = 0.0
        self.ts_running = 0.0
        self.ts_done = 0.0
        self.cancelled = False
        self.pg = None


class PGRecord:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, name: str, owner: "ClientConn"):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.owner = owner
        self.state = "pending"
        self.placement: List[Optional[NodeID]] = [None] * len(bundles)
        # Per-bundle available resources once reserved.
        self.bundle_avail: List[Dict[str, float]] = [dict(b) for b in bundles]
        # Per bundle, the cards reserved on its node (id -> share) and
        # the part of them no task or actor of the bundle holds.
        self.gpu_held: List[Dict[str, float]] = [{} for _ in bundles]
        self.gpu_free: List[Dict[str, float]] = [{} for _ in bundles]
        self.ready_waiters: List[Tuple[protocol.Connection, dict]] = []
        # Tenant accounting: the owning driver's namespace and the
        # group's aggregate demand (quota is charged at reservation).
        self.tenant = getattr(owner, "namespace", None) or "default"
        self.quota_charged = False


class _ClaimedLeaseCtx:
    """Lease context rebuilt from a post-restart ``lease_claim`` resync:
    carries exactly what release-time accounting needs (tenant + charged
    resources; never PG-scoped — PG leases don't survive a restart as
    claims). Exists so quota usage charged at re-claim is released by the
    same ``_release_lease`` path as a normal grant's."""

    __slots__ = ("tenant", "resources", "pg", "bundle")

    def __init__(self, tenant: str, resources: Dict[str, float]):
        self.tenant = tenant
        self.resources = resources
        self.pg = None
        self.bundle = None


class LeaseDemand:
    """A driver's request for N leased workers of one scheduling class.

    Reference: ``RequestWorkerLease`` (node_manager.proto:387) — the grant
    hands the worker to the driver, which then pushes tasks to it directly
    (``NormalTaskSubmitter`` lease reuse, normal_task_submitter.h:108).
    Scheduled through the same pending queues as GCS-dispatched tasks so
    placement strategies and fairness apply uniformly.
    """

    __slots__ = ("client", "key", "count", "resources", "pg", "bundle",
                 "strategy", "sig", "cancelled", "env_key", "env_spec",
                 "tenant")

    def __init__(self, client: "ClientConn", msg: dict):
        self.client = client
        # Resolved at enqueue by the GCS (_client_tenant): the tenant
        # this demand draws quota from — stored so grant and release
        # stay symmetric even if the client's lease binding changes.
        self.tenant = "default"
        self.key = msg["key"]  # opaque class token, echoed in grants
        self.count = max(1, int(msg.get("n", 1)))
        self.resources = msg.get("res") or {"CPU": 1.0}
        self.pg = msg.get("pg")
        self.bundle = msg.get("bix")
        self.strategy = msg.get("sched") or "DEFAULT"
        self.cancelled = False
        # Interpreter env pool this demand draws from ("" = base image);
        # reference analog: per-runtime-env worker pools, worker_pool.h:174.
        self.env_key = msg.get("env_key", "")
        self.env_spec = msg.get("renv_spawn")
        strategy = self.strategy
        if isinstance(strategy, dict):
            strategy = tuple(sorted(strategy.items()))
        self.sig = (tuple(sorted(self.resources.items())), self.pg,
                    self.bundle, strategy, self.env_key, id(client))


class PendingQueues:
    """Pending work bucketed by scheduling class (``record.sig``): task
    records (GCS-dispatched path) and lease demands (direct path).

    One deque per class keeps FIFO order within a class; a blocked class is
    skipped in O(1) instead of re-examining each of its entries every pass.
    """

    __slots__ = ("qs", "count")

    def __init__(self):
        self.qs: Dict[tuple, deque] = {}
        self.count = 0

    def append(self, record):
        q = self.qs.get(record.sig)
        if q is None:
            q = self.qs[record.sig] = deque()
        q.append(record)
        self.count += 1

    def remove(self, record) -> bool:
        q = self.qs.get(record.sig)
        if q is None:
            return False
        try:
            q.remove(record)
        except ValueError:
            return False
        self.count -= 1
        if not q:
            del self.qs[record.sig]
        return True

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        for q in self.qs.values():
            yield from q


_client_serial = iter(range(1, 1 << 62)).__next__

# Handlers that await a peer round trip mid-body: dispatched as their own
# task so they cannot stall the shared fair-drain loop.
_SPAWNED_HANDLERS = frozenset({"worker_memdump"})


class WaitGroup:
    """One ``obj_waits`` request's server-side state (the vectorized
    reference plane): N oids + a num_returns threshold registered in ONE
    frame. The group replies once when the threshold is met (carrying
    every resolution row gathered so far); rows resolving after the
    reply stream back as coalesced ``obj_res`` pushes. Replaces N
    per-ref request/reply pairs with O(1) frames per call."""

    __slots__ = ("client", "msg", "need", "rows", "replied")

    def __init__(self, client: "ClientConn", msg: dict, need: int,
                 rows: list):
        self.client = client
        self.msg = msg
        self.need = need
        self.rows = rows  # gathered resolution rows until the reply
        self.replied = False


class ClientConn:
    """A registered client: driver, worker, or node agent."""

    def __init__(self, conn: protocol.Connection):
        self.conn = conn
        self.role = "unknown"
        self.serial = _client_serial()
        self.worker_id: Optional[WorkerID] = None
        self.node_id: Optional[NodeID] = None
        # Tenant identity: the namespace this driver connected under
        # (hello field). Quotas and named-actor isolation key on it.
        self.namespace = "default"
        # (oid_bytes, serve_addr|None) pairs this client registered via
        # obj_progress — retired when the client disconnects so dead
        # pullers don't linger as partial holders.
        self.pull_regs: Set[tuple] = set()
        # Post-threshold wait-group resolution rows awaiting a coalesced
        # obj_res push (flushed on the next loop tick or at the row cap).
        self.res_rows: list = []
        # Fair-ingress lane: frames read off this client's socket park
        # here; the round-robin drain (GcsServer._ingress_drain) hands
        # each lane at most fair_slice frames per cycle.
        self.inq: deque = deque()
        # Admission state: True once a backpressure-on frame was sent and
        # this client's read loop is parked on bp_event.
        self.bp_on = False
        self.bp_event: Optional[asyncio.Event] = None
        # Disconnect observed while frames were still queued: cleanup is
        # deferred until the lane drains (frame order == arrival order).
        self.gone = False


class GcsServer:
    def __init__(self, session_name: str, session_dir: str,
                 store_capacity: int = 0, persist: bool = True):
        self.session_name = session_name
        self.session_dir = session_dir
        self.store_capacity = store_capacity
        self.store = make_store(
            session_name, store_capacity,
            populate=store_capacity if store_capacity > 0 else (2 << 30))
        # Reader safety on delete is enforced natively via per-object pins
        # in the arena itself (native/shm_store.cc rtpt_store_acquire/
        # release) — plasma's client-pin rule without GCS-side bookkeeping.
        # Page population happens per-process in NativeStore.
        self._pull_tasks: Set[asyncio.Task] = set()
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.workers: Dict[WorkerID, WorkerInfo] = {}
        self.tasks: Dict[TaskID, TaskRecord] = {}
        self.pending = PendingQueues()
        # Actors awaiting an idle worker (insertion-ordered). Placement is
        # event-driven: worker hellos wake the scheduler, which drains this
        # map first — no per-actor poll timers, and worker-spawn requests
        # are batched by the aggregate waiting demand (reference:
        # prestart-by-demand, worker_pool.h:174).
        self._actor_pending_place: Dict[ActorID, ActorRecord] = {}
        # Hot directory tables, partitioned by id into independent shards
        # (gcs_shards.py): one lane per shard for a sharded/multi-loop
        # drain, per-shard fill served by ``gcs_stats``.
        nshards = max(1, _cfg().gcs_shards)
        self.objects: Dict[ObjectID, ObjectEntry] = ShardedDict(nshards)
        # Ref deltas that arrived before their object's directory entry
        # exists (a fire-and-forget driver can drop its result ref — and
        # flush the -1 — before the worker's obj_put lands). Deltas
        # commute, so they park here and apply at entry creation (_obj).
        # Capped: a delta for an object that never materializes must not
        # grow this forever.
        self._early_ref_deltas: Dict[ObjectID, int] = {}
        self.zero_ref_lru: "OrderedDict[ObjectID, int]" = OrderedDict()
        # Unreferenced store blocks, each with the time it is freed (_doom).
        self._doomed: Dict[ObjectID, float] = {}
        self._doom_timer: Optional[asyncio.TimerHandle] = None
        self.shm_bytes = 0
        self.actors: Dict[ActorID, ActorRecord] = ShardedDict(nshards)
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.pgs: Dict[PlacementGroupID, PGRecord] = ShardedDict(nshards)
        self.kv: Dict[Tuple[str, str], bytes] = {}
        self.clients: List[ClientConn] = []
        self.drivers: List[ClientConn] = []
        # Fair ingress: clients with parked frames, in round-robin order.
        self._ingress: "OrderedDict[ClientConn, None]" = OrderedDict()
        self._ingress_wakeup = asyncio.Event()
        self._ingress_task: Optional[asyncio.Task] = None
        self._fair_slice = max(1, _cfg().gcs_fair_slice)
        self._adm_high = max(1, _cfg().admission_inflight_high)
        self._adm_low = min(max(0, _cfg().admission_inflight_low),
                            self._adm_high - 1)
        # Per-tenant resource quotas ({namespace: {resource: cap}}) and
        # the usage charged against them (lease grants + PG reservations).
        import json as _json

        try:
            self._tenant_quotas: Dict[str, Dict[str, float]] = {
                ns: {k: float(v) for k, v in caps.items()}
                for ns, caps in _json.loads(
                    _cfg().tenant_quotas or "{}").items()}
        except (ValueError, AttributeError):
            logger.warning("malformed tenant_quotas JSON ignored: %r",
                           _cfg().tenant_quotas)
            self._tenant_quotas = {}
        self.tenant_usage: Dict[str, Dict[str, float]] = {}
        # SLO enforcement rung 1: tenants whose fair-ingress slice and
        # admission budget are scaled down (ns -> factor in (0, 1]).
        # Empty dict == every hot-path check is one falsy test.
        self._tenant_weights: Dict[str, float] = {}
        from .slo import SloController

        self.slo = SloController(self)
        # Gang fault plane: live gang records by name, the per-name
        # monotonic generation counters (durable — snapshot + WAL), and
        # the member-actor -> gang index the death/drain paths consult.
        # Live records are EPHEMERAL across a GCS restart (the owning
        # driver re-registers at the next formation); the counters are
        # not, so generations stay strictly monotonic through crashes.
        self.gangs: Dict[str, GangRecord] = {}
        self.gang_gens: Dict[str, int] = {}
        self._actor_gangs: Dict[ActorID, str] = {}
        # Generalized pubsub (reference: src/ray/pubsub/publisher.h) —
        # actor-state / node-event / error / job channels + user channels.
        from .pubsub import Publisher

        self.publisher = Publisher()
        self._spread_rr = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._shutdown_event = asyncio.Event()
        self._sched_wakeup = asyncio.Event()
        # Owner key -> registered oids. Keyed by the owner's STABLE
        # worker_id (falling back to connection identity for anonymous
        # clients) so a reconnecting owner keeps its registrations and its
        # eventual exit dereferences them.
        self._owned_objects: Dict[Any, Set[ObjectID]] = {}
        self._client_by_wid: Dict[bytes, ClientConn] = {}
        # Cooperative-broadcast accounting: served bytes per source (node
        # hex where resolvable, else raw serve addr) reported by pullers
        # at pull completion — the "who actually carried the broadcast"
        # signal (benchmarks assert the source served a minority).
        self.bcast_served: Dict[str, dict] = {}
        # PG-creation phase accounting (reserve = staging scan, commit =
        # resource debit, reply = wire write, wal = durable append):
        # cumulative seconds + counts, served by ``pg_stats`` — the
        # instrumentation that lets the scale bench attribute cross-run
        # create-rate variance to a phase instead of guessing.
        self.pg_phases: Dict[str, float] = {
            "n": 0, "reserve_s": 0.0, "commit_s": 0.0, "reply_s": 0.0,
            "wal_s": 0.0, "retries": 0, "deferred": 0}
        # PGs awaiting capacity, retried on every scheduler wake (the
        # poll timers remain only as a backstop): a deferred create used
        # to pay 50-100ms of timer quantization even when the blocking
        # resources freed microseconds later — the dominant term in
        # cross-run many_pgs create-rate variance.
        self._pending_pgs: Set[PlacementGroupID] = set()
        self._addr_nodes: Dict[str, tuple] = {}  # serve addr -> (hex, sfx)
        self._locate_rr = 0  # worker-endpoint rotation (obj_locate)
        # Observability stores (reference: GcsTaskManager task-event store
        # gcs_task_manager.h:86; metrics agent metrics_agent.py). Both bounded.

        self._done_tasks: deque = deque()  # TaskID, GC'd beyond max
        # Deferred task-note rows (lazy observability ingestion).
        self._obs_rows: deque = deque(maxlen=_cfg().max_done_tasks)
        # Structured export events (reference: util/event.h RayEvent):
        # bounded ring served by the state API + JSONL in the session dir.
        self.cluster_events: deque = deque(maxlen=10_000)
        self._event_file = None
        self.max_done_tasks = _cfg().max_done_tasks
        self.task_events: deque = deque(maxlen=_cfg().max_task_events)
        # Plane-event flight recorder table (util/events.py): bounded
        # rows pushed from every process's ring (+ this process's own
        # ring, ingested on the maintenance tick), per-plane drop
        # accounting ACCUMULATED from pushed drain deltas, and a
        # retention sweep (same tick as trace-KV retention below).
        self.plane_events: deque = deque(maxlen=_cfg().max_plane_events)
        self.plane_event_drops: Dict[str, int] = {}
        self.plane_events_evicted = 0
        # ns="trace" KV retention bookkeeping: trace_id -> last kv_put
        # time, trace_id -> its KV keys (maintained incrementally at
        # kv_put/kv_del so the sweep never scans the whole KV). Traces
        # restored from a WAL/snapshot are adopted by a ONE-TIME scan on
        # the first sweep and stamped "now" so they age out a full
        # window later.
        self._trace_touch: Dict[str, float] = {}
        self._trace_keys: Dict[str, Set[tuple]] = {}
        self._trace_adopted = False
        # (sender_key, name, tags_tuple) -> metric dict
        self.metrics: Dict[tuple, dict] = {}
        self.counters: Dict[str, float] = {
            "tasks_submitted": 0, "tasks_finished": 0, "tasks_failed": 0,
            "tasks_retried": 0, "actors_created": 0, "actors_restarted": 0,
            "actors_migrated": 0, "nodes_drained": 0, "objects_stored": 0,
            "backpressure_events": 0, "quota_rejections": 0,
        }
        # Durable state + crash recovery (reference: GCS tables through the
        # Redis store client, store_client_kv.cc, replayed by
        # gcs_init_data.cc). WAL + snapshot live in the session dir.
        self.restart_requested = False
        self.resumed = False
        # Instance identity: clients compare epochs across reconnects to
        # tell "the GCS restarted, resync everything" from "my own link
        # blipped against a live GCS, replay nothing".
        self.epoch = os.urandom(8).hex()
        self._driver_exit_graces: Dict[bytes, Any] = {}
        # Consecutive worker-spawn failures per runtime-env key (reset on
        # a successful spawn); >= 3 fails that env's consumers fast.
        self._env_failures: Dict[str, int] = {}
        self.log = None
        if persist:
            from .gcs_persistence import GcsLog

            self.log = GcsLog(session_dir,
                              compact_every=_cfg().gcs_wal_compact_every)
            self._replay_persisted()
        if self.resumed:
            # Adoption grace: actors not re-claimed by surviving workers
            # within the window get restarted (or declared dead).
            self._adoption_deadline = (
                time.time() + _cfg().actor_adoption_grace_s)
        else:
            self._adoption_deadline = 0.0

    # --------------------------------------------------------- persistence

    def _fp(self, site: str, key: Optional[str] = None):
        """GCS-side failpoint hit: translates the ``crash`` action into an
        in-place control-plane crash-restart (the supervisor rebuilds a
        fresh instance from WAL + arena, every connection drops — the same
        path as a real GCS death) and unwinds the current handler with a
        FailpointError so the dying instance sends NO reply."""
        act = failpoints.fire(site, key)
        if act == "crash":
            self._chaos_crash(site if key is None else f"{site}[{key}]")
            raise failpoints.FailpointError(
                f"GCS crashed at failpoint {site!r}")
        return act

    def _chaos_crash(self, why: str):
        """Crash the control plane in place (failpoint action ``crash``):
        same teardown as the ``gcs_restart`` chaos op, but triggerable
        mid-handler — e.g. between a state mutation and its WAL append —
        so recovery is exercised from genuinely torn intermediate states."""
        if self.restart_requested:
            return
        logger.warning("GCS crash injected at %s (%s)", why,
                       failpoints.format_schedule())
        self.restart_requested = True

        async def _teardown():
            await self.stop_serving()
            self._shutdown_event.set()

        asyncio.get_running_loop().create_task(_teardown())

    def _log_append(self, op: str, payload):
        if failpoints.active():
            # Crash BEFORE the WAL append: the mutation this op records is
            # lost with the instance — recovery must reconverge from
            # resyncs alone (the torn-write case a buffered real crash
            # leaves behind).
            self._fp("gcs.wal.before", op)
        if self.log is not None:
            try:
                self.log.append(op, payload)
                self.log.maybe_compact(self._make_snapshot)
            except OSError:
                logger.exception("GCS WAL append failed; disabling WAL")
                self.log = None
        if failpoints.active():
            # Crash AFTER the append: the record is durable but the reply
            # /side effects never happened — replay must be idempotent.
            self._fp("gcs.wal.after", op)

    def _make_snapshot(self) -> dict:
        actors = []
        for r in self.actors.values():
            if r.state == A_DEAD:
                continue
            m = {k: v for k, v in r.msg.items() if k != "i"}
            if r.owner_wid is not None:
                m["owner_wid"] = r.owner_wid
            actors.append(m)
        return {
            "kv": [[ns, k, v] for (ns, k), v in self.kv.items()],
            "actors": actors,
            "pgs": [{"pgid": p.pg_id.binary(), "bundles": p.bundles,
                     "strategy": p.strategy, "name": p.name,
                     "tenant": p.tenant}
                    for p in self.pgs.values()],
            "inline": [[e.object_id.binary(), e.inline]
                       for e in self.objects.values()
                       if e.ready and e.inline is not None],
            "gang_gens": [[name, gen]
                          for name, gen in self.gang_gens.items()],
        }

    def _replay_persisted(self):
        """Rebuild durable tables from snapshot+WAL and the surviving shm
        arena. Ephemeral state (nodes, workers, leases, refcounts) comes
        back from reconnecting peers (resync hellos)."""
        snapshot, wal = self.log.load()
        had_any = snapshot is not None
        if snapshot:
            for ns, k, v in snapshot.get("kv", []):
                self.kv[(ns, k)] = v
            for msg in snapshot.get("actors", []):
                self._restore_actor(msg)
            for p in snapshot.get("pgs", []):
                self._restore_pg(p)
            for oid_b, data in snapshot.get("inline", []):
                entry = self._obj(ObjectID(bytes(oid_b)))
                if not entry.ready:
                    entry.nbytes = len(data)
                    entry.inline = data
                    entry.ready = True
            for name, gen in snapshot.get("gang_gens", []):
                self.gang_gens[name] = max(self.gang_gens.get(name, 0),
                                           int(gen))
        for op, payload in wal:
            had_any = True
            if op == "kv":
                self.kv[(payload[0], payload[1])] = payload[2]
            elif op == "kvd":
                self.kv.pop((payload[0], payload[1]), None)
            elif op == "actor":
                self._restore_actor(payload)
            elif op == "actord":
                aid = ActorID(bytes(payload))
                rec = self.actors.pop(aid, None)
                if rec is not None and rec.name is not None:
                    self.named_actors.pop((rec.namespace, rec.name), None)
            elif op == "pg":
                self._restore_pg(payload)
            elif op == "pgd":
                self.pgs.pop(PlacementGroupID(bytes(payload)), None)
            elif op == "obj":
                entry = self._obj(ObjectID(bytes(payload[0])))
                if not entry.ready:
                    entry.nbytes = len(payload[1])
                    entry.inline = payload[1]
                    entry.ready = True
            elif op == "objd":
                self.objects.pop(ObjectID(bytes(payload)), None)
            elif op == "gang":
                # Generation counters only: live membership is rebuilt by
                # the owning driver's next registration, but monotonicity
                # must survive the crash (stale-generation rejection is
                # meaningless if a restart hands out generation 1 twice).
                self.gang_gens[payload[0]] = max(
                    self.gang_gens.get(payload[0], 0), int(payload[1]))
        if not had_any:
            return
        self.resumed = True
        # The shm arena outlives the GCS process: rescan its index to
        # rebuild the directory of host-store objects.
        self._restored_oids: List[ObjectID] = []
        if hasattr(self.store, "list_objects"):
            try:
                for oid, nbytes in self.store.list_objects():
                    entry = self._obj(oid)
                    if not entry.ready:
                        entry.nbytes = nbytes
                        entry.on_shm = True
                        entry.ready = True
                        self.shm_bytes += nbytes
                        self._restored_oids.append(oid)
            except Exception:
                logger.exception("arena rescan failed")
        logger.info(
            "GCS resumed from WAL: %d kv, %d actors, %d pgs, %d objects",
            len(self.kv), len(self.actors), len(self.pgs), len(self.objects))

    def _restore_actor(self, msg: dict):
        aid = ActorID(bytes(msg["aid"]))
        record = ActorRecord(aid, msg, None)
        record.restored = True
        if msg.get("owner_wid") is not None:
            record.owner_wid = bytes(msg["owner_wid"])
        self.actors[aid] = record
        if record.name is not None:
            self.named_actors[(record.namespace, record.name)] = aid
        # state stays A_PENDING until a surviving worker re-claims it
        # (resync hello) or the adoption grace expires and it restarts.

    def _restore_pg(self, p: dict):
        pgid = PlacementGroupID(bytes(p["pgid"]))
        record = PGRecord(pgid, p["bundles"], p["strategy"],
                          p.get("name", ""), None)
        # Restored owner conns are gone, but the tenant survives in the
        # record: re-placement must charge the owning namespace's quota,
        # not 'default' (a restart would otherwise double the tenant's
        # effective cap).
        record.tenant = p.get("tenant", "default")
        self.pgs[pgid] = record
        # state "pending": rescheduled once agents re-register.

    # ------------------------------------------------------------------ serve

    async def start(self, address: str, *extra_addresses: str):
        self._server = await protocol.serve(address, self._on_client)
        self._extra_servers = [await protocol.serve(a, self._on_client)
                               for a in extra_addresses]
        # Loop-lag instrumentation (reference: event_stats.h) — surfaces
        # "something blocked the control-plane loop" in loop_stats.
        from .thread_check import LoopMonitor

        self.loop_monitor = LoopMonitor(name="gcs").start()
        asyncio.get_running_loop().create_task(self._scheduler_loop())
        asyncio.get_running_loop().create_task(self._health_check_loop())
        asyncio.get_running_loop().create_task(self._slo_loop())
        self._ingress_task = asyncio.get_running_loop().create_task(
            self._ingress_drain())
        # WAL-restored placement groups re-place once agents re-register:
        # without this kick nothing ever schedules them and every
        # PG-targeted task/actor would pend forever after a GCS restart.
        # A resumed GCS places them when the adoption window closes, once
        # their surviving holders have reported the cards they use.
        for record in self.pgs.values():
            if record.state == "pending" and not self.resumed:
                asyncio.get_running_loop().call_later(
                    0.2, self._retry_pg, record)
        if self.resumed:
            asyncio.get_running_loop().call_later(
                max(0.0, self._adoption_deadline - time.time()),
                self._finish_adoption)
        logger.info("GCS listening on %s", [address, *extra_addresses])

    def _finish_adoption(self):
        """End of the post-restart grace window: restored actors nobody
        re-claimed lost their worker during the outage — apply the normal
        death/restart policy; orphans whose owner never reconnected die."""
        # Arena-restored objects still at refcount 0 have no surviving
        # referrer: enter them into the zero-ref LRU so they can be
        # evicted — otherwise orphaned bytes would pin the store forever.
        for oid in getattr(self, "_restored_oids", []):
            entry = self.objects.get(oid)
            if entry is not None and entry.ready and entry.refcount <= 0:
                self._lru_touch(entry)
        self._restored_oids = []
        for pg in list(self.pgs.values()):
            if pg.state == "pending":
                self._retry_pg(pg)
        for record in list(self.actors.values()):
            if not record.restored or record.state != A_PENDING:
                continue
            record.restored = False
            if record.owner is None and not record.detached:
                record.state = A_DEAD
                record.death_cause = "owner driver lost during GCS outage"
                self._cleanup_dead_actor(record)
            elif (record.restarts_used < record.max_restarts
                    or record.max_restarts < 0):
                record.restarts_used += 1
                self.counters["actors_restarted"] += 1
                record.state = A_RESTARTING
                logger.info("restarting actor %s lost during GCS outage",
                            record.actor_id.hex()[:8])
                self._try_place_actor(record)
            else:
                record.state = A_DEAD
                record.death_cause = "actor worker lost during GCS outage"
                self._cleanup_dead_actor(record)

    async def wait_shutdown(self):
        await self._shutdown_event.wait()

    async def _on_client(self, reader, writer):
        client = ClientConn(None)  # placeholder until hello
        conn = protocol.Connection(
            reader, writer,
            handler=lambda msg: self._ingest(client, msg),
            on_close=lambda: self._on_disconnect(client),
        )
        client.conn = conn
        # Mid-chunk yields: one connection's decoded burst hands the loop
        # back every fair_slice frames, so the fair drain interleaves and
        # lanes stay SHORT (a 1MB chunk would otherwise park ~10k frame
        # dicts before the drain task ever ran — measured as GC churn
        # worth ~40% of the frame ceiling).
        conn.yield_every = self._fair_slice
        self.clients.append(client)
        conn.start()

    # ------------------------------------------- fair ingress / admission

    def _ingest(self, client: ClientConn, msg: dict):
        """Park one frame on the sender's lane and wake the fair drain.

        Runs inside the sender's read loop — a PLAIN function on the hot
        path (no coroutine setup per frame); it returns an awaitable only
        when admission must block. Admission control: a DRIVER whose lane
        exceeds its in-flight budget gets one advisory ``backpressure``
        frame and its read loop then BLOCKS — which stops reads on that
        socket only, so the kernel's flow control pushes back on the
        flooding tenant while every other connection keeps draining
        (reference analog: per-call gRPC flow control the shared asyncio
        reader otherwise lacks)."""
        if not self._ingress and not client.inq and not client.bp_on \
                and (not self._tenant_weights or client.role != "driver"
                     or (client.namespace or "default")
                     not in self._tenant_weights):
            # Uncontended fast path: no lane anywhere holds frames, so
            # dispatching inline IS the round-robin order — and the read
            # loop's mid-chunk yields (yield_every) keep concurrent
            # floods time-sliced at fair_slice granularity regardless.
            # The parked lane engages under contention (a lane already
            # draining, a handler blocking the loop, admission in force).
            # A rung-1 de-weighted tenant NEVER gets the inline path: a
            # flood the drain fully absorbs leaves every lane empty, so
            # without this exclusion the weighted slice + scaled budget
            # would simply never engage (the cost is one dict hit, and
            # only while an enforcement weight is live).
            return self._dispatch(client, msg)
        client.inq.append(msg)
        if client not in self._ingress:
            self._ingress[client] = None
            self._ingress_wakeup.set()
        if len(client.inq) >= self._adm_high:
            # Drivers block at the budget; workers get 4x headroom (their
            # bursts are the data plane's own registrations) but are NOT
            # unbounded — without a cap, sustained overload grows the
            # lane (decoded frame dicts) until OOM, where pre-fairness
            # inline dispatch stalled the socket instead. GCS-initiated
            # requests to a blocked worker (obj_upload, memdump) carry
            # timeouts, so the read-block cannot deadlock. Agents stay
            # exempt: stalling health_check replies under overload would
            # false-positive node death.
            if client.role == "driver":
                return self._admission_block(client)
            if client.role == "worker" \
                    and len(client.inq) >= self._adm_high * 4:
                return self._admission_block(client)
        elif self._tenant_weights and client.role == "driver" \
                and len(client.inq) >= self._tenant_adm_high(client):
            # SLO rung 1: a de-weighted tenant's budget shrinks with its
            # weight, so backpressure engages before the full budget.
            return self._admission_block(client)
        return None

    async def _admission_block(self, client: ClientConn):
        if not client.bp_on:
            client.bp_on = True
            self.counters["backpressure_events"] += 1
            plane_events.emit("gcs.admission.block", plane="gcs",
                              tenant=client.namespace or "",
                              role=client.role or "",
                              queued=len(client.inq))
            try:
                client.conn.send({"t": "backpressure", "on": 1,
                                  "queued": len(client.inq)})
            except ConnectionError:
                pass
        if client.bp_event is None:
            client.bp_event = asyncio.Event()
        client.bp_event.clear()
        await client.bp_event.wait()
        hold = self._tenant_hold_s(client)
        if hold > 0.0:
            # Rung-1 pacing: the block/unblock round trip alone only
            # halves an absorbed flood (measured 152k -> 80k frames/s —
            # draining 41 parked frames costs microseconds), so a
            # de-weighted lane's read loop stays closed for a beat after
            # each unblock. Sleeps THIS socket's read loop only; kernel
            # flow control pushes back on the offender while every other
            # connection keeps draining.
            await asyncio.sleep(hold)

    async def _ingress_drain(self):
        """Round-robin frame drain: every lane with parked frames gets at
        most ``fair_slice`` frames per cycle, and the loop yields between
        cycles so read loops interleave — a connection that floods first
        no longer owns the control plane until its burst is done."""
        while True:
            await self._ingress_wakeup.wait()
            self._ingress_wakeup.clear()
            while self._ingress:
                for client in list(self._ingress):
                    q = client.inq
                    for _ in range(min(len(q), self._tenant_slice(client))):
                        await self._dispatch(client, q.popleft())
                    if not q:
                        self._ingress.pop(client, None)
                        if client.gone:
                            client.gone = False
                            self._disconnect_cleanup(client)
                    if client.bp_on and len(q) <= self._tenant_adm_low(
                            client):
                        client.bp_on = False
                        plane_events.emit("gcs.admission.unblock",
                                          plane="gcs",
                                          tenant=client.namespace or "",
                                          queued=len(q))
                        if client.bp_event is not None:
                            client.bp_event.set()
                        if not client.conn.closed:
                            try:
                                client.conn.send({"t": "backpressure",
                                                  "on": 0})
                            except ConnectionError:
                                pass
                # Yield to the socket read loops between fair cycles so
                # fresh frames from OTHER clients can join the round.
                await asyncio.sleep(0)

    async def _dispatch(self, client: ClientConn, msg: dict):
        t = msg.get("t")
        if plane_events._enabled and t is not None:
            # Per-frame plane: aggregate counter, never per-event rows
            # (this path runs at the 160k frames/s ceiling).
            plane_events.count("proto.dispatch.gcs", key=t)
        if t is None:
            # Empty/typeless frame (the undecodable-frame placeholder from
            # protocol's decode guard, or a buggy peer): skip explicitly
            # instead of falling through handler lookup with t=None.
            if msg:
                logger.warning("dropping typeless message %r",
                               sorted(msg)[:8])
            return
        if failpoints.active():
            # Frame-dispatch boundary: drop (frame lost inside the GCS),
            # delay (stalled loop), or crash (die between receiving a
            # frame and acting on it).
            try:
                if self._fp("gcs.dispatch", t) == "drop":
                    return
            except failpoints.FailpointError:
                return
        handler = getattr(self, f"_h_{t}", None)
        if handler is None:
            logger.warning("unknown message type %r", t)
            return
        if t in _SPAWNED_HANDLERS:
            # Handlers that await a WORKER round trip run as their own
            # task so a wedged peer never stalls the shared fair-drain
            # loop. Same coroutine (one error contract) either way.
            asyncio.get_running_loop().create_task(
                self._run_handler(handler, client, msg))
            return
        await self._run_handler(handler, client, msg)

    async def _run_handler(self, handler, client: ClientConn, msg: dict):
        try:
            await handler(client, msg)
        except failpoints.FailpointError:
            # Injected crash mid-handler: the dying instance must NOT
            # answer — a clean error reply here would make the client
            # believe the request failed on a LIVE control plane instead
            # of retrying against the recovered one.
            logger.warning("handler %r aborted by failpoint", msg.get("t"))
        except Exception:
            logger.exception("error handling %r", msg.get("t"))
            if msg.get("i") is not None and not client.conn.closed:
                client.conn.reply(msg, {"ok": False, "err": "internal error"})

    # ------------------------------------------------------- registration

    async def _h_hello(self, client: ClientConn, msg: dict):
        role = msg["role"]
        client.role = role
        client.namespace = msg.get("namespace") or "default"
        if role == "agent":
            node_id = NodeID(msg["node_id"])
            client.node_id = node_id
            node = NodeInfo(
                node_id, msg["resources"], msg.get("hostname", ""), client.conn)
            node.obj_addr = msg.get("obj_addr")
            node.store_suffix = msg.get("store_suffix", "")
            self.nodes[node_id] = node
            # Adopt surviving workers that resynced before their agent
            # (GCS restart: reconnect order is arbitrary).
            for w in self.workers.values():
                if w.node_id == node_id and not w.conn.closed:
                    node.workers.add(w.worker_id)
                    if w.state == W_IDLE:
                        node.idle_workers.append(w.worker_id)
                    elif w.state == W_ACTOR and not w.acquired:
                        # Actor claimed before its node registered: charge
                        # the actor's resources now.
                        rec = (self.actors.get(w.actor_id)
                               if w.actor_id else None)
                        if rec is not None:
                            w.acquired = self._acquire(node, rec)
                            self._hold_reported_gpus(node, w, rec)
                    elif w.acquired:
                        _res_sub(node.avail, w.acquired)
            logger.info("node %s joined: %s", node_id.hex()[:8], msg["resources"])
            self._pub("node_events", {"event": "node_joined",
                                      "node_id": node_id.hex(),
                                      "resources": msg["resources"],
                                      "hostname": msg.get("hostname", "")})
            self._wake_scheduler()
        elif role == "worker":
            worker_id = WorkerID(msg["worker_id"])
            node_id = NodeID(msg["node_id"])
            client.worker_id = worker_id
            client.node_id = node_id
            info = WorkerInfo(worker_id, node_id, client.conn,
                              msg.get("addr", ""), msg.get("pid", 0))
            info.obj_addr = msg.get("obj_addr") or ""
            info.env_key = msg.get("env_key", "")
            info.gpu_reported = [str(i) for i in msg.get("gpus") or ()]
            info.gpu_pinned = bool(info.gpu_reported)
            if info.env_key:
                self._env_failures.pop(info.env_key, None)  # env builds now
            self.workers[worker_id] = info
            node = self.nodes.get(node_id)
            if node is not None:
                node.workers.add(worker_id)
                node.spawning = max(0, node.spawning - 1)
                node.spawn_ts = time.time()  # progress: refresh the decay
            claimed = False
            stale_actor = False
            aid_b = msg.get("actor_id")
            if aid_b is not None:
                # Resync: a surviving actor worker re-claims its actor
                # after a GCS restart (reference: raylet/worker resync,
                # gcs_init_data.cc + test_gcs_fault_tolerance.py). A claim
                # is only valid when the record is unbound (restored) or
                # already bound to THIS worker — otherwise a transiently
                # disconnected worker would steal back an actor the live
                # GCS already restarted elsewhere, leaving two instances.
                record = self.actors.get(ActorID(bytes(aid_b)))
                if record is not None and record.worker_id not in (
                        None, worker_id):
                    stale_actor = True
                    record = None
                if record is not None and record.state in (A_PENDING,
                                                           A_RESTARTING,
                                                           A_ALIVE):
                    info.state = W_ACTOR
                    info.actor_id = record.actor_id
                    record.worker_id = worker_id
                    record.node_id = node_id
                    record.addr = info.addr
                    record.state = A_ALIVE
                    if node is not None:
                        info.acquired = self._acquire(node, record)
                        self._hold_reported_gpus(node, info, record)
                    for conn, req in record.addr_waiters:
                        if not conn.closed:
                            conn.reply(req, {"ok": True, "state": A_ALIVE,
                                             "addr": record.addr})
                    record.addr_waiters.clear()
                    record.restored = False
                    claimed = True
            if stale_actor:
                # Its actor lives elsewhere now: this worker's instance is
                # an orphan — retire the process rather than let the
                # scheduler treat it as an idle plain worker.
                client.conn.send({"t": "exit"})
            elif not claimed and node is not None:
                node.idle_workers.append(worker_id)
            self._wake_scheduler()
        elif role == "driver":
            worker_id = WorkerID(msg["worker_id"])
            client.worker_id = worker_id
            self.drivers.append(client)
            wid_b = worker_id.binary()
            # A reconnect within the exit grace window cancels the pending
            # driver-death cleanup (the link blipped; the driver is alive).
            grace = self._driver_exit_graces.pop(wid_b, None)
            if grace is not None:
                grace.cancel()
            # Re-link actors to their reconnecting owner so owner-exit
            # cleanup keeps working after a GCS restart or link blip.
            for record in self.actors.values():
                prev = record.owner
                if record.owner_wid == wid_b or (
                        prev is not None and prev.worker_id == worker_id):
                    record.owner = client
            # Re-link leases the same way: lease return / driver-exit
            # cleanup compare ClientConn identity, so leases bound to the
            # pre-blip connection would otherwise leak their workers (and
            # node resources) forever.
            for w in self.workers.values():
                lt = w.leased_to
                if lt is not None and lt.worker_id == worker_id \
                        and lt is not client:
                    w.leased_to = client
        if client.worker_id is not None:
            self._client_by_wid[client.worker_id.binary()] = client
        client.conn.reply(msg, {
            "ok": True,
            "session": self.session_name,
            "session_dir": self.session_dir,
            "epoch": self.epoch,
        })

    async def _h_update_resources(self, client: ClientConn, msg: dict):
        """Node agent reports discovered resources (e.g. TPU probe finished)."""
        node = self.nodes.get(NodeID(msg["node_id"]))
        if node is None:
            return
        for k, v in msg["resources"].items():
            old_total = node.total.get(k, 0.0)
            node.total[k] = v
            node.avail[k] = node.avail.get(k, 0.0) + (v - old_total)
        node.sync_gpu_ids()
        self._wake_scheduler()

    def _on_disconnect(self, client: ClientConn):
        if client.bp_event is not None:
            # Unblock a read loop parked on admission so it can observe
            # the close and exit.
            client.bp_event.set()
        if client.inq and not self.restart_requested:
            # Frames that arrived before the close are still parked on
            # the lane: run them first (arrival order), cleanup after.
            client.gone = True
            return
        self._disconnect_cleanup(client)

    def _disconnect_cleanup(self, client: ClientConn):
        if self.restart_requested:
            # Teardown of the old instance during a control-plane restart:
            # peers are alive and will resync with the new instance — no
            # death handling.
            return
        if client in self.clients:
            self.clients.remove(client)
        self.publisher.drop_conn(client.conn)
        if client.pull_regs:
            # A dead puller must not linger as a partial broadcast holder.
            self._drop_pull_regs(client)
        if (client.worker_id is not None
                and self._client_by_wid.get(client.worker_id.binary())
                is client):
            del self._client_by_wid[client.worker_id.binary()]
        if client.role == "worker" and client.worker_id is not None:
            # A half-open socket can die AFTER the worker already
            # reconnected and re-registered: the stale conn's disconnect
            # must not kill the fresh registration (split-brain actor
            # restarts otherwise) nor purge its live state — so this guard
            # runs before ANY cleanup below.
            w = self.workers.get(client.worker_id)
            if w is not None and w.conn is not client.conn:
                return
        sender = (client.worker_id.hex() if client.worker_id
                  else str(id(client)))
        for key in [k for k in self.metrics if k[0] == sender]:
            del self.metrics[key]
        if client.role == "worker" and client.worker_id is not None:
            # Objects owned by this worker (from its nested submissions).
            for oid in self._owned_objects.pop(self._owner_key(client),
                                               set()):
                entry = self.objects.get(oid)
                if entry is not None:
                    entry.refcount -= 1
                    if entry.refcount <= 0 and entry.ready:
                        self._lru_touch(entry)
            asyncio.get_running_loop().create_task(
                self._on_worker_death(client.worker_id))
        elif client.role == "driver":
            if client in self.drivers:
                self.drivers.remove(client)
            # Grace before death handling: a driver whose TCP link blipped
            # reconnects within seconds; killing its actors and releasing
            # its leases immediately would be wrong (the resync path,
            # unlike a GCS restart, replays nothing into a live GCS).
            wid_b = (client.worker_id.binary()
                     if client.worker_id is not None else None)
            if wid_b is not None:
                old = self._driver_exit_graces.pop(wid_b, None)
                if old is not None:
                    old.cancel()
                from .config import config as _cfg2

                self._driver_exit_graces[wid_b] = \
                    asyncio.get_running_loop().call_later(
                        _cfg2().driver_exit_grace_s,
                        self._driver_exit_after_grace, wid_b, client)
            else:
                self._on_driver_exit(client)
        elif client.role == "agent" and client.node_id is not None:
            # Stale-socket guard (same as the worker path): a half-open
            # old agent link closing AFTER the agent re-registered must
            # not kill the live node.
            node = self.nodes.get(client.node_id)
            if node is None or node.agent_conn is client.conn:
                self._on_node_death(client.node_id)

    # ------------------------------------------------------- tenant quotas

    def _client_tenant(self, client: ClientConn) -> str:
        """Resolve the tenant a connection acts FOR. Drivers carry their
        namespace in the hello; a WORKER connection acts for whichever
        tenant's work it is running — the driver holding its lease, or
        its actor's namespace — so nested task submission cannot launder
        a quota'd tenant's demand through the 'default' namespace."""
        if client.role == "worker" and client.worker_id is not None:
            w = self.workers.get(client.worker_id)
            if w is not None:
                if w.leased_to is not None:
                    return getattr(w.leased_to, "namespace", None) \
                        or "default"
                if w.actor_id is not None:
                    rec = self.actors.get(w.actor_id)
                    if rec is not None:
                        return rec.namespace
        return client.namespace or "default"

    def _quota_never_fits(self, ns: str, res: Dict[str, float]) -> bool:
        """True when ``res`` alone exceeds the namespace's cap on some
        resource — the request can never be admitted and must fail
        cleanly instead of pending forever."""
        caps = self._tenant_quotas.get(ns)
        if not caps:
            return False
        return any(res.get(k, 0.0) > caps[k] + 1e-9 for k in caps)

    def _quota_fits_now(self, ns: str, res: Dict[str, float]) -> bool:
        caps = self._tenant_quotas.get(ns)
        if not caps:
            return True
        used = self.tenant_usage.get(ns) or {}
        return all(used.get(k, 0.0) + res.get(k, 0.0) <= caps[k] + 1e-9
                   for k in caps)

    def _tenant_acquire(self, ns: str, res: Dict[str, float]):
        if not self._tenant_quotas:
            return
        used = self.tenant_usage.setdefault(ns, {})
        for k, v in res.items():
            used[k] = used.get(k, 0.0) + v

    def _tenant_release(self, ns: str, res: Dict[str, float]):
        if not self._tenant_quotas:
            return
        used = self.tenant_usage.get(ns)
        if used is None:
            return
        for k, v in res.items():
            used[k] = used.get(k, 0.0) - v

    @staticmethod
    def _merge_res(bundles: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------------------- KV store

    # ------------------------------------------------------------ pubsub

    def _pub(self, channel: str, message: dict):
        """Publish a GCS-internal event (best-effort, never raises).

        Every internal publish is also a structured export event
        (reference: ``src/ray/util/event.h:246`` EventManager/RayEvent —
        JSONL files external collectors tail, plus an in-memory ring the
        state API serves)."""
        try:
            self.publisher.publish(channel, message)
        except Exception:
            logger.exception("publish on %r failed", channel)
        evt = {"ts": time.time(), "channel": channel, **message}
        self.cluster_events.append(evt)
        self._export_event(evt)

    # 64 MiB cap, one rotation (events.jsonl -> events.jsonl.1): bounded
    # like every other observability store here; the reference rotates its
    # export event files the same way.
    _EVENT_FILE_MAX = 64 << 20

    def _export_event(self, evt: dict):
        if self._event_file is False:
            return  # disabled after an unrecoverable write error
        try:
            import json as _json
            import os as _os

            path = _os.path.join(self.session_dir, "events.jsonl")
            if self._event_file is None:
                self._event_file = open(path, "a", buffering=1)
            self._event_file.write(_json.dumps(evt, default=str) + "\n")
            if self._event_file.tell() > self._EVENT_FILE_MAX:
                self._event_file.close()
                self._event_file = None
                _os.replace(path, path + ".1")
        except OSError:
            # Close (don't leak the fd) and disable: an observability
            # side-channel must never exhaust fds / take down the GCS.
            try:
                if self._event_file:
                    self._event_file.close()
            except OSError:
                pass
            self._event_file = False
            logger.warning("event export disabled (events.jsonl write "
                           "failed)")

    def _pub_actor(self, record, event: str):
        self._pub("actor_state", {
            "event": event, "actor_id": record.actor_id.hex(),
            "state": record.state, "name": record.name,
            "node_id": record.node_id.hex() if record.node_id else None,
            "death_cause": getattr(record, "death_cause", None),
        })

    async def _h_sub(self, client, msg):
        """Open a subscription stream (no reply frame: the stream stays
        open; published messages arrive as chunk frames)."""
        self.publisher.subscribe(msg["ch"], client.conn, msg["i"])

    async def _h_unsub(self, client, msg):
        n = self.publisher.unsubscribe(msg["ch"], client.conn,
                                       msg.get("sid"))
        client.conn.reply(msg, {"ok": True, "closed": n})

    async def _h_pub(self, client, msg):
        n = self._publish_user(msg["ch"], msg.get("m"))
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True, "delivered": n})

    def _publish_user(self, channel: str, message) -> int:
        return self.publisher.publish(channel, message)

    async def _h_kv_put(self, client, msg):
        ns = msg.get("ns", "")
        self.kv[(ns, msg["k"])] = msg["v"]
        if ns == "trace":
            # Retention clock + key index for the trace sweep: a trace
            # stays live as long as spans keep arriving for it.
            tid = msg["k"].split(":", 1)[0]
            self._trace_touch[tid] = time.time()
            self._trace_keys.setdefault(tid, set()).add((ns, msg["k"]))
        self._log_append("kv", [ns, msg["k"], msg["v"]])
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})

    async def _h_worker_memdump(self, client, msg):
        """Relay a memory-introspection request to a worker by pid
        (reference: on-demand memray/py-spy through the dashboard's
        reporter — here the worker self-reports, no ptrace needed)."""
        pid = msg.get("pid")
        target = None
        for w in self.workers.values():
            if w.pid == pid and not w.conn.closed:
                target = w
                break
        if target is None:
            client.conn.reply(msg, {"ok": False,
                                    "err": f"no live worker with pid {pid}"})
            return
        try:
            reply = await target.conn.request({"t": "memdump"}, timeout=30)
        except (ConnectionError, asyncio.TimeoutError) as e:
            client.conn.reply(msg, {"ok": False, "err": str(e)})
            return
        reply.pop("i", None)
        reply.pop("r", None)
        client.conn.reply(msg, reply)

    async def _h_kv_get(self, client, msg):
        v = self.kv.get((msg.get("ns", ""), msg["k"]))
        client.conn.reply(msg, {"ok": v is not None, "v": v})

    async def _h_kv_del(self, client, msg):
        ns = msg.get("ns", "")
        self.kv.pop((ns, msg["k"]), None)
        if ns == "trace":
            tid = msg["k"].split(":", 1)[0]
            keys = self._trace_keys.get(tid)
            if keys is not None:
                keys.discard((ns, msg["k"]))
        self._log_append("kvd", [ns, msg["k"]])
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})

    async def _h_kv_keys(self, client, msg):
        ns = msg.get("ns", "")
        prefix = msg.get("prefix", "")
        keys = [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]
        client.conn.reply(msg, {"ok": True, "keys": keys})

    # ------------------------------------------------------------- objects

    @staticmethod
    def _owner_key(client: "ClientConn"):
        if client.worker_id is not None:
            return client.worker_id.binary()
        return id(client)

    def _obj(self, object_id: ObjectID) -> ObjectEntry:
        entry = self.objects.get(object_id)
        if entry is None:
            entry = ObjectEntry(object_id)
            early = self._early_ref_deltas.pop(object_id, 0)
            if early:
                entry.refcount += early
            self.objects[object_id] = entry
        return entry

    def _mark_ready(self, entry: ObjectEntry, nbytes: int,
                    inline: Optional[bytes], on_shm: bool):
        if entry.ready:
            # Idempotence: lineage reconstruction re-marks every return of
            # a resubmitted task, and the worker-death error path can race
            # an already-registered result. Re-counting would inflate
            # shm_bytes (triggering spurious eviction); overwriting a live
            # shm entry with inline error bytes would strand its arena
            # accounting. Keep the first registration.
            self._notify_obj_waiters(entry)
            return
        entry.nbytes = nbytes
        entry.inline = inline
        entry.on_shm = on_shm
        entry.ready = True
        self.counters["objects_stored"] += 1
        if on_shm:
            self.shm_bytes += nbytes
        self._notify_obj_waiters(entry)
        if entry.refcount <= 0:
            self._lru_touch(entry)
        self._maybe_evict()

    def _obj_reply(self, entry: ObjectEntry) -> dict:
        if entry.inline is not None:
            return {"ok": True, "where": "inline", "data": entry.inline,
                    "nbytes": entry.nbytes}
        return {"ok": True, "where": "shm", "nbytes": entry.nbytes}

    def _notify_obj_waiters(self, entry: ObjectEntry):
        """Resolve everything waiting on ``entry`` becoming ready: legacy
        per-ref waiters get their own reply frame; wait groups get a
        resolution row routed through the group (threshold reply or a
        coalesced ``obj_res`` push)."""
        if not entry.waiters:
            return
        waiters, entry.waiters = entry.waiters, []
        row = None
        for w in waiters:
            if isinstance(w, WaitGroup):
                if row is None:
                    if entry.inline is not None:
                        row = [entry.object_id.binary(), 1, entry.inline]
                    else:
                        row = [entry.object_id.binary(), 2, entry.nbytes]
                self._group_deliver(w, row)
            else:
                conn, req = w
                if not conn.closed:
                    conn.reply(req, self._obj_reply(entry))

    def _fail_obj_waiters(self, entry: ObjectEntry, err: str):
        """Terminal failure for everything waiting on ``entry``: one lost
        oid must not poison its wait groups — the group keeps running and
        this oid alone resolves to an error row."""
        if not entry.waiters:
            return
        waiters, entry.waiters = entry.waiters, []
        row = [entry.object_id.binary(), 0, err]
        for w in waiters:
            if isinstance(w, WaitGroup):
                self._group_deliver(w, row)
            else:
                conn, req = w
                if not conn.closed:
                    conn.reply(req, {"ok": False, "err": err})

    def _group_deliver(self, group: WaitGroup, row: list):
        """Route one resolution row: gather until the group's threshold
        fires its single reply; stream the rest as coalesced pushes."""
        client = group.client
        if client.conn.closed:
            return
        if not group.replied:
            group.rows.append(row)
            if len(group.rows) >= group.need:
                group.replied = True
                rows, group.rows = group.rows, None
                if group.need > 1:
                    plane_events.emit("wait.group.threshold", plane="wait",
                                      rows=len(rows), nr=group.need)
                client.conn.reply(group.msg, {"ok": True, "rows": rows})
        else:
            buf = client.res_rows
            buf.append(row)
            plane_events.count("wait.rows.stream", plane="wait")
            if len(buf) >= _cfg().obj_res_flush_rows:
                self._flush_res_rows(client)
            elif len(buf) == 1:
                # One scheduled flush per burst: rows accumulating in the
                # same loop drain (a batch of obj_puts resolving a whole
                # group) ride one obj_res frame.
                asyncio.get_running_loop().call_soon(
                    self._flush_res_rows, client)

    def _flush_res_rows(self, client: ClientConn):
        rows, client.res_rows = client.res_rows, []
        if rows and not client.conn.closed:
            try:
                client.conn.send({"t": "obj_res", "rows": rows})
            except ConnectionError:
                pass

    def _obj_put_one(self, client, o: dict):
        """Register one object (shared by obj_put and the coalesced
        obj_puts batch)."""
        oid = ObjectID(o["oid"])
        entry = self._obj(oid)
        if entry.ready:  # duplicate registration
            if client.node_id is not None and o.get("shm") \
                    and not o.get("nh"):  # raylint: disable=RTL123 (obj_puts row field)
                entry.holders.add(client.node_id.binary())
            return
        # ``owner_wid``: a leased worker registering a task result on
        # behalf of the task's owner (the submitting driver/worker) —
        # ownership and the initial reference belong to that owner.
        owner = client
        owner_wid = o.get("owner_wid")  # raylint: disable=RTL123 (obj_puts row field)
        if owner_wid is not None:
            owner = self._client_by_wid.get(bytes(owner_wid), client)
        if entry.owner is None:
            # First sight of this object (put()/actor results): pin the
            # owner's initial reference. Task returns submitted through
            # _h_submit were already pinned there — pinning again here
            # double-counted and stranded the result forever. Resync
            # re-registrations ("rs": a reconnecting owner replaying
            # inline values after a GCS restart) adopt ownership WITHOUT
            # the pin — the owner's live-ref snapshot already accounts
            # every local reference.
            if not o.get("rs"):  # raylint: disable=RTL123 (resync row field)
                entry.refcount += 1
            entry.owner = owner
            self._owned_objects.setdefault(self._owner_key(owner),
                                           set()).add(oid)
        # ``nh`` (no holder): an actor-call CALLER registering results
        # held in the actor's node arena, not its own — the executing
        # worker's registration carries the true holder.
        if client.node_id is not None and o.get("shm") \
                and not o.get("nh"):  # raylint: disable=RTL123 (obj_puts row field)
            entry.holders.add(client.node_id.binary())
        self._mark_ready(entry, o["nbytes"], o.get("data"),
                         o.get("shm", False))
        if o.get("data") is not None:
            # Inline payloads are durable (small by definition); shm objects
            # need no WAL — the arena survives a GCS crash and is rescanned.
            self._log_append("obj", [o["oid"], o["data"]])

    async def _h_obj_put(self, client, msg):
        self._obj_put_one(client, msg)
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})

    async def _h_obj_puts(self, client, msg):
        """Coalesced object registrations: one frame for a whole result
        set (multi-return tasks / actor calls) — part of the object-plane
        traffic coalescing that keeps the GCS off the per-call data
        path."""
        for o in msg["objs"]:
            self._obj_put_one(client, o)
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})

    async def _h_obj_wait(self, client, msg):
        # Per-ref lane: same resolve-now logic as the batched lane (ONE
        # source of truth — the lanes must never drift), row translated
        # back to the legacy reply shape.
        oid_b = bytes(msg["oid"])
        row = self._obj_wait_row(oid_b)
        if row is None:
            self.objects[ObjectID(oid_b)].waiters.append((client.conn, msg))
            return
        code, payload = row[1], row[2]
        if code == 1:
            client.conn.reply(msg, {"ok": True, "where": "inline",
                                    "data": payload,
                                    "nbytes": len(payload)})
        elif code == 2:
            client.conn.reply(msg, {"ok": True, "where": "shm",
                                    "nbytes": payload})
        else:
            client.conn.reply(msg, {"ok": False, "err": payload})

    def _obj_wait_row(self, oid_b: bytes) -> Optional[list]:
        """Resolve-now attempt for one waited-on oid — the shared
        resolution logic of BOTH lanes (per-ref ``obj_wait`` translates
        the row to its legacy reply; ``obj_waits`` ships rows verbatim):
        spilled restore / serve-inline-from-disk, unrecoverable-spill
        fast-fail, reconstruction trigger. Returns a resolution row, or
        None when the oid must pend (the caller registers its waiter on
        the entry). Row shapes: ``[oid, 1, data]`` inline,
        ``[oid, 2, nbytes]`` shm, ``[oid, 0, err]`` lost."""
        oid = ObjectID(oid_b)
        entry = self._obj(oid)
        if (entry.spilled is not None and _cfg().spill_serve
                and self._spill_servable(entry)):
            # Serve-from-spill: don't restore the whole file into the
            # arena before the waiter moves a byte — reply the shm row
            # and let the puller stripe chunks straight off the spill
            # tier (obj_locate advertises the spill-serving endpoints).
            return [oid_b, 2, entry.nbytes]
        if entry.spilled is not None and not self._restore_spilled(entry):
            # Can't re-admit to the store: serve the disk bytes inline.
            try:
                with open(entry.spilled, "rb") as f:
                    return [oid_b, 1, f.read()]
            except OSError:
                if not entry.on_shm and not entry.holders:
                    # Spill file gone and no node holds a copy: the value
                    # is unrecoverable — fail THIS oid fast instead of
                    # sending the client on a doomed pull (and never
                    # poison the rest of its group).
                    return [oid_b, 0,
                            f"object {oid.hex()} lost: spill file "
                            "unreadable and no holders remain"]
        if entry.ready:
            if entry.inline is not None:
                return [oid_b, 1, entry.inline]
            return [oid_b, 2, entry.nbytes]
        self._try_reconstruct(entry)
        return None

    async def _h_obj_waits(self, client, msg):
        """Batched wait group: N oids + a num_returns threshold in one
        frame (the vectorized reference plane — plasma's batch Wait/Get
        surface). Already-resolved oids row up immediately; the reply
        fires as soon as the threshold is met; later resolutions stream
        as coalesced ``obj_res`` pushes. Duplicate oids in one call
        collapse to a single row."""
        oids = msg["oids"]
        rows: list = []
        seen: Set[bytes] = set()
        pending_entries = []
        for oid_b in oids:
            ob = bytes(oid_b)
            if ob in seen:
                continue
            seen.add(ob)
            try:
                row = self._obj_wait_row(ob)
            except Exception:
                logger.exception("obj_waits resolution failed for %s",
                                 ObjectID(ob).hex())
                row = [ob, 0, "internal error resolving object"]
            if row is not None:
                rows.append(row)
            else:
                pending_entries.append(self.objects[ObjectID(ob)])
        need = int(msg.get("nr") or len(seen))
        need = max(1, min(need, len(seen))) if seen else 0
        half = len(pending_entries) // 2
        if len(seen) > 1:
            plane_events.emit("wait.group.register", plane="wait",
                              tenant=self._client_tenant(client) or "",
                              oids=len(seen),
                              pending=len(pending_entries), nr=need)
        else:
            # Single-oid groups are the worker per-arg lane (thousands/s
            # under load): fold them into an aggregate counter instead
            # of one ring row apiece.
            plane_events.count("wait.group.single", plane="wait")
        if len(rows) >= need:
            if need > 1:
                plane_events.emit("wait.group.threshold", plane="wait",
                                  rows=len(rows), nr=need)
            client.conn.reply(msg, {"ok": True, "rows": rows})
            if pending_entries:
                group = WaitGroup(client, msg, need, rows)
                group.replied = True
                group.rows = None
                for n, entry in enumerate(pending_entries):
                    if n == half and failpoints.active():
                        # Crash mid-group registration (threshold-met
                        # branch — the worker lane's nr=1 groups land
                        # here): the reply already went out, some
                        # entries hold the group's waiter, the rest
                        # never will. Recovery relies on the client's
                        # epoch-gated resubscription replacing the
                        # whole group on the fresh instance.
                        self._fp("gcs.obj_waits.mid")
                    entry.waiters.append(group)
            return
        group = WaitGroup(client, msg, need, rows)
        for n, entry in enumerate(pending_entries):
            if n == half and failpoints.active():
                # Crash mid-group registration, pre-reply branch: the
                # client never hears back AND the fresh instance has no
                # group — same resubscription contract.
                self._fp("gcs.obj_waits.mid")
            entry.waiters.append(group)

    async def _h_obj_report(self, client, msg):
        """Bulk object-location resync from a node agent (arena rescan
        after agent or GCS restart)."""
        if client.node_id is None:
            return
        nid_b = client.node_id.binary()
        for oid_b, nbytes in msg["objs"]:
            entry = self._obj(ObjectID(bytes(oid_b)))
            entry.holders.add(nid_b)
            if not entry.ready:
                entry.nbytes = nbytes
                entry.on_shm = True
                entry.ready = True
                self._notify_obj_waiters(entry)

    async def _h_obj_locate(self, client, msg):
        """Object directory lookup for the P2P object plane (reference:
        ``ObjectDirectory`` over the object-location pubsub channel,
        ``object_manager/object_directory.h``): returns the agents a
        puller can fetch chunks from directly. Inline values come back
        inline; only locations — never data — transit the GCS here."""
        oid = ObjectID(msg["oid"])
        entry = self.objects.get(oid)
        if entry is None or not entry.ready:
            client.conn.reply(msg, {"ok": False, "err": "object not ready"})
            return
        if entry.inline is not None:
            client.conn.reply(msg, {"ok": True, "data": entry.inline})
            return
        addrs = []
        holder_nodes = []
        for node_id in entry.holders:
            node = self.nodes.get(NodeID(node_id))
            if node is not None and node.alive and node.obj_addr:
                addrs.append(node.obj_addr)
                holder_nodes.append(node)
        if entry.on_shm and self.store.contains(oid):
            # Head-arena object (e.g. a driver put): served by any agent
            # attached to the head arena (empty store suffix).
            for node in self.nodes.values():
                if (node.alive and node.obj_addr
                        and node.store_suffix == ""
                        and node.obj_addr not in addrs):
                    addrs.append(node.obj_addr)
                    holder_nodes.append(node)
        elif entry.spilled is not None and _cfg().spill_serve:
            # Spilled head-host object: the spill path is deterministic
            # (session_dir/spill/<oid>.bin), so every head-arena process
            # can pread chunks straight off the file — advertise them as
            # sources instead of forcing a full RAM restore before the
            # first byte moves (serve-from-spill).
            for node in self.nodes.values():
                if (node.alive and node.obj_addr
                        and node.store_suffix == ""
                        and node.obj_addr not in addrs):
                    addrs.append(node.obj_addr)
                    holder_nodes.append(node)
        # A holder NODE can serve from several processes: its agent plus
        # idle workers attached to the same arena (each with its own TCP
        # serve socket). One serving process tops out well below a
        # broadcast fan-in's demand — advertising multiple endpoints
        # multiplies the node's egress. The worker list is ROTATED per
        # lookup so concurrent pullers land on different endpoints
        # instead of all sharing the first two.
        self._locate_rr += 1
        for node in holder_nodes:
            added = 0
            wids = list(node.idle_workers)
            k = len(wids)
            for j in range(k):
                w = self.workers.get(wids[(j + self._locate_rr) % k])
                a = (w.obj_addr or w.addr) if w is not None else ""
                if (w is not None and not w.conn.closed and a
                        and a not in addrs):
                    addrs.append(a)
                    added += 1
                    if added >= 2:
                        break
        reply = {"ok": True, "nbytes": entry.nbytes,
                 "addrs": addrs,
                 # Holder NODE ids too: locality-aware
                 # consumers (ray_tpu_torch.data) schedule the
                 # reading task onto a holding node.
                 "nids": [nid for nid in entry.holders],
                 "spilled": entry.spilled is not None}
        # Cooperative-broadcast surface: mid-pull partial holders with
        # their chunk bitmaps, the canonical chunk size, and per-source
        # in-flight pull counts (load-aware striping).
        if msg.get("pull") and not entry.cs:
            # Sub-chunk striping: the directory assigns the canonical
            # chunk size on the FIRST pull-locate, targeting at least
            # stripe_min_chunks chunks per object. A 16-64MB weight leaf
            # is one-or-few default chunks — unstripeable; sub-chunking
            # gives every puller chunks to relay while its own pull is
            # still in flight, which is what drives the origin's share
            # of a cooperative broadcast below 50%.
            entry.cs = self._stripe_chunk_size(entry.nbytes)
        if entry.cs:
            reply["cs"] = entry.cs
        if msg.get("pull"):
            # The caller is about to PULL this object: register it as an
            # active puller and hand back a stable ordinal + the live
            # puller count. Pullers stagger their chunk order by the
            # ordinal (disjoint early stripes -> relay fodder) and
            # restrict full-holder claims to ~1/npull of the object, so
            # the source's egress approaches ONE copy instead of N.
            if entry.pullers is None:
                entry.pullers = {}
            prec = entry.pullers.get(client.serial)
            if prec is None:
                prec = entry.pullers[client.serial] = [entry.pseq, set()]
                entry.pseq += 1
                # GC on disconnect even if the puller never reports
                # progress (it would otherwise inflate npull forever).
                client.pull_regs.add((oid.binary(), None))
            reply["pidx"] = prec[0]
            reply["npull"] = len(entry.pullers)
        loads: Dict[str, int] = {}
        if entry.pullers:
            for prec in entry.pullers.values():
                for a in prec[1]:
                    loads[a] = loads.get(a, 0) + 1
        if loads:
            reply["loads"] = loads
        if entry.partial:
            reply["partial"] = [
                [addr, bytes(p[1]), entry.cs, loads.get(addr, 0)]
                for addr, p in entry.partial.items() if p[2] > 0]
        client.conn.reply(msg, reply)

    # ------------------------------------ cooperative broadcast directory

    async def _h_obj_progress(self, client, msg):
        """Chunk-bitmap progress from a mid-pull holder (cooperative
        broadcast): the directory learns which chunks the puller already
        holds — so later pullers stripe off it immediately — and which
        sources it is pulling from (the per-holder in-flight load
        ``obj_locate`` hands back for load-aware striping). A ``done``
        report retires the partial entry (the sealed copy was registered
        as a full holder in the same FIFO stream) and credits per-source
        served bytes to the transfer accounting."""
        entry = self.objects.get(ObjectID(msg["oid"]))
        if entry is None:
            return
        addr = msg.get("addr")
        if msg.get("done"):
            for a, n in (msg.get("src_bytes") or {}).items():
                self._bcast_account(entry, a, n)
            if addr and entry.partial:
                entry.partial.pop(addr, None)
            if entry.pullers:
                entry.pullers.pop(client.serial, None)
            client.pull_regs.discard((bytes(msg["oid"]), addr))
            client.pull_regs.discard((bytes(msg["oid"]), None))
            return
        cs = int(msg.get("cs") or 0)
        if cs <= 0:
            return
        if entry.cs and cs != entry.cs:
            return  # mismatched chunk geometry: ignore, don't corrupt
        entry.cs = cs
        srcs = msg.get("srcs")
        if srcs is not None:
            if entry.pullers is None:
                entry.pullers = {}
            prec = entry.pullers.get(client.serial)
            if prec is None:
                prec = entry.pullers[client.serial] = [entry.pseq, set()]
                entry.pseq += 1
            prec[1] = set(srcs)
            client.pull_regs.add((bytes(msg["oid"]), addr))
        if not addr:
            return
        nchunks = max(1, (int(msg.get("nbytes") or entry.nbytes) + cs - 1)
                      // cs)
        if entry.partial is None:
            entry.partial = {}
        p = entry.partial.get(addr)
        if p is None:
            node_b = bytes(msg["node"]) if msg.get("node") else b""
            p = entry.partial[addr] = [node_b, bitmap_make(nchunks), 0]
            if node_b:
                node = self.nodes.get(NodeID(node_b))
                self._addr_nodes[addr] = (
                    NodeID(node_b).hex(),
                    node.store_suffix if node is not None else None)
        bm = p[1]
        for idx in msg.get("add") or ():
            i = int(idx)
            if 0 <= i < nchunks and not bitmap_test(bm, i):
                bitmap_set(bm, i)
                p[2] += 1

    def _bcast_account(self, entry, addr: str, n):
        hint = self._addr_nodes.get(addr)
        if hint is None:
            for nid, node in self.nodes.items():
                if node.obj_addr == addr:
                    hint = self._addr_nodes[addr] = (nid.hex(),
                                                     node.store_suffix)
                    break
        if hint is None:
            # Worker serve endpoints (obj_locate advertises idle workers
            # next to the agent) must attribute to their NODE too —
            # otherwise bytes the source node's workers served vanish
            # from the source-share metric and it reads better than it is.
            for w in self.workers.values():
                if w.obj_addr == addr and w.node_id is not None:
                    node = self.nodes.get(w.node_id)
                    hint = self._addr_nodes[addr] = (
                        w.node_id.hex(),
                        node.store_suffix if node is not None else None)
                    break
        key = hint[0] if hint else addr
        rec = self.bcast_served.get(key)
        if rec is None:
            rec = self.bcast_served[key] = {
                "suffix": hint[1] if hint else None, "bytes": 0}
        rec["bytes"] += int(n)

    # Senders live in tests/ + benchmarks/ (broadcast accounting probe).
    async def _h_obj_xfer_stats(self, client, msg):  # raylint: disable=RTL122
        """Per-source served-bytes totals for the cooperative broadcast
        plane (node hex where resolvable, else serve addr): the proof
        surface that non-source peers carried the traffic."""
        client.conn.reply(msg, {"ok": True, "served": [
            [key, rec["suffix"], rec["bytes"]]
            for key, rec in self.bcast_served.items()]})

    def _drop_pull_regs(self, client: ClientConn):
        for oid_b, addr in client.pull_regs:
            entry = self.objects.get(ObjectID(oid_b))
            if entry is None:
                continue
            if addr and entry.partial:
                entry.partial.pop(addr, None)
            if entry.pullers:
                entry.pullers.pop(client.serial, None)
        client.pull_regs.clear()

    async def _h_obj_holders(self, client, msg):
        """Batch holder-node lookup: oids -> [[node_id, ...], ...].
        One round trip for a whole dataset's block refs (locality-aware
        consumers; a per-ref obj_locate sweep serializes driver startup)."""
        out = []
        for oid_b in msg["oids"]:
            entry = self.objects.get(ObjectID(oid_b))
            out.append(list(entry.holders)
                       if entry is not None and entry.ready else [])
        client.conn.reply(msg, {"ok": True, "holders": out})

    async def _h_obj_pull(self, client, msg):
        """Serve the raw bytes of an object to a host that doesn't share a
        store with any holder.

        This is the control-plane half of the reference's object-manager
        Push/Pull transfer (``object_manager/object_manager.h:117-206``):
        locate a holder via the object directory, have it upload, relay to
        the requester. Runs as its own task so a slow holder doesn't block
        this client's other messages.
        """
        task = asyncio.get_running_loop().create_task(
            self._do_pull(client, msg))
        # The loop holds tasks weakly; anchor it until done.
        self._pull_tasks.add(task)
        task.add_done_callback(self._pull_tasks.discard)

    async def _do_pull(self, client, msg):
        oid = ObjectID(msg["oid"])
        entry = self.objects.get(oid)
        if entry is None or not entry.ready:
            client.conn.reply(msg, {"ok": False, "err": "object not ready"})
            return
        if entry.inline is not None:
            client.conn.reply(msg, {"ok": True, "data": entry.inline})
            return
        if entry.spilled is not None:
            try:
                # Spilled payloads are arbitrarily large (they spilled
                # BECAUSE they were big): the disk read must not stall
                # the control-plane loop — every heartbeat, lease, and
                # wait group on this GCS parks behind it. Found by
                # raylint RTL006 in a self-scan.
                data = await asyncio.get_running_loop().run_in_executor(
                    None, _read_spilled, entry.spilled)
                client.conn.reply(msg, {"ok": True, "data": data})
                return
            except OSError:
                pass
        # Head-host store (the GCS shares it with head-node workers).
        view = self.store.get(oid, entry.nbytes)
        if view is not None:
            try:
                client.conn.reply(msg, {"ok": True, "data": bytes(view.data)})
            finally:
                view.close()
            return
        # Relay from a worker on a holder node, else from the owning client
        # (e.g. a remote ray:// driver whose store nobody shares).
        uploaders = [w.conn for w in self.workers.values()
                     if w.node_id.binary() in entry.holders
                     and not w.conn.closed]
        if entry.owner is not None and entry.owner.conn is not None \
                and not entry.owner.conn.closed \
                and entry.owner.conn is not client.conn:
            uploaders.append(entry.owner.conn)
        for conn in uploaders:
            try:
                reply = await conn.request(
                    {"t": "obj_upload", "oid": msg["oid"],
                     "nbytes": entry.nbytes}, timeout=30)
            except (ConnectionError, asyncio.TimeoutError):
                continue
            if reply.get("ok") and reply.get("data") is not None:
                client.conn.reply(msg, {"ok": True, "data": reply["data"]})
                return
        client.conn.reply(msg, {"ok": False,
                                "err": f"no holder could serve "
                                       f"{oid.hex()[:16]}"})

    async def _h_ref(self, client, msg):
        for oid_bytes, delta in msg["d"]:
            oid = ObjectID(oid_bytes)
            entry = self.objects.get(oid)
            if entry is None:
                # Early delta: the ref release/borrow outran the object's
                # registration. Park it; _obj() applies it at creation.
                if delta:
                    self._early_ref_deltas[oid] = \
                        self._early_ref_deltas.get(oid, 0) + delta
                    while len(self._early_ref_deltas) > 65536:
                        self._early_ref_deltas.pop(
                            next(iter(self._early_ref_deltas)))
                continue
            was = entry.refcount
            entry.refcount += delta
            if entry.refcount <= 0 and entry.ready:
                self._lru_touch(entry)
                if was > 0 and entry.inline is None:
                    self._doom(oid)
            elif entry.refcount > 0:
                self.zero_ref_lru.pop(oid, None)
                self._doomed.pop(oid, None)

    def _doom(self, oid: ObjectID):
        """The last reference to a store block went: free it once it has
        stayed unreferenced for ``_ZERO_REF_FREE_S``, as the reference's
        owner frees an out-of-scope object. Left in the LRU until the
        store is full, blocks of two sizes (a task's argument bundle is a
        few hundred bytes smaller than the block it returns) fragment the
        arena until no freed hole fits the next block, and the store
        fills. Not at once: a borrower's +1 may reach this directory after
        the -1 of a reader that got the ref over an actor connection (an
        async actor replies before its increfs leave), and a caller's
        holder-less registration may land before the holder's own; both
        come within milliseconds."""
        self._doomed.pop(oid, None)
        self._doomed[oid] = time.monotonic() + _ZERO_REF_FREE_S
        if self._doom_timer is None:
            self._doom_timer = asyncio.get_running_loop().call_later(
                _ZERO_REF_FREE_S, self._free_doomed)

    def _free_doomed(self):
        self._doom_timer = None
        now = time.monotonic()
        while self._doomed:
            oid, due = next(iter(self._doomed.items()))
            if due > now:
                self._doom_timer = asyncio.get_running_loop().call_later(
                    due - now, self._free_doomed)
                return
            del self._doomed[oid]
            entry = self.objects.get(oid)
            if entry is not None and entry.ready and entry.refcount <= 0:
                self.zero_ref_lru.pop(oid, None)
                self._free_entry(oid, entry)

    def _lru_touch(self, entry: ObjectEntry):
        self.zero_ref_lru.pop(entry.object_id, None)
        self.zero_ref_lru[entry.object_id] = entry.nbytes

    def _maybe_evict(self):
        """LRU-evict zero-ref shm objects when over capacity, then spill
        referenced ones to disk.

        Mirrors plasma's LRU eviction (``plasma/eviction_policy.h:105``) plus
        the raylet's object spilling (``raylet/local_object_manager.h:41``):
        we never *delete* a referenced object; once zero-ref eviction can't
        free enough, referenced shm objects are written to session-dir spill
        files and their shm segments released, restored on demand.
        """
        if self.store_capacity <= 0:
            return
        self._free_to(self.store_capacity)

    def _free_to(self, target_bytes: int):
        while self.shm_bytes > target_bytes and self.zero_ref_lru:
            oid, nbytes = self.zero_ref_lru.popitem(last=False)
            entry = self.objects.get(oid)
            if entry is None or not entry.ready:
                continue
            self._free_entry(oid, entry)
        if self.shm_bytes > target_bytes:
            self._spill_until_under(target_bytes)

    def _free_entry(self, oid: ObjectID, entry: ObjectEntry):
        """Delete a ready object that no reference holds: its arena
        block, its spill file and its directory entry."""
        if entry.on_shm:
            # Arena delete defers the actual free while readers hold
            # pins (rtpt_store_delete -> doomed state), so this is
            # always safe to issue.
            self.store.delete(oid)
            self.shm_bytes -= entry.nbytes
        if entry.spilled is not None:
            try:
                os.unlink(entry.spilled)
            except OSError:
                pass
        if entry.inline is not None:
            self._log_append("objd", oid.binary())
        if entry.waiters:
            # Defensive: deleting an entry must never strand a wait
            # group — each waiter gets a lost row, not silence.
            self._fail_obj_waiters(entry, "object evicted")
        del self.objects[oid]

    async def _health_check_loop(self):
        """Active node health checks (reference: ``GcsHealthCheckManager``,
        ``gcs_health_check_manager.h:39`` — the GCS pings every raylet;
        N consecutive misses marks the node dead). TCP disconnects catch
        clean deaths instantly; this loop catches half-open links
        (network partitions, frozen hosts) that never FIN."""
        from .config import config as _cfg2

        interval = _cfg2().health_check_interval_s
        failure_threshold = _cfg2().health_check_failures
        misses: Dict[bytes, int] = {}

        async def ping(node):
            nid_b = node.node_id.binary()
            try:
                await node.agent_conn.request({"t": "health_check"},
                                              timeout=interval)
                misses.pop(nid_b, None)
            except (ConnectionError, asyncio.TimeoutError):
                misses[nid_b] = misses.get(nid_b, 0) + 1
                if misses[nid_b] >= failure_threshold:
                    logger.warning(
                        "node %s failed %d health checks: marking dead",
                        node.node_id.hex()[:8], misses.pop(nid_b))
                    self._on_node_death(node.node_id)

        spawn_timeout = _cfg2().spawn_timeout_s
        while not self._shutdown_event.is_set():
            await asyncio.sleep(interval)
            try:
                # Maintenance rides the health tick: plane-event +
                # trace-KV retention, and this process's own recorder
                # ring folds into the table.
                self._retention_sweep()
            except Exception:
                logger.exception("retention sweep failed")
            # Stale-spawn decay: a spawn_worker frame lost in flight (or
            # an agent that died mid-spawn without reporting) would pin
            # node.spawning and starve the lease plane of new workers
            # forever. ONE slot per window, not the whole counter: venv
            # worker spawns legitimately build environments for minutes
            # before the hello — zeroing would re-spawn the whole batch
            # every window, stampeding the node once the builds land.
            # The rare genuinely-lost slot still drains, a window apiece.
            now = time.time()
            for n in self.nodes.values():
                if (n.spawning > 0
                        and now - n.spawn_ts > spawn_timeout):
                    logger.warning(
                        "releasing 1 of %d stale spawn slot(s) on %s "
                        "(no worker hello in %.0fs)", n.spawning,
                        n.node_id.hex()[:8], spawn_timeout)
                    n.spawning -= 1
                    n.spawn_ts = now  # next slot gets its own window
                    self._wake_scheduler()
            targets = [n for n in self.nodes.values()
                       if n.alive and n.agent_conn is not None
                       and not n.agent_conn.closed]
            if targets:
                # Concurrent fan-out: one unresponsive node's timeout must
                # not delay (or compound into) the others' checks.
                await asyncio.gather(*(ping(n) for n in targets))

    # ------------------------------------------------- SLO enforcement

    async def _slo_loop(self):
        """Interference-detector cadence (_private/slo.py): fold this
        process's recorder ring into the table (the sweep reads the
        table, and the GCS's own admission/lease rows matter for
        attribution), then run one sweep. Idle-cheap: with no specs
        registered the sweep returns before touching the table."""
        interval = self.slo.sweep_interval
        while not self._shutdown_event.is_set():
            await asyncio.sleep(interval)
            try:
                if self.slo.tenants:
                    self._ingest_local_plane_events()
                self.slo.sweep()
            except Exception:
                logger.exception("slo sweep failed")

    def _tenant_slice(self, client) -> int:
        """Rung-1 backend, ingress half: a de-weighted tenant's DRIVER
        lanes drain at ``fair_slice * weight`` frames per round-robin
        cycle (floor 1 — the offender stays live, just slow). Workers
        and agents are never de-weighted: stalling the data plane or
        health checks to punish a tenant would be self-harm (the same
        exemption the admission budget makes)."""
        if not self._tenant_weights or client.role != "driver":
            return self._fair_slice
        w = self._tenant_weights.get(client.namespace or "default")
        if w is None:
            return self._fair_slice
        return max(1, int(self._fair_slice * w))

    def _tenant_adm_high(self, client) -> int:
        """Rung-1 backend, admission half: the de-weighted tenant's
        in-flight budget scales with its weight, so kernel backpressure
        engages proportionally earlier for the offender's sockets."""
        if not self._tenant_weights:
            return self._adm_high
        w = self._tenant_weights.get(client.namespace or "default")
        if w is None:
            return self._adm_high
        return max(2, int(self._adm_high * w))

    def _tenant_adm_low(self, client) -> int:
        """Unblock watermark paired with ``_tenant_adm_high``: without
        scaling, a de-weighted tenant blocking at (high * weight) <
        adm_low would unblock on the very next drain cycle — a
        block/unblock oscillation that spams backpressure frames
        instead of holding the socket closed."""
        if not self._tenant_weights or client.role != "driver":
            return self._adm_low
        high = self._tenant_adm_high(client)
        if high >= self._adm_high:
            return self._adm_low
        return min(self._adm_low, high // 2)

    def _tenant_hold_s(self, client) -> float:
        """Rung-1 pacing half: post-unblock read-loop hold for a
        de-weighted DRIVER lane, ~1ms x (1/weight - 1) capped at 1s
        (weight 0.05 -> 19ms -> a budget's worth of frames per ~20ms
        instead of per drain cycle). Zero for everyone else — the
        plain admission path is untouched."""
        if not self._tenant_weights or client.role != "driver":
            return 0.0
        w = self._tenant_weights.get(client.namespace or "default")
        if w is None or w >= 1.0:
            return 0.0
        return min(1.0, 0.001 * (1.0 / w - 1.0))

    def _rebalance_against(self, offender: str, max_leases: int) -> int:
        """Rung-2 backend: revoke up to ``max_leases`` worker leases
        held by the offender tenant's drivers — the graceful
        ``_revoke_lease_for_rebalance`` semantics (in-flight pushes
        finish; re-requested leases compete under the offender's
        de-weighted ingress), TARGETED at one tenant instead of the
        passive over-share scan."""
        revoked = 0
        for w in list(self.workers.values()):
            if revoked >= max_leases:
                break
            owner = w.leased_to
            if owner is None or w.conn.closed:
                continue
            if (owner.namespace or "default") != offender:
                continue
            self._revoke_lease_for_rebalance(owner, w)
            revoked += 1
        if revoked:
            self._wake_scheduler()
        return revoked

    def _migrate_tenant(self, offender: str, victim: str = "") -> str:
        """Rung-3 backend: drain the node carrying the MOST offender
        presence (its restartable actors + leased workers), via the
        drain path — restartable work migrates off, the deadline
        forces the rest. Node choice prefers nodes that also host the
        victim (separating the pair is the point); returns the drained
        node's hex id, or "" when no node qualifies (single-node
        clusters: draining the only node would take the victim with
        it)."""
        presence: Dict[bytes, int] = {}
        victims: Dict[bytes, int] = {}
        for rec in self.actors.values():
            if rec.state != A_ALIVE or rec.node_id is None:
                continue
            if rec.namespace == offender:
                nid = rec.node_id.binary()
                presence[nid] = presence.get(nid, 0) + 1
            elif victim and rec.namespace == victim:
                victims[rec.node_id.binary()] = 1
        for w in self.workers.values():
            if w.leased_to is not None and not w.conn.closed \
                    and (w.leased_to.namespace or "default") == offender \
                    and w.node_id is not None:
                nid = w.node_id.binary()
                presence[nid] = presence.get(nid, 0) + 1
        live = {n.node_id.binary() for n in self.nodes.values()
                if n.alive and not n.draining}
        candidates = {nid: c for nid, c in presence.items() if nid in live}
        if not candidates or len(live) < 2:
            return ""
        nid = max(candidates,
                  key=lambda k: (candidates[k], victims.get(k, 0)))
        node = self.nodes.get(NodeID(nid))
        if node is None:
            return ""
        # The drain handler's full semantics (migration, lease
        # revocation, gang advisory, deadline) — invoked internally:
        # with no "i" reply id the client arg is never touched.
        asyncio.get_running_loop().create_task(
            self._h_drain_node(None, {
                "node_id": nid,
                "reason": f"slo enforcement: tenant {offender!r} "
                          f"interfering with {victim or 'cluster'}"}))
        return nid.hex()

    async def _h_slo_register(self, client, msg):
        """Register/replace (or remove, spec=None) a tenant's SLO spec
        at runtime — the quota plane's runtime face for the detector."""
        tenant = str(msg.get("tenant") or self._client_tenant(client))
        raw = msg.get("spec")
        if raw is None:
            removed = self.slo.unregister(tenant)
            client.conn.reply(msg, {"ok": True, "removed": removed})
            return
        try:
            spec = self.slo.register(tenant, dict(raw))
        except (TypeError, ValueError) as e:
            client.conn.reply(msg, {"ok": False, "err": str(e)})
            return
        client.conn.reply(msg, {"ok": True, "tenant": tenant,
                                "spec": spec})

    async def _h_slo_status(self, client, msg):
        client.conn.reply(msg, {"ok": True, **self.slo.status()})

    async def _h_slo_force(self, client, msg):
        """Drill hook: execute one enforcement rung now (journaled with
        forced=1), or restore=1 to undo a re-weight without waiting out
        the recover hysteresis. The tier-1 soak smoke drives its
        deterministic enforcement action through this."""
        offender = str(msg.get("offender") or "")
        if msg.get("restore"):
            had = self.slo.restore(offender)
            client.conn.reply(msg, {"ok": True, "restored": had})
            return
        try:
            rec = self.slo.force(str(msg.get("rung") or "reweight"),
                                 offender, str(msg.get("victim") or ""))
        except Exception as e:
            client.conn.reply(msg, {"ok": False, "err": str(e)})
            return
        client.conn.reply(msg, {"ok": True, "action": rec})

    async def _h_lease_claim(self, client, msg):
        """A resyncing driver re-claims leases it held across a GCS
        restart: mark those workers leased (removing them from idle),
        charge their resources, AND re-charge the claimant's tenant quota
        usage — restoring pre-restart accounting completely. Without the
        tenant re-charge (the pre-chaos-certification behavior), a
        quota'd tenant emerged from every GCS restart with its usage
        zeroed while still HOLDING its leases, so it could acquire up to
        a full second quota's worth on the fresh instance."""
        ns = self._client_tenant(client)
        for claim in msg.get("leases", []):
            wid_b, res = claim[0], claim[1]
            w = self.workers.get(WorkerID(bytes(wid_b)))
            if w is None or w.conn.closed:
                continue
            if w.leased_to is not None and w.leased_to is not client:
                continue  # already granted elsewhere: claimer loses
            already = w.leased_to is client
            w.leased_to = client
            node = self.nodes.get(w.node_id)
            if node is not None:
                try:
                    node.idle_workers.remove(w.worker_id)
                except ValueError:
                    pass
                if not w.acquired:
                    w.acquired = {k: float(v) for k, v in
                                  (res or {}).items()}
                    _res_sub(node.avail, w.acquired)
                    if len(claim) > 2 and claim[2]:
                        w.gpu_reported = [str(i) for i in claim[2]]
                        w.gpu_pinned = True
                    self._hold_reported_gpus(node, w, None)
            if w.lease_ctx is None and not already:
                # Synthetic lease context: release stays symmetric (the
                # eventual lease_ret must decrement the usage charged
                # here, exactly as a normal grant's would).
                ctx = _ClaimedLeaseCtx(ns, {k: float(v) for k, v in
                                            (res or {}).items()})
                w.lease_ctx = ctx
                self._tenant_acquire(ns, ctx.resources)
        self._wake_scheduler()

    async def _h_oom_candidates(self, client, msg):
        """Kill candidates on the asking agent's node for its memory
        monitor (reference: the raylet's worker-killing policies act on
        local knowledge; here task state lives in the GCS, so the agent
        asks). Returns (pid, started_ts, retriable) triples."""
        nid = NodeID(bytes(msg["node_id"]))
        out = []
        now = time.time()
        for w in self.workers.values():
            if w.node_id != nid or w.pid <= 0:
                continue
            if w.state == W_BUSY and w.current_task is not None:
                rec = self.tasks.get(w.current_task)
                out.append([w.pid, rec.ts_running if rec else now,
                            bool(rec and rec.retries_left > 0)])
            elif w.leased_to is not None:
                # Leased workers run direct-pushed plain tasks (default
                # retries 3): retriable, start time unknown -> newest.
                out.append([w.pid, now, True])
        client.conn.reply(msg, {"ok": True, "candidates": out})

    async def _h_oom_kill_report(self, client, msg):
        """Agent reports an OOM kill: surface WHY the worker died."""
        self._pub("node_events", {
            "event": "oom_kill",
            "node_id": client.node_id.hex() if client.node_id else None,
            "pid": msg.get("pid"), "usage": msg.get("usage"),
            "rss_bytes": msg.get("rss")})
        logger.warning("OOM kill on node %s: pid=%s usage=%.2f",
                       client.node_id.hex()[:8] if client.node_id else "?",
                       msg.get("pid"), msg.get("usage", 0.0))

    async def _h_store_pressure(self, client, msg):
        """A client's store.create hit allocator exhaustion: free space.

        The backpressure half of plasma's ``CreateRequestQueue``
        (``plasma/create_request_queue.h``) — evict zero-ref objects, then
        spill referenced ones, until the request fits.
        """
        nbytes = int(msg.get("nbytes", 0))
        if self.store_capacity > 0:
            target = max(0, self.store_capacity - nbytes)
        else:
            # Unlimited logical capacity but the physical arena filled:
            # free at least the requested amount.
            target = max(0, self.shm_bytes - nbytes)
        self._free_to(target)
        client.conn.reply(msg, {"ok": True})

    def _spill_dir(self) -> str:
        path = os.path.join(self.session_dir, "spill")
        os.makedirs(path, exist_ok=True)
        return path

    def _stripe_chunk_size(self, nbytes: int) -> int:
        """Directory-assigned canonical chunk size for a pulled object:
        halve the transfer chunk until the object splits into at least
        ``stripe_min_chunks`` chunks, never below ``stripe_chunk_floor``
        (per-chunk framing overhead dominates beneath it). 0 = striping
        disabled; the first puller's client chunk size wins as before."""
        cfg = _cfg()
        want = int(cfg.stripe_min_chunks)
        if want <= 0 or nbytes <= 0:
            return 0
        cs = max(1, int(cfg.pull_chunk_bytes))
        floor = max(1, int(cfg.stripe_chunk_floor))
        while cs > floor and (nbytes + cs - 1) // cs < want:
            cs //= 2
        return max(cs, floor)

    def _spill_servable(self, entry) -> bool:
        """Can a puller stripe this spilled object off the spill tier /
        surviving holders right now, without a full restore? True when a
        live endpoint exists: a registered holder node, or any head-arena
        process that can pread the deterministic spill path."""
        for nid in entry.holders:
            node = self.nodes.get(NodeID(nid))
            if node is not None and node.alive and node.obj_addr:
                return True
        if entry.spilled is None or not os.path.exists(entry.spilled):
            # No holder and no file: unrecoverable — let the wait path's
            # restore attempt produce the honest lost row.
            return False
        for node in self.nodes.values():
            if node.alive and node.obj_addr and node.store_suffix == "":
                return True
        return False

    def _spill_until_under(self, target_bytes: int):
        # Oldest-first over referenced, ready, head-host shm objects.
        for entry in list(self.objects.values()):
            if self.shm_bytes <= target_bytes:
                break
            if not (entry.ready and entry.on_shm and entry.spilled is None):
                continue
            view = self.store.get(entry.object_id, entry.nbytes)
            if view is None:
                continue  # lives on another host's store; their agent spills
            path = os.path.join(self._spill_dir(),
                                entry.object_id.hex() + ".bin")
            try:
                if failpoints.active():
                    # Spill-write boundary: ``raise`` lands in the OSError
                    # handler below (write failed, object stays in the
                    # arena); ``drop`` skips spilling this entry.
                    if failpoints.fire("store.spill.write") == "drop":
                        continue
                with open(path, "wb") as f:
                    f.write(view.data)
            except OSError:
                logger.exception("spill write failed for %s",
                                 entry.object_id.hex())
                continue
            finally:
                view.close()
            entry.spilled = path
            entry.on_shm = False
            self.store.delete(entry.object_id)
            self.shm_bytes -= entry.nbytes
            logger.info("spilled %s (%d bytes) to %s",
                        entry.object_id.hex()[:16], entry.nbytes, path)

    def _restore_spilled(self, entry: ObjectEntry) -> bool:
        """Read a spill file back into the head-host store."""
        if entry.spilled is None:
            return True
        try:
            data = _read_spilled(entry.spilled)
        except OSError:
            logger.exception("spill restore failed for %s",
                             entry.object_id.hex())
            return False
        try:
            buf = self.store.create(entry.object_id, len(data))
            buf[:len(data)] = data
            self.store.seal(entry.object_id)
        except FileExistsError:
            pass
        except MemoryError:
            try:
                self._free_to(max(0, self.store_capacity - len(data)))
                buf = self.store.create(entry.object_id, len(data))
                buf[:len(data)] = data
                self.store.seal(entry.object_id)
            except MemoryError:
                # Store still full (e.g. everything pinned): leave the
                # object on disk; readers fall back to the inline/pull path.
                return False
        try:
            os.unlink(entry.spilled)
        except OSError:
            pass
        entry.spilled = None
        entry.on_shm = True
        self.shm_bytes += entry.nbytes
        self._maybe_evict()
        return True

    def _try_reconstruct(self, entry: ObjectEntry) -> bool:
        """Lineage reconstruction: resubmit the producing task.

        Reference: ``core_worker/object_recovery_manager.h:41`` — the owner
        resubmits the task that created a lost object.
        """
        spec = entry.producing_task
        if spec is None:
            return False
        tid = entry.object_id.task_id()
        if tid in self.tasks and self.tasks[tid].state in ("pending", "running"):
            return True  # already being recomputed
        record = TaskRecord(tid, spec["msg"], spec["owner"])
        self.tasks[tid] = record
        self.pending.append(record)
        self._wake_scheduler()
        return True

    # --------------------------------------------------------------- tasks

    async def _h_submit(self, client, msg):
        tid = TaskID(msg["tid"])
        record = TaskRecord(tid, msg, client)
        self.counters["tasks_submitted"] += 1
        self.tasks[tid] = record
        for oid in record.returns:
            entry = self._obj(oid)
            # The owner's initial reference, pinned ONCE here — the
            # worker's later obj_put registration sees entry.owner set and
            # must NOT pin again (a submit+put double count permanently
            # leaked every >inline task result).
            if entry.owner is None:
                entry.refcount += 1
                entry.owner = client
                self._owned_objects.setdefault(self._owner_key(client),
                                               set()).add(oid)
            if record.retries_left > 0:
                entry.producing_task = {"msg": msg, "owner": client}
        self.pending.append(record)
        self._wake_scheduler()

    async def _h_task_cancel(self, client, msg):
        tid = TaskID(msg["tid"])
        record = self.tasks.get(tid)
        if record is None:
            return
        record.cancelled = True
        if record.state == "running" and record.worker_id is not None:
            w = self.workers.get(record.worker_id)
            if w is not None and not w.conn.closed:
                w.conn.send({"t": "cancel", "tid": msg["tid"],
                             "force": msg.get("force", False)})
        elif record.state == "pending":
            # Reap immediately: a cancelled task queued behind a blocked
            # class head would otherwise never be re-examined.
            self.pending.remove(record)
            self._finish_cancelled(record)

    # ---------------------------------------------------------------- leases

    async def _h_lease_req(self, client, msg):
        """A driver wants ``n`` leased workers for one scheduling class."""
        demand = LeaseDemand(client, msg)
        demand.tenant = self._client_tenant(client)
        self.pending.append(demand)
        self._wake_scheduler()

    async def _h_spawn_failed(self, client, msg):
        """Agent could not spawn a worker (e.g. venv build failure):
        release the spawning slot so the pool doesn't wedge, and re-run a
        scheduling pass — parked actors / queued work re-request their
        worker through the freed slot (the event-driven replacement for
        the old 0.05s per-actor retry poll).

        Per-env failure cap: an environment that repeatedly fails to
        build can never produce a worker — after 3 consecutive failures
        every consumer of that env fails fast with the build error
        (reference: RuntimeEnvSetupError failing the creation) instead of
        rebuilding forever."""
        node = self.nodes.get(NodeID(msg["node_id"]))
        if node is not None:
            node.spawning = max(0, node.spawning - 1)
        err = str(msg.get("err", "worker spawn failed"))
        logger.warning("worker spawn failed on %s: %s",
                       msg.get("node_id", b"").hex()[:8] if msg.get("node_id")
                       else "?", err)
        env_key = msg.get("env_key", "")
        if env_key:
            count = self._env_failures.get(env_key, 0) + 1
            self._env_failures[env_key] = count
            if count >= 3:
                self._fail_env_consumers(env_key, err)
        self._wake_scheduler()

    def _fail_env_consumers(self, env_key: str, err: str):
        """Fail every parked actor / pending lease demand waiting on an
        environment that cannot build."""
        cause = f"runtime env setup failed: {err}"
        for record in list(self._actor_pending_place.values()):
            if record.env_key == env_key:
                self._actor_pending_place.pop(record.actor_id, None)
                record.state = A_DEAD
                record.death_cause = cause
                self._cleanup_dead_actor(record)
        for sig, q in list(self.pending.qs.items()):
            for record in list(q):
                if getattr(record, "env_key", "") != env_key:
                    continue
                if isinstance(record, LeaseDemand):
                    record.cancelled = True
                    if not record.client.conn.closed:
                        try:
                            record.client.conn.send(
                                {"t": "lease_void", "key": record.key,
                                 "err": cause})
                        except ConnectionError:
                            pass

    async def _h_lease_ret(self, client, msg):
        """A driver returns a leased worker; it becomes schedulable again."""
        worker = self.workers.get(WorkerID(msg["wid"]))
        if worker is None or worker.leased_to is not client:
            return
        self._release_lease(worker)
        self._wake_scheduler()

    def _release_lease(self, worker: WorkerInfo):
        ctx = worker.lease_ctx
        plane_events.emit(
            "lease.release.worker", plane="lease",
            tenant=(getattr(ctx, "tenant", "") or "") if ctx else "",
            wid=worker.worker_id.hex()[:16])
        if ctx is not None and self._tenant_quotas:
            # Covers normal grants AND post-restart re-claims: lease_claim
            # attaches a _ClaimedLeaseCtx so the usage it re-charged is
            # released here symmetrically.
            self._tenant_release(ctx.tenant, ctx.resources)
        self._release(worker, worker.lease_ctx)
        worker.leased_to = None
        worker.lease_ctx = None
        if self._retire_gpu_worker(worker):
            return
        if worker.state == W_BUSY:
            worker.state = W_IDLE
            node = self.nodes.get(worker.node_id)
            if node is not None and not worker.conn.closed:
                node.idle_workers.append(worker.worker_id)

    async def _h_task_notes(self, client, msg):
        """Batched task-completion reports from owners (direct-path tasks).

        Keeps the observability table (state API / dashboard / summaries)
        populated even though leased-path tasks never route through the
        GCS scheduler. INGESTION IS LAZY: rows land in a bounded deque
        (O(1) per batch) and materialize into ObsTaskRecords only when a
        reader asks — per-row record churn here was ~45us of head CPU per
        task at high call rates, the single largest control-plane cost of
        the async benchmarks. Reference: task events flowing to
        GcsTaskManager (gcs_task_manager.h:86)."""
        rows = msg["n"]
        self._obs_rows.extend(rows)
        counters = self.counters
        counters["tasks_submitted"] += len(rows)
        counters["tasks_finished"] += len(rows)
        counters["tasks_failed"] += sum(1 for r in rows if r[2])

    def _ingest_obs_rows(self):
        """Materialize deferred task notes into the tasks table (called by
        state-API readers; counters were already bumped at arrival)."""
        if not self._obs_rows:
            return
        rows, self._obs_rows = self._obs_rows, deque(
            maxlen=self._obs_rows.maxlen)
        tasks = self.tasks
        for tid_b, name, error, created, start, end, wid in rows:
            tid = TaskID(tid_b)
            rec = tasks.get(tid)
            if rec is None:
                rec = ObsTaskRecord(tid)
                tasks[tid] = rec
            rec.name = name
            rec.state = "done"
            rec.error = bool(error)
            rec.ts_created = created
            rec.ts_running = start
            rec.ts_done = end
            if wid:
                rec.worker_id = WorkerID(wid)
                w = self.workers.get(rec.worker_id)
                if w is not None:
                    rec.node_id = w.node_id
            self._gc_done_task(rec)

    def _wake_scheduler(self):
        self._sched_wakeup.set()

    async def _scheduler_loop(self):
        while True:
            await self._sched_wakeup.wait()
            self._sched_wakeup.clear()
            try:
                self._schedule()
            except failpoints.FailpointError:
                # Injected crash mid-pass: the instance is tearing down
                # (a fresh one gets a fresh scheduler loop) — just stop
                # this pass cleanly.
                pass

    def _feasible_nodes(self, res: Dict[str, float]) -> List[NodeInfo]:
        want = res.get("GPU", 0.0)
        return [n for n in self.nodes.values()
                if n.schedulable() and _res_fits(n.avail, res)
                and _gpu_fits(n.gpu_free, want)]

    def _pick_node(self, record) -> Optional[NodeInfo]:
        """Hybrid policy: pack onto low-utilization nodes first, spill to
        spread past the 50% threshold (hybrid_scheduling_policy.h:50)."""
        if record.pg is not None:
            pg = self.pgs.get(PlacementGroupID(record.pg))
            if pg is None or pg.state != "ready":
                return None
            bix = record.bundle if record.bundle is not None else 0
            node_id = pg.placement[bix]
            node = self.nodes.get(node_id)
            # A DRAINING node dispatches nothing new, including work
            # targeting bundles already reserved there — it pends until
            # the drain resolves (deadline -> DEAD -> normal recovery).
            if node is None or not node.schedulable():
                return None
            if not _res_fits(pg.bundle_avail[bix], record.resources):
                return None
            if not _gpu_fits(pg.gpu_free[bix],
                             record.resources.get("GPU", 0.0)):
                return None
            return node
        strategy = record.strategy
        feasible = self._feasible_nodes(record.resources)
        if not feasible:
            return None
        if isinstance(strategy, dict) and strategy.get("type") == "node_affinity":
            target = NodeID(strategy["node_id"])
            for n in feasible:
                if n.node_id == target:
                    return n
            return None if not strategy.get("soft") else feasible[0]
        if strategy == "SPREAD":
            self._spread_rr += 1
            chosen = feasible[self._spread_rr % len(feasible)]
            logger.debug("SPREAD pick rr=%d of %d -> %s", self._spread_rr,
                         len(feasible), chosen.node_id.hex()[:8])
            return chosen
        # hybrid: first feasible node under 50% utilization in stable order,
        # else the least-utilized feasible node.
        feasible.sort(key=lambda n: n.node_id.binary())
        for n in feasible:
            if n.utilization() < 0.5:
                return n
        return min(feasible, key=lambda n: n.utilization())

    def _acquire(self, node: NodeInfo, record) -> Dict[str, float]:
        res = record.resources
        if record.pg is not None:
            pg = self.pgs[PlacementGroupID(record.pg)]
            bix = record.bundle if record.bundle is not None else 0
            _res_sub(pg.bundle_avail[bix], res)
        else:
            _res_sub(node.avail, res)
        return dict(res)

    def _assign_gpus(self, node: NodeInfo, worker: WorkerInfo, record):
        """Give ``worker`` the cards for the GPUs it just acquired, from
        its placement-group bundle's reserved cards or else the node's.
        ``_pick_node`` admitted the request only where they can be placed,
        so no share goes below 0. The worker sets ``CUDA_VISIBLE_DEVICES``
        to them before its first CUDA call."""
        want = float(worker.acquired.get("GPU", 0.0))
        if record.pg is not None:
            pg = self.pgs[PlacementGroupID(record.pg)]
            pool = pg.gpu_free[record.bundle if record.bundle is not None
                               else 0]
        else:
            pool = node.gpu_free
        taken = _gpu_take(pool, want)
        worker.gpu_ids = list(taken)
        worker.gpu_share = _gpu_share(want) if taken else 0.0
        worker.gpu_pool = pool if taken else None
        worker.gpu_pinned = worker.gpu_pinned or bool(taken)

    def _release_gpus(self, worker: WorkerInfo):
        for i in worker.gpu_ids:
            worker.gpu_pool[i] += worker.gpu_share
        worker.gpu_ids, worker.gpu_share, worker.gpu_pool = [], 0.0, None

    def _hold_reported_gpus(self, node: NodeInfo, worker: WorkerInfo,
                            record) -> None:
        """Take the cards a worker that survived a GCS restart reports out
        of the node's free shares, or its placement-group bundle's, as it
        re-charges the resources they came with. A bundle not placed again
        yet takes them when it is (``_place_bundles``)."""
        if not worker.gpu_reported or worker.gpu_ids or \
                worker.acquired.get("GPU", 0.0) <= 0:
            return
        if record is not None and record.pg is not None:
            pg = self.pgs.get(PlacementGroupID(record.pg))
            if pg is None or pg.state != "ready":
                return
            pool = pg.gpu_free[record.bundle if record.bundle is not None
                               else 0]
        else:
            pool = node.gpu_free
        self._take_reported_gpus(worker, pool)

    @staticmethod
    def _take_reported_gpus(worker: WorkerInfo, pool: Dict[str, float]):
        ids = [i for i in worker.gpu_reported if i in pool]
        share = _gpu_share(float(worker.acquired.get("GPU", 0.0)))
        for i in ids:
            pool[i] -= share
        worker.gpu_ids, worker.gpu_share = ids, share
        worker.gpu_pool = pool if ids else None

    def _bundle_holders(self, record: PGRecord) -> Dict[int, List[WorkerInfo]]:
        """Per bundle, the surviving actor workers of ``record`` that
        reported cards and hold none yet (a GCS restart's resync)."""
        out: Dict[int, List[WorkerInfo]] = {}
        pg_b = record.pg_id.binary()
        for w in self.workers.values():
            rec = self.actors.get(w.actor_id) if w.actor_id else None
            if (w.gpu_reported and not w.gpu_ids and w.acquired
                    and rec is not None and rec.pg is not None
                    and bytes(rec.pg) == pg_b):
                bix = rec.bundle if rec.bundle is not None else 0
                out.setdefault(bix, []).append(w)
        return out

    def _retire_gpu_worker(self, worker: WorkerInfo) -> bool:
        """A worker that was pinned to GPUs may hold a CUDA context for
        those cards, so it never takes other work: it exits (the
        reference's default of one call for GPU tasks)."""
        if not worker.gpu_pinned:
            return False
        self._release_gpus(worker)
        worker.state = W_DEAD
        if not worker.conn.closed:
            try:
                worker.conn.send({"t": "exit"})
            except ConnectionError:
                pass
        return True

    def _release(self, worker: WorkerInfo, record):
        if not worker.acquired:
            return
        self._release_gpus(worker)
        node = self.nodes.get(worker.node_id)
        if record is not None and record.pg is not None:
            pg = self.pgs.get(PlacementGroupID(record.pg))
            if pg is not None:
                bix = record.bundle if record.bundle is not None else 0
                _res_add(pg.bundle_avail[bix], worker.acquired)
        elif node is not None:
            _res_add(node.avail, worker.acquired)
        worker.acquired = {}

    def _schedule(self):
        """One scheduling pass: O(dispatched + distinct scheduling classes).

        Classes are served round-robin, one dispatch per class per cycle
        (no class can starve another); a class that blocks (no feasible
        node, or no idle worker) is skipped wholesale for the rest of the
        pass — its per-task state never needs re-examination.
        """
        # Deferred placement groups first: resources freed by the wake
        # that triggered this pass can satisfy a pending group NOW
        # instead of after a 50-100ms backstop poll timer — timer
        # quantization was the dominant term in many_pgs create-rate
        # variance. The create-time timers stay as a backstop only.
        if self._pending_pgs:
            for pg_id in list(self._pending_pgs):
                record = self.pgs.get(pg_id)
                if record is None or record.state != "pending":
                    self._pending_pgs.discard(pg_id)
                    continue
                self._retry_pg(record, reschedule=False)
        # Parked actors next: dedicated workers, and idle workers freed
        # by finished tasks should prefer waiting actors (FIFO by park
        # order) before new task dispatch claims them.
        self._place_parked_actors()
        deficit: Dict[tuple, tuple] = {}  # (node, env) -> (count, spec)
        qs = self.pending.qs
        active = list(qs.keys())
        while active:
            still_active = []
            for sig in active:
                q = qs.get(sig)
                while q:
                    record = q[0]
                    if record.cancelled or (
                            isinstance(record, LeaseDemand)
                            and record.client.conn.closed):
                        q.popleft()
                        self.pending.count -= 1
                        if not isinstance(record, LeaseDemand):
                            self._finish_cancelled(record)
                        continue
                    break
                if not q:
                    qs.pop(sig, None)
                    continue
                if isinstance(record, LeaseDemand) and self._tenant_quotas:
                    # Quota at lease grant: an impossible demand fails
                    # cleanly NOW (lease_void -> the driver errors its
                    # queued tasks); a transiently-over tenant just waits
                    # for its own releases, like any resource shortage.
                    ns = record.tenant
                    if self._quota_never_fits(ns, record.resources):
                        q.popleft()
                        self.pending.count -= 1
                        if not q:
                            qs.pop(sig, None)
                        record.cancelled = True
                        self.counters["quota_rejections"] += 1
                        if not record.client.conn.closed:
                            try:
                                record.client.conn.send({
                                    "t": "lease_void", "key": record.key,
                                    "err": f"resource quota exceeded for "
                                           f"namespace {ns!r}: request "
                                           f"{record.resources} over cap "
                                           f"{self._tenant_quotas[ns]}"})
                            except ConnectionError:
                                pass
                        continue
                    if not self._quota_fits_now(ns, record.resources):
                        continue  # tenant at cap: waits for its releases
                node = self._pick_node(record)
                if node is None:
                    continue  # class infeasible this pass
                env_key = getattr(record, "env_key", "")
                worker = self._grab_idle_worker(node, env_key)
                if worker is None:
                    pend = (record.count if isinstance(record, LeaseDemand)
                            else len(q))
                    dkey = (node.node_id, env_key)
                    cnt, _ = deficit.get(dkey, (0, None))
                    deficit[dkey] = (cnt + pend,
                                     getattr(record, "env_spec", None))
                    continue
                worker.state = W_BUSY
                worker.acquired = self._acquire(node, record)
                self._assign_gpus(node, worker, record)
                if isinstance(record, LeaseDemand):
                    worker.leased_to = record.client
                    worker.lease_ctx = record
                    self._tenant_acquire(record.tenant, record.resources)
                    plane_events.emit(
                        "lease.grant.worker", plane="lease",
                        tenant=record.tenant or "",
                        wid=worker.worker_id.hex()[:16],
                        node=node.node_id.hex()[:8])
                    grant = {
                        "t": "lease_grant", "key": record.key,
                        "wid": worker.worker_id.binary(),
                        "addr": worker.addr,
                        "nid": node.node_id.binary()}
                    if worker.gpu_ids:
                        grant["gpus"] = worker.gpu_ids
                    record.client.conn.send(grant)
                    record.count -= 1
                    if record.count <= 0:
                        q.popleft()
                        self.pending.count -= 1
                else:
                    q.popleft()
                    self.pending.count -= 1
                    worker.current_task = record.task_id
                    record.state = "running"
                    record.worker_id = worker.worker_id
                    record.node_id = node.node_id
                    record.ts_running = time.time()
                    fwd = dict(record.msg)
                    fwd["t"] = "exec"
                    fwd.pop("i", None)
                    if worker.gpu_ids:
                        fwd["gpus"] = worker.gpu_ids
                    worker.conn.send(fwd)
                if q:
                    still_active.append(sig)
                else:
                    qs.pop(sig, None)
            active = still_active
        for (node_id, env_key), (d, env_spec) in deficit.items():
            node = self.nodes.get(node_id)
            if node is not None:
                self._request_worker(node, demand=d, env_key=env_key,
                                     env_spec=env_spec)
        # Unconditional (cheap when idle: one scan over class heads):
        # keying this off the spawn `deficit` missed the central case — a
        # fully-acquired pool makes a late tenant's demand INFEASIBLE in
        # _pick_node (avail is zero), so it never reaches the deficit
        # branch at all, and the hoard would hold forever.
        self._rebalance_leases()

    def _rebalance_leases(self):
        """Weighted fair-share lease reclamation.

        Without this, worker leases are first-come-forever: a driver
        that saturates its leases never idles them out, so a tenant
        arriving later starves at ~zero throughput while the pool is
        hoarded (measured: 4 drivers on a 12-CPU pool, min/mean
        per-driver throughput 0.003). The reference sizes per-scheduling-
        class pools and relies on lease expiry; here the GCS reclaims
        explicitly: when a pending lease demand belongs to a client
        holding LESS than total/claimants leases, clients holding more
        than that share get graceful ``lease_revoked`` frames (in-flight
        pushes finish on the open connection — the node-drain semantics)
        until the starved demand can place. If nobody exceeds the share
        (pool smaller than claimant count), one lease rotates at most
        every 100ms so every tenant still makes progress."""
        starved: List[LeaseDemand] = []
        for q in self.pending.qs.values():
            head = q[0] if q else None
            if isinstance(head, LeaseDemand) and not head.cancelled \
                    and not head.client.conn.closed \
                    and self._rebalance_feasible(head):
                starved.append(head)
        if not starved:
            return
        holdings: Dict[int, List[WorkerInfo]] = {}
        owners: Dict[int, ClientConn] = {}
        for w in self.workers.values():
            if w.leased_to is not None and not w.conn.closed:
                holdings.setdefault(w.leased_to.serial, []).append(w)
                owners[w.leased_to.serial] = w.leased_to
        if not holdings:
            return
        total = sum(len(v) for v in holdings.values())
        claimants = {d.client.serial for d in starved} | set(holdings)
        share = max(1, total // len(claimants))
        hungry = [d for d in starved
                  if len(holdings.get(d.client.serial, ())) < share]
        if not hungry:
            return
        need = sum(min(d.count,
                       share - len(holdings.get(d.client.serial, ())))
                   for d in hungry)
        revoked = 0
        for serial, ws in sorted(holdings.items(),
                                 key=lambda kv: -len(kv[1])):
            if revoked >= need:
                break
            excess = len(ws) - share
            for w in ws[:max(0, excess)]:
                if revoked >= need:
                    break
                self._revoke_lease_for_rebalance(owners[serial], w)
                revoked += 1
                if failpoints.active():
                    # Crash mid-rebalance: some leases are revoked (and
                    # their lease_revoked frames may or may not have hit
                    # the wire), the rest still hoarded. Recovery: lessees
                    # re-claim what they still hold (lease_claim resync)
                    # and the fresh instance rebalances from scratch.
                    self._fp("gcs.rebalance.mid")
        if revoked == 0 and all(
                not holdings.get(d.client.serial) for d in hungry):
            # Pool smaller than the claimant count: nobody exceeds the
            # share, yet some tenants hold NOTHING. Rotate one lease on a
            # 100ms clock so capacity time-slices across tenants instead
            # of pinning to whoever connected first.
            now = time.time()
            if now - getattr(self, "_last_lease_rotation", 0.0) >= 0.1:
                self._last_lease_rotation = now
                serial, ws = max(holdings.items(),
                                 key=lambda kv: len(kv[1]))
                self._revoke_lease_for_rebalance(owners[serial], ws[0])
                revoked = 1
        if revoked:
            plane_events.emit("lease.rebalance.revoke", plane="lease",
                              revoked=revoked, share=share,
                              claimants=len(claimants))
            logger.debug("lease rebalance: revoked %d (share %d, "
                         "claimants %d)", revoked, share, len(claimants))
            self._wake_scheduler()

    def _rebalance_feasible(self, demand: LeaseDemand) -> bool:
        """Only demands that could EVER place may trigger reclamation: a
        demand for resources no node owns (or a non-ready PG bundle)
        would otherwise revoke healthy tenants' leases every pass and
        re-grant them right back — perpetual churn that helps nobody.
        Checked against node TOTALS, not avail (a saturated pool is
        exactly the case rebalancing exists for)."""
        if demand.pg is not None:
            pg = self.pgs.get(PlacementGroupID(demand.pg))
            return pg is not None and pg.state == "ready"
        return any(n.schedulable() and _res_fits(n.total, demand.resources)
                   for n in self.nodes.values())

    def _revoke_lease_for_rebalance(self, owner: ClientConn,
                                    worker: WorkerInfo):
        # Immediate release + graceful notify, the node-drain semantics.
        # The worker may still be finishing the old tenant's in-flight
        # pushes when the next grant lands — a TRANSIENT overlap bounded
        # by that lease's pipeline window (tasks serialize through the
        # worker's queue; the new tenant's first tasks queue behind the
        # remainder). The hold-until-confirmed alternative was measured
        # and rejected: waiting for lessee lease_ret confirmations
        # stalled further rebalancing behind slow confirms — 4-driver
        # aggregate fell 30.8k -> 25k tasks/s and min/mean collapsed
        # 0.987 -> 0.14. Bounded overlap is the better trade.
        self._release_lease(worker)
        if not owner.conn.closed:
            try:
                owner.conn.send({"t": "lease_revoked",
                                 "wid": worker.worker_id.binary()})
            except ConnectionError:
                pass

    def _grab_idle_worker(self, node: NodeInfo,
                          env_key: str = "") -> Optional[WorkerInfo]:
        # Per-env worker pools (reference: per-runtime-env pools in
        # worker_pool.h:174): a base task never lands in a venv worker and
        # vice versa. Non-matching workers rotate back into the deque.
        for _ in range(len(node.idle_workers)):
            wid = node.idle_workers.popleft()
            w = self.workers.get(wid)
            if w is None or w.state != W_IDLE or w.conn.closed:
                continue
            if w.env_key != env_key:
                node.idle_workers.append(wid)
                continue
            return w
        return None

    def _request_worker(self, node: NodeInfo, demand: int = 1,
                        env_key: str = "", env_spec=None,
                        dedicated: int = 0):
        """Ask the node agent to spawn workers to cover ``demand`` waiting
        consumers.

        Pool-size policy (reference: ``raylet/worker_pool.h:174`` prestart +
        on-demand growth): actor workers are dedicated and don't count
        against the pool cap; the cap bounds task workers at CPU total plus
        headroom, while ``dedicated`` (actors waiting for a worker of this
        class) raises it — an actor launch storm must not be throttled to
        the CPU count. ``node.spawning`` tracks in-flight spawns so repeated
        scheduling passes never stampede the host with interpreter startups.
        """
        if node.draining:
            # No new worker processes on a node that is being vacated.
            return
        actor_workers = sum(
            1 for wid in node.workers
            if (w := self.workers.get(wid)) is not None and w.state == W_ACTOR)
        cap = (max(int(node.total.get("CPU", 1)), 1) + 2 + actor_workers
               + dedicated)
        if node.agent_conn is None or node.agent_conn.closed:
            return
        spawn_msg: Dict[str, Any] = {"t": "spawn_worker"}
        if env_spec is not None:
            spawn_msg["env_spec"] = env_spec
            spawn_msg["env_key"] = env_key
        inflight_cap = _cfg().max_inflight_spawns
        while (node.spawning < min(demand, inflight_cap)
               and len(node.workers) + node.spawning < cap):
            node.spawning += 1
            node.spawn_ts = time.time()
            node.agent_conn.send(spawn_msg)

    async def _h_task_done(self, client, msg):
        tid = TaskID(msg["tid"])
        record = self.tasks.get(tid)
        worker = self.workers.get(client.worker_id) if client.worker_id else None
        if worker is not None:
            self._release(worker, record)
            worker.current_task = None
            if self._retire_gpu_worker(worker):
                pass
            elif worker.state == W_BUSY:
                worker.state = W_IDLE
                node = self.nodes.get(worker.node_id)
                if node is not None:
                    node.idle_workers.append(worker.worker_id)
        if record is None:
            self._wake_scheduler()
            return
        record.state = "done"
        record.ts_done = time.time()
        record.error = bool(msg.get("err"))
        self.counters["tasks_finished"] += 1
        if record.error:
            self.counters["tasks_failed"] += 1
        self._gc_done_task(record)
        for r in msg["results"]:
            entry = self._obj(ObjectID(r["oid"]))
            if client.node_id is not None and r.get("shm"):
                entry.holders.add(client.node_id.binary())
            self._mark_ready(entry, r["nbytes"], r.get("data"),
                             r.get("shm", False))
        if record.owner.conn is not None and not record.owner.conn.closed:
            record.owner.conn.send({"t": "task_done", "tid": msg["tid"],
                                    "results": msg["results"]})
        self._wake_scheduler()

    def _finish_cancelled(self, record: TaskRecord):
        from . import serialization

        record.state = "done"
        record.ts_done = time.time()
        record.error = True
        self._gc_done_task(record)
        err = serialization.serialize(
            serialization.TaskCancelledError(record.task_id.hex())).to_bytes()
        results = [{"oid": oid.binary(), "nbytes": len(err), "data": err}
                   for oid in record.returns]
        for r in results:
            self._mark_ready(self._obj(ObjectID(r["oid"])), r["nbytes"],
                             r["data"], False)
        if not record.owner.conn.closed:
            record.owner.conn.send({"t": "task_done",
                                    "tid": record.task_id.binary(),
                                    "results": results})

    async def _on_worker_death(self, worker_id: WorkerID):
        worker = self.workers.pop(worker_id, None)
        if worker is None:
            return
        node = self.nodes.get(worker.node_id)
        if node is not None:
            node.workers.discard(worker_id)
            try:
                node.idle_workers.remove(worker_id)
            except ValueError:
                pass
        # Leases the dead worker held for its own nested submissions (a
        # train worker streaming its dataset shard) die with it, as an
        # exiting driver's do (``_on_driver_exit``): its idle-return timer
        # died with the process.
        held = [w for w in self.workers.values()
                if w.leased_to is not None
                and w.leased_to.worker_id == worker_id]
        for w in held:
            self._release_lease(w)
        if held:
            self._wake_scheduler()
        # Actor death
        if worker.actor_id is not None:
            await self._on_actor_worker_death(worker.actor_id, worker)
            return
        # Leased worker death: release the grant and tell the owner — the
        # owner-side TaskManager handles retries of its in-flight tasks.
        if worker.leased_to is not None:
            owner = worker.leased_to
            self._release_lease(worker)
            if not owner.conn.closed:
                owner.conn.send({"t": "lease_dead",
                                 "wid": worker_id.binary()})
            self._wake_scheduler()
            return
        # Task retry (reference: TaskManager retries, task_manager.h:210)
        tid = worker.current_task
        if tid is None:
            return
        record = self.tasks.get(tid)
        if record is None:
            return
        self._release(worker, record)
        if record.cancelled:
            self._finish_cancelled(record)
        elif record.retries_left > 0:
            record.retries_left -= 1
            record.state = "pending"
            record.worker_id = None
            self.counters["tasks_retried"] += 1
            logger.info("retrying task %s (%d retries left)",
                        tid.hex()[:8], record.retries_left)
            self.pending.append(record)
        else:
            from . import serialization

            err = serialization.serialize(serialization.WorkerCrashedError(
                f"worker {worker_id.hex()[:8]} died while executing task"
            )).to_bytes()
            results = [{"oid": oid.binary(), "nbytes": len(err), "data": err}
                       for oid in record.returns]
            for r in results:
                self._mark_ready(self._obj(ObjectID(r["oid"])), r["nbytes"],
                                 r["data"], False)
            record.state = "done"
            record.ts_done = time.time()
            record.error = True
            self.counters["tasks_failed"] += 1
            self._gc_done_task(record)
            if not record.owner.conn.closed:
                record.owner.conn.send({"t": "task_done", "tid": tid.binary(),
                                        "results": results})
        self._wake_scheduler()

    # ------------------------------------------------------- graceful drain

    async def _h_drain_node(self, client, msg):
        """Begin a graceful drain of a node (reference: ``DrainNode``,
        autoscaler.proto): no new placements from this moment, restartable
        actors are proactively migrated, in-flight tasks get until the
        deadline, then the node is forced DEAD with normal recovery.

        Callers: the node agent self-reporting a preemption notice, the
        autoscaler vacating an idle node before terminating it, and
        operators via ``ray_tpu_torch.drain_node``."""
        node = self.nodes.get(NodeID(msg["node_id"]))
        if node is None or not node.alive:
            if msg.get("i") is not None:
                client.conn.reply(msg, {"ok": False,
                                        "err": "no such live node"})
            return
        raw_deadline = msg.get("deadline_s")
        # `is not None`, not `or`: an explicit deadline_s=0 means "drain
        # immediately", not "use the default".
        deadline_s = (float(raw_deadline) if raw_deadline is not None
                      else _cfg().drain_deadline_s)
        reason = str(msg.get("reason") or "unspecified")
        deadline = time.time() + max(0.0, deadline_s)
        if node.draining:
            # Repeated notices (agent poll, autoscaler rounds): keep the
            # EARLIEST deadline — a drain can only get more urgent.
            if deadline < node.drain_deadline:
                node.drain_deadline = deadline
                if node.drain_timer is not None:
                    node.drain_timer.cancel()
                node.drain_timer = asyncio.get_running_loop().call_later(
                    max(0.0, deadline - time.time()),
                    self._drain_deadline_expired, node.node_id)
        else:
            node.draining = True
            node.drain_reason = reason
            node.drain_deadline = deadline
            self.counters["nodes_drained"] += 1
            logger.info("draining node %s (%s, deadline in %.1fs)",
                        node.node_id.hex()[:8], reason, deadline_s)
            self._pub("node_events", {"event": "node_draining",
                                      "node_id": node.node_id.hex(),
                                      "reason": reason,
                                      "deadline": deadline,
                                      "hostname": node.hostname})
            node.drain_timer = asyncio.get_running_loop().call_later(
                max(0.0, deadline_s), self._drain_deadline_expired,
                node.node_id)
            # Pull-connection hygiene: tell every client to retire cached
            # peer connections to this node (they re-dial if the draining
            # node is still the only holder of something they need).
            self._push_node_addrs_gone(node)
            # Gang advisory: members on this node are on notice — push
            # before the migration/revocation churn below so trainers see
            # the drain as a cooperative checkpoint boundary first.
            self._gang_node_draining(node, reason, deadline)
            # Proactive migration: every restartable actor on the node is
            # restarted elsewhere NOW (while its state can still be
            # rebuilt under controlled conditions) instead of dying with
            # the hardware at the deadline.
            for record in list(self.actors.values()):
                if (record.node_id == node.node_id
                        and record.state == A_ALIVE
                        and record.max_restarts != 0):
                    self._migrate_actor(record)
            # Revoke worker leases on the node: the direct path pushes
            # tasks straight to leased workers, bypassing the scheduler —
            # without revocation a lease-holding driver would keep
            # placing NEW work here. Revocation is graceful (the driver
            # keeps the worker connection open until in-flight pushes
            # finish) and the re-requested leases land elsewhere.
            for w in list(self.workers.values()):
                if w.node_id != node.node_id or w.leased_to is None:
                    continue
                owner = w.leased_to
                self._release_lease(w)
                if not owner.conn.closed:
                    try:
                        owner.conn.send({"t": "lease_revoked",
                                         "wid": w.worker_id.binary()})
                    except ConnectionError:
                        pass
        # Re-run scheduling: pending work parked on this node must move.
        self._wake_scheduler()
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True,
                                    "deadline": node.drain_deadline})

    def _migrate_actor(self, record: ActorRecord):
        """Move a restartable actor off its (draining) node: retire the
        worker; the death path sees ``migrating`` and restarts the actor
        through normal placement — which now excludes the draining node —
        without consuming the restart budget (infrastructure loss, not an
        actor crash)."""
        record.migrating = True
        worker = (self.workers.get(record.worker_id)
                  if record.worker_id else None)
        if worker is not None and not worker.conn.closed:
            logger.info("migrating actor %s off draining node %s",
                        record.actor_id.hex()[:8],
                        record.node_id.hex()[:8] if record.node_id else "?")
            try:
                worker.conn.send({"t": "exit"})
                return
            except ConnectionError:
                pass
        # No live worker link: treat as already gone and re-place now.
        record.migrating = False
        record.state = A_RESTARTING
        record.worker_id = None
        record.addr = None
        self._try_place_actor(record)

    def _drain_deadline_expired(self, node_id: NodeID):
        node = self.nodes.get(node_id)
        if node is None or not node.alive or not node.draining:
            return
        logger.warning("drain deadline expired for node %s (%s): forcing "
                       "DEAD", node_id.hex()[:8], node.drain_reason)
        self._pub("node_events", {"event": "drain_deadline_expired",
                                  "node_id": node_id.hex(),
                                  "reason": node.drain_reason})
        # Retire the agent (and with it the node's worker processes); the
        # death transition below runs the normal recovery paths for
        # whatever was still in flight.
        if node.agent_conn is not None and not node.agent_conn.closed:
            try:
                node.agent_conn.send({"t": "exit"})
            except ConnectionError:
                pass
        self._on_node_death(node_id)

    def _on_node_death(self, node_id: NodeID):
        node = self.nodes.get(node_id)
        if node is None:
            return
        node.alive = False
        if node.drain_timer is not None:
            node.drain_timer.cancel()
            node.drain_timer = None
        self._pub("node_events", {"event": "node_died",
                                  "node_id": node_id.hex(),
                                  "hostname": node.hostname,
                                  "was_draining": node.draining})
        self._push_node_addrs_gone(node)
        for wid in list(node.workers):
            asyncio.get_running_loop().create_task(self._on_worker_death(wid))

    def _push_node_addrs_gone(self, node):
        """Broadcast a node's serve addresses to every connected client on
        DEAD/DRAINING so cached pull connections are evicted (node death
        is rare — the fan-out is cheap relative to leaking sockets)."""
        addrs = [a for a in (node.obj_addr,) if a]
        for wid in list(node.workers):
            w = self.workers.get(wid)
            if w is not None and w.obj_addr:
                addrs.append(w.obj_addr)
        if not addrs:
            return
        out = {"t": "node_addrs_gone", "addrs": addrs,
               "node_id": node.node_id.hex()}
        for c in self.clients:
            if not c.conn.closed:
                try:
                    c.conn.send(out)
                except ConnectionError:
                    pass

    def _driver_exit_after_grace(self, wid_b: bytes, client: ClientConn):
        self._driver_exit_graces.pop(wid_b, None)
        self._on_driver_exit(client)

    def _on_driver_exit(self, client: ClientConn):
        """Non-detached actors owned by an exiting driver are killed; its
        objects are dereferenced; its worker leases are reclaimed."""
        # Gangs registered by this driver die with it (members are its
        # non-detached actors anyway): retire the records so a crashed
        # driver never leaks a DEGRADED gang into the directory forever.
        for record in [g for g in self.gangs.values()
                       if g.owner is client]:
            self._retire_gang(record)
        for worker in self.workers.values():
            if worker.leased_to is client:
                self._release_lease(worker)
        self._wake_scheduler()
        for actor in list(self.actors.values()):
            if actor.owner is client and not actor.detached:
                asyncio.get_running_loop().create_task(
                    self._kill_actor(actor, no_restart=True,
                                     cause="owner driver exited"))
        for oid in self._owned_objects.pop(self._owner_key(client), set()):
            entry = self.objects.get(oid)
            if entry is not None:
                entry.refcount -= 1
                if entry.refcount <= 0 and entry.ready:
                    self._lru_touch(entry)

    # --------------------------------------------------------------- actors

    async def _h_actor_create(self, client, msg):
        aid = ActorID(msg["aid"])
        existing = self.actors.get(aid)
        if existing is not None:
            # Idempotent retry: the owner re-sends the SAME creation msg
            # (same client-generated aid) when a GCS crash ate its reply
            # — the record may be freshly created (crash pre-reply) or
            # WAL-replayed (crash post-append). Re-link the owner (a
            # restored record has none; a pre-retry record may hold the
            # DEAD connection the original request arrived on) and
            # acknowledge; a second record would double-place the actor,
            # and the named-actor check below would misreport the retry
            # as a name collision.
            if existing.owner is None or existing.owner.conn.closed:
                existing.owner = client
            client.conn.reply(msg, {"ok": True})
            if (existing.state == A_PENDING
                    and existing.worker_id is None
                    and not existing.restored
                    and existing.actor_id not in self._actor_pending_place):
                # The original handler unwound between record creation
                # and placement (its reply raised on a just-closed
                # connection): without this the retry acks an actor that
                # is never scheduled. Restored records are excluded —
                # adoption/restart owns their placement.
                self._try_place_actor(existing)
            return
        opts = msg.get("opts")
        if opts is None:
            opts = msg["opts"] = {}
        tenant = self._client_tenant(client)
        if opts.get("namespace") is None and tenant != "default":
            # Actors live in their creating TENANT's namespace unless one
            # was named explicitly (set on the msg so the WAL record and
            # a restored instance agree). Resolved through the lease /
            # actor chain: nested creation from inside a task must land
            # in the owning tenant's namespace, not the worker
            # connection's 'default'.
            opts["namespace"] = tenant
        record = ActorRecord(aid, msg, client)
        if record.name is not None:
            key = (record.namespace, record.name)
            if key in self.named_actors:
                client.conn.reply(msg, {
                    "ok": False,
                    "err": f"actor name {record.name!r} already taken"})
                return
            self.named_actors[key] = aid
        self.actors[aid] = record
        self.counters["actors_created"] += 1
        wal_msg = {k: v for k, v in msg.items() if k != "i"}
        if client.worker_id is not None:
            wal_msg["owner_wid"] = client.worker_id.binary()
            # On the record too: snapshot compaction serializes records,
            # and owner re-linking after a restart matches by owner_wid.
            record.owner_wid = client.worker_id.binary()
        self._log_append("actor", wal_msg)
        client.conn.reply(msg, {"ok": True})
        self._try_place_actor(record)

    def _actor_pick_node(self, record: ActorRecord) -> Optional[NodeInfo]:
        fake_task = type("T", (), {})()
        fake_task.pg = record.pg
        fake_task.bundle = record.bundle
        fake_task.resources = record.resources
        fake_task.strategy = (record.msg.get("opts") or {}).get("sched") or "DEFAULT"
        return self._pick_node(fake_task)

    def _try_place_actor(self, record: ActorRecord):
        self._actor_pending_place.pop(record.actor_id, None)
        node = self._actor_pick_node(record)
        if node is None:
            # Infeasible right now (node down / PG not ready): poll until a
            # node qualifies — feasibility changes aren't all worker events.
            asyncio.get_running_loop().call_later(
                0.05, self._retry_place_actor, record)
            return
        worker = self._grab_idle_worker(node, record.env_key)
        if worker is None:
            # Feasible but no idle worker: park — the worker-hello wake
            # drains parked actors, and the scheduler pass batches one
            # spawn request for the aggregate parked demand. The picked
            # node is remembered so later passes with zero idle workers
            # can aggregate demand without re-running placement per
            # parked actor per wake (O(parked^2) across a launch storm).
            record.park_node = node.node_id
            self._actor_pending_place[record.actor_id] = record
            self._wake_scheduler()
            return
        self._bind_actor_worker(record, node, worker)

    def _bind_actor_worker(self, record: ActorRecord, node: NodeInfo,
                           worker: WorkerInfo):
        worker.state = W_ACTOR
        worker.actor_id = record.actor_id
        worker.acquired = self._acquire(node, record)
        self._assign_gpus(node, worker, record)
        record.worker_id = worker.worker_id
        record.node_id = node.node_id
        fwd = dict(record.msg)
        fwd["t"] = "actor_init"
        fwd.pop("i", None)
        if worker.gpu_ids:
            fwd["gpus"] = worker.gpu_ids
        worker.conn.send(fwd)

    def _retry_place_actor(self, record: ActorRecord):
        if (record.state in (A_PENDING, A_RESTARTING)
                and record.actor_id not in self._actor_pending_place):
            self._try_place_actor(record)

    def _place_parked_actors(self):
        """Drain actors parked for an idle worker; batch spawn requests for
        whatever stays parked (one request per (node, env) with the full
        waiting count, not one per actor per retry tick).

        Placement (``_actor_pick_node``) only runs while idle workers
        remain claimable; once the pool is dry the rest of the queue is
        aggregated by its remembered park node — a launch storm of N
        actors costs O(N) per pass, not O(N) placements per wake."""
        if not self._actor_pending_place:
            return
        demand: Dict[tuple, tuple] = {}  # (node_id, env_key) -> (n, spec)
        idle_left = sum(len(n.idle_workers) for n in self.nodes.values()
                        if n.schedulable())
        for record in list(self._actor_pending_place.values()):
            if record.state not in (A_PENDING, A_RESTARTING):
                self._actor_pending_place.pop(record.actor_id, None)
                continue
            if idle_left <= 0:
                park_id = getattr(record, "park_node", None)
                node = self.nodes.get(park_id) if park_id else None
                if node is not None and node.schedulable():
                    key = (node.node_id, record.env_key)
                    cnt, _ = demand.get(key, (0, None))
                    demand[key] = (cnt + 1, record.env_spec)
                    continue
                # Park node gone: fall through to a real placement pass.
            node = self._actor_pick_node(record)
            if node is None:
                # Became infeasible while parked: fall back to the poll.
                self._actor_pending_place.pop(record.actor_id, None)
                asyncio.get_running_loop().call_later(
                    0.05, self._retry_place_actor, record)
                continue
            record.park_node = node.node_id
            worker = self._grab_idle_worker(node, record.env_key)
            if worker is None:
                key = (node.node_id, record.env_key)
                cnt, _ = demand.get(key, (0, None))
                demand[key] = (cnt + 1, record.env_spec)
                continue
            idle_left -= 1
            self._actor_pending_place.pop(record.actor_id, None)
            self._bind_actor_worker(record, node, worker)
        for (node_id, env_key), (n, env_spec) in demand.items():
            node = self.nodes.get(node_id)
            if node is not None:
                self._request_worker(node, demand=n, env_key=env_key,
                                     env_spec=env_spec, dedicated=n)

    async def _h_actor_ready(self, client, msg):
        aid = ActorID(msg["aid"])
        record = self.actors.get(aid)
        if record is None:
            return
        worker = self.workers.get(record.worker_id)
        record.state = A_ALIVE
        record.addr = worker.addr if worker else ""
        self._pub_actor(record, "alive")
        for conn, req in record.addr_waiters:
            if not conn.closed:
                conn.reply(req, {"ok": True, "state": A_ALIVE,
                                 "addr": record.addr})
        record.addr_waiters.clear()

    async def _h_actor_init_err(self, client, msg):
        aid = ActorID(msg["aid"])
        record = self.actors.get(aid)
        if record is None:
            return
        record.state = A_DEAD
        record.death_cause = "creation task failed"
        record.msg_error = msg.get("err")
        self._log_append("actord", record.actor_id.binary())
        for conn, req in record.addr_waiters:
            if not conn.closed:
                conn.reply(req, {"ok": False, "state": A_DEAD,
                                 "err": msg.get("err")})
        record.addr_waiters.clear()
        # free the worker back to the pool
        worker = self.workers.get(record.worker_id)
        if worker is not None:
            self._release(worker, record)
            worker.actor_id = None
            worker.state = W_IDLE
            node = self.nodes.get(worker.node_id)
            if node is not None:
                node.idle_workers.append(worker.worker_id)

    async def _h_actor_get(self, client, msg):
        """Resolve actor id -> direct-call address (waits while pending)."""
        aid = ActorID(msg["aid"])
        record = self.actors.get(aid)
        if record is None:
            client.conn.reply(msg, {"ok": False, "state": A_DEAD,
                                    "err": "no such actor"})
            return
        if record.state == A_ALIVE:
            client.conn.reply(msg, {"ok": True, "state": A_ALIVE,
                                    "addr": record.addr})
        elif record.state == A_DEAD:
            client.conn.reply(msg, {"ok": False, "state": A_DEAD,
                                    "err": record.death_cause or "actor died"})
        else:
            record.addr_waiters.append((client.conn, msg))

    async def _h_actor_by_name(self, client, msg):
        tenant = self._client_tenant(client)
        ns = msg.get("namespace") or tenant
        if self._isolation_refused(client, tenant, ns):
            client.conn.reply(msg, {
                "ok": False,
                "err": f"namespace isolation: caller in namespace "
                       f"{tenant!r} cannot resolve actors in {ns!r}"})
            return
        key = (ns, msg["name"])
        aid = self.named_actors.get(key)
        if aid is None:
            client.conn.reply(msg, {"ok": False,
                                    "err": f"no actor named {msg['name']!r}"})
        else:
            client.conn.reply(msg, {"ok": True, "aid": aid.binary()})

    async def _h_actor_kill(self, client, msg):
        record = self.actors.get(ActorID(msg["aid"]))
        if record is None:
            return
        tenant = self._client_tenant(client)
        if self._isolation_refused(client, tenant, record.namespace):
            # kill is fire-and-forget (no reply to carry the refusal):
            # surface it on the error channel so the silent no-op is at
            # least observable, and log server-side.
            logger.warning(
                "namespace isolation: refusing kill of actor %s (ns %r) "
                "from tenant %r", record.actor_id.hex()[:8],
                record.namespace, tenant)
            self._pub("error", {
                "event": "isolation_refused_kill",
                "actor_id": record.actor_id.hex(),
                "actor_namespace": record.namespace,
                "caller_namespace": tenant})
            return
        await self._kill_actor(record, msg.get("no_restart", True),
                               cause="killed via ray.kill")

    @staticmethod
    def _isolation_refused(client: ClientConn, tenant: str,
                           ns: str) -> bool:
        """Namespace isolation policy: drivers are always confined to
        their own namespace; workers are confined to the tenant they act
        for — except 'default'-tenant workers (system components: serve
        controllers, internal actors) which keep cross-namespace
        reach."""
        if not _cfg().tenant_isolation or ns == tenant:
            return False
        if client.role == "driver":
            return True
        return client.role == "worker" and tenant != "default"

    async def _kill_actor(self, record: ActorRecord, no_restart: bool,
                          cause: str):
        if no_restart:
            record.max_restarts = record.restarts_used
            # An explicit kill overrides an in-flight drain migration.
            record.migrating = False
        worker = self.workers.get(record.worker_id) if record.worker_id else None
        if worker is not None and not worker.conn.closed:
            worker.conn.send({"t": "exit"})
        else:
            record.state = A_DEAD
            record.death_cause = cause
            self._cleanup_dead_actor(record)

    async def _on_actor_worker_death(self, actor_id: ActorID,
                                     worker: WorkerInfo):
        record = self.actors.get(actor_id)
        if record is None:
            return
        # Gang membership loss fires on the DEATH event, before any
        # restart/migration decision: a member's collective state died
        # with the process either way, and survivors wedged inside a
        # collective need the push NOW, not after a restart round-trips.
        self._gang_member_lost(actor_id, "actor worker died")
        self._release(worker, record)
        # What the actor held may place pending work (a whole card freed
        # of its last share, say): run a pass for it.
        self._wake_scheduler()
        if record.migrating:
            # Orchestrated drain migration, not a crash: restart through
            # normal placement (draining nodes excluded) without touching
            # the restart budget.
            record.migrating = False
            self.counters["actors_migrated"] += 1
            record.state = A_RESTARTING
            record.worker_id = None
            record.addr = None
            logger.info("re-placing migrated actor %s", actor_id.hex()[:8])
            self._try_place_actor(record)
            return
        if (record.restarts_used < record.max_restarts
                or record.max_restarts < 0):
            record.restarts_used += 1
            self.counters["actors_restarted"] += 1
            record.state = A_RESTARTING
            record.worker_id = None
            record.addr = None
            logger.info("restarting actor %s (attempt %d)",
                        actor_id.hex()[:8], record.restarts_used)
            self._try_place_actor(record)
        else:
            record.state = A_DEAD
            record.death_cause = "actor worker died"
            self._cleanup_dead_actor(record)

    def _cleanup_dead_actor(self, record: ActorRecord):
        # Covers the death paths that never had a live worker (creation
        # failure, kill-while-pending); deduped by the gang record, so
        # the worker-death path firing first is fine.
        self._gang_member_lost(record.actor_id,
                               record.death_cause or "actor died")
        self._actor_pending_place.pop(record.actor_id, None)
        self._log_append("actord", record.actor_id.binary())
        self._pub_actor(record, "dead")
        for conn, req in record.addr_waiters:
            if not conn.closed:
                conn.reply(req, {"ok": False, "state": A_DEAD,
                                 "err": record.death_cause})
        record.addr_waiters.clear()
        if record.name is not None:
            self.named_actors.pop((record.namespace, record.name), None)
        # Notify all drivers so pending direct calls can fail fast.
        for d in self.drivers:
            if not d.conn.closed:
                d.conn.send({"t": "actor_dead",
                             "aid": record.actor_id.binary(),
                             "cause": record.death_cause or "actor died"})

    # ------------------------------------------------------ gang fault plane

    @staticmethod
    def _gang_channel(name: str) -> str:
        return f"gang:{name}"

    async def _h_gang_register(self, client, msg):
        """Register a gang's membership (rank-ordered actor ids) under a
        stable name; assigns the next strictly-monotonic generation for
        that name. One live record per name — a re-registration (elastic
        reshape) supersedes the previous record, whose generation can
        never complete another collective (stale-generation rejection is
        the coordinator's half of the contract)."""
        name = str(msg["name"])
        self._fp("gcs.gang.register", name)
        aids = [ActorID(a) for a in msg["members"]]
        gen = self.gang_gens.get(name, 0) + 1
        self.gang_gens[name] = gen
        self._log_append("gang", [name, gen])
        old = self.gangs.get(name)
        if old is not None:
            self._retire_gang(old)
        record = GangRecord(name, gen, aids, client)
        self.gangs[name] = record
        for aid in record.members.values():
            self._actor_gangs[aid] = name
        client.conn.reply(msg, {"ok": True, "generation": gen})
        # A member already dead AT registration (lost the formation race
        # with a kill) is an immediate membership loss: the push fires
        # right behind the reply, not at the first wedged collective.
        for rank, aid in list(record.members.items()):
            a = self.actors.get(aid)
            if a is None or a.state == A_DEAD:
                self._gang_member_lost(aid, "dead at gang registration")

    async def _h_gang_deregister(self, client, msg):
        """Retire a gang record (group shutdown / pre-reshape teardown).
        Generation-checked: a superseded group's late deregister must not
        tear down the re-formed gang."""
        name = str(msg["name"])
        gen = msg.get("generation")
        record = self.gangs.get(name)
        if record is None or (gen is not None
                              and record.generation != gen):
            if msg.get("i") is not None:
                client.conn.reply(msg, {"ok": True, "stale": True})
            return
        self._fp("gcs.gang.deregister", name)
        self._retire_gang(record)
        self._pub(self._gang_channel(name), {
            "event": "gang_closed", "gang": name,
            "generation": record.generation})
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True, "stale": False})

    async def _h_gang_info(self, client, msg):
        """Membership probe: the trainer's escalation path (collective
        timeout -> probe -> reshape) and tests read this instead of
        inferring membership from actor states."""
        name = str(msg["name"])
        record = self.gangs.get(name)
        if record is None:
            client.conn.reply(msg, {
                "ok": True, "registered": False,
                "generation": self.gang_gens.get(name, 0)})
            return
        client.conn.reply(msg, {
            "ok": True, "registered": True,
            "generation": record.generation, "status": record.status,
            "world": len(record.members),
            "lost": sorted(record.lost),
            "lost_causes": {str(r): c for r, c in record.lost.items()}})

    def _retire_gang(self, record: "GangRecord"):
        self.gangs.pop(record.name, None)
        for aid in record.members.values():
            if self._actor_gangs.get(aid) == record.name:
                self._actor_gangs.pop(aid, None)

    def _gang_member_lost(self, aid: ActorID, cause: str):
        """Membership-loss push: called from every actor-death path. A
        restartable member that comes back is still a LOSS — its
        collective/rendezvous state died with the process, so the gang
        must reshape regardless."""
        name = self._actor_gangs.get(aid)
        if name is None:
            return
        record = self.gangs.get(name)
        if record is None:
            return
        fresh = [r for r, a in record.members.items()
                 if a == aid and r not in record.lost]
        if not fresh:
            return
        for r in fresh:
            record.lost[r] = cause
        record.status = G_DEGRADED
        self._fp("gcs.gang.member_lost", name)
        logger.info("gang %r gen=%d lost rank(s) %s (%s)", name,
                    record.generation, fresh, cause)
        self._pub(self._gang_channel(name), {
            "event": "member_lost", "gang": name,
            "generation": record.generation,
            "ranks": sorted(fresh), "lost_ranks": sorted(record.lost),
            "world": len(record.members), "cause": cause})

    def _gang_node_draining(self, node, reason: str, deadline: float):
        """Drain advisory: members on a DRAINING node are about to be
        lost — push the notice so trainers/pipelines checkpoint at the
        next boundary and reshape cooperatively instead of discovering
        the loss at the drain deadline."""
        for record in self.gangs.values():
            ranks = []
            for r, aid in record.members.items():
                if r in record.lost:
                    continue
                a = self.actors.get(aid)
                if a is not None and a.node_id == node.node_id:
                    ranks.append(r)
            if ranks:
                self._pub(self._gang_channel(record.name), {
                    "event": "member_draining", "gang": record.name,
                    "generation": record.generation,
                    "ranks": sorted(ranks), "reason": reason,
                    "deadline": deadline})

    # ------------------------------------------------------ placement groups

    async def _h_pg_create(self, client, msg):
        pg_id = PlacementGroupID(msg["pgid"])
        record = PGRecord(pg_id, msg["bundles"], msg["strategy"],
                          msg.get("name", ""), client)
        record.tenant = self._client_tenant(client)
        if self._tenant_quotas:
            need = self._merge_res(record.bundles)
            if self._quota_never_fits(record.tenant, need):
                # The group can never reserve within its namespace cap:
                # clean error reply, nothing registered, nothing pending.
                self.counters["quota_rejections"] += 1
                client.conn.reply(msg, {
                    "ok": False, "ready": False,
                    "err": f"resource quota exceeded for namespace "
                           f"{record.tenant!r}: bundles need {need} over "
                           f"cap {self._tenant_quotas[record.tenant]}"})
                return
        self.pgs[pg_id] = record
        ph = self.pg_phases
        t0 = time.perf_counter()
        self._log_append("pg", {"pgid": pg_id.binary(),
                                "bundles": record.bundles,
                                "strategy": record.strategy,
                                "name": record.name,
                                "tenant": record.tenant})
        ph["wal_s"] += time.perf_counter() - t0
        placed = self._place_bundles(record)
        if placed:
            record.state = "ready"
            t1 = time.perf_counter()
            client.conn.reply(msg, {"ok": True, "ready": True})
            ph["reply_s"] += time.perf_counter() - t1
            ph["n"] += 1
        else:
            ph["deferred"] += 1
            record.ready_waiters.append((client.conn, msg))
            self._pending_pgs.add(pg_id)
            asyncio.get_running_loop().call_later(0.05, self._retry_pg, record)
            self._nudge_idle_leases()

    # Senders live in benchmarks/scale_bench.py (PG-phase instrumentation).
    async def _h_pg_stats(self, client, msg):  # raylint: disable=RTL122
        """Cumulative PG-creation phase timings (the many_pgs variance
        root-causing surface): per-phase seconds, placement counts, and
        retry pressure since boot."""
        client.conn.reply(msg, {"ok": True, "phases": dict(self.pg_phases)})

    def _retry_pg(self, record: PGRecord, reschedule: bool = True):
        """Retry a deferred placement. ``reschedule=False`` is the
        event-driven path (scheduler pass on resource release): it must
        not plant new timers — the create-time backstop timer is enough."""
        if record.state != "pending":
            self._pending_pgs.discard(record.pg_id)
            return
        self.pg_phases["retries"] += 1
        if self._place_bundles(record):
            record.state = "ready"
            self._pending_pgs.discard(record.pg_id)
            ph = self.pg_phases
            t0 = time.perf_counter()
            for conn, req in record.ready_waiters:
                if not conn.closed:
                    conn.reply(req, {"ok": True, "ready": True})
            record.ready_waiters.clear()
            # Deferred-then-placed creates count toward n/reply_s too —
            # otherwise a loaded host where most creates defer reports
            # n~0 while reserve_s keeps accumulating (every failed
            # retry's staging scan lands there), and per-create phase
            # attribution (the whole point of pg_stats) turns nonsense.
            ph["reply_s"] += time.perf_counter() - t0
            ph["n"] += 1
            self._wake_scheduler()
        elif reschedule:
            asyncio.get_running_loop().call_later(0.1, self._retry_pg, record)
            # Leases that went idle AFTER the create deferred (their
            # last task finished since) are invisible here until the
            # lessee's idle-return timer fires; re-nudge on each timer
            # retry so a pending group never waits out that full hold.
            self._nudge_idle_leases()

    def _nudge_idle_leases(self):
        """Placement demand is blocked while drivers may be sitting on
        warm-but-idle leased workers (each pinning its acquired
        resources for up to ``lease_idle_return_s``): ask every lessee
        to return leases that are idle RIGHT NOW. Only the lessee knows
        which leases are idle (in-flight pushes never route through the
        GCS), so this is a cooperative nudge, not a revocation — busy
        leases and classes with queued work are untouched. The returns
        arrive as normal ``lease_ret`` frames -> ``_wake_scheduler`` ->
        the event-driven pending-PG pass."""
        owners = {}
        for w in self.workers.values():
            if w.leased_to is not None and not w.leased_to.conn.closed:
                owners[w.leased_to.serial] = w.leased_to
        for owner in owners.values():
            try:
                owner.conn.send({"t": "lease_nudge"})
            except ConnectionError:
                pass

    def _place_bundles(self, record: PGRecord) -> bool:
        """Reserve every bundle or nothing (all-or-nothing like the
        reference's 2PC prepare/commit, node_manager.h:507-512 — centralized
        here so a plain transactional update suffices)."""
        strategy = record.strategy
        t0 = time.perf_counter()
        if self._tenant_quotas and not record.quota_charged \
                and not self._quota_fits_now(
                    record.tenant, self._merge_res(record.bundles)):
            # Tenant at cap: the group defers exactly like a capacity
            # shortage and retries when the tenant's usage shrinks.
            return False
        nodes = [n for n in self.nodes.values() if n.schedulable()]
        nodes.sort(key=lambda n: n.node_id.binary())
        holders = self._bundle_holders(record)
        prefer = [[i for w in holders.get(bix, ()) for i in w.gpu_reported]
                  for bix in range(len(record.bundles))]
        staged: Dict[NodeID, Dict[str, float]] = {
            n.node_id: dict(n.avail, **{_CARD + i: v
                                        for i, v in n.gpu_free.items()})
            for n in nodes}
        placement: List[Optional[NodeID]] = []
        if strategy in ("STRICT_PACK",):
            for n in nodes:
                avail = dict(staged[n.node_id])
                if all(self._stage(avail, b, prefer[bix])
                       for bix, b in enumerate(record.bundles)):
                    placement = [n.node_id] * len(record.bundles)
                    break
            else:
                return False
        elif strategy in ("STRICT_SPREAD",):
            if len(nodes) < len(record.bundles):
                return False
            used: Set[NodeID] = set()
            for bix, b in enumerate(record.bundles):
                for n in nodes:
                    if n.node_id in used:
                        continue
                    if self._stage(staged[n.node_id], b, prefer[bix]):
                        placement.append(n.node_id)
                        used.add(n.node_id)
                        break
                else:
                    return False
        else:  # PACK / SPREAD: best-effort
            order = nodes if strategy == "PACK" else nodes[::-1]
            for idx, b in enumerate(record.bundles):
                rotated = order[idx % len(order):] + order[:idx % len(order)] \
                    if strategy == "SPREAD" else order
                for n in rotated:
                    if self._stage(staged[n.node_id], b, prefer[idx]):
                        placement.append(n.node_id)
                        break
                else:
                    return False
        # Commit
        t1 = time.perf_counter()
        for bix, (node_id, bundle) in enumerate(zip(placement,
                                                    record.bundles)):
            node = self.nodes[node_id]
            _res_sub(node.avail, bundle)
            # staging placed the cards in this order, so they fit
            held = _gpu_take(node.gpu_free, bundle.get("GPU", 0.0),
                             prefer[bix])
            record.gpu_held[bix], record.gpu_free[bix] = held, dict(held)
            for w in holders.get(bix, ()):
                self._take_reported_gpus(w, record.gpu_free[bix])
        record.placement = placement
        if self._tenant_quotas and not record.quota_charged:
            self._tenant_acquire(record.tenant,
                                 self._merge_res(record.bundles))
            record.quota_charged = True
        t2 = time.perf_counter()
        self.pg_phases["reserve_s"] += t1 - t0
        self.pg_phases["commit_s"] += t2 - t1
        return True

    @staticmethod
    def _stage(avail: Dict[str, float], bundle: Dict[str, float],
               prefer: Sequence[str] = ()) -> bool:
        if not _res_fits(avail, bundle):
            return False
        want = bundle.get("GPU", 0.0)
        if want > 0:
            cards = {k[len(_CARD):]: v for k, v in avail.items()
                     if k.startswith(_CARD)}
            pick = _gpu_pick(cards, want, prefer)
            if pick is None:
                return False
            for i in pick:
                avail[_CARD + i] -= _gpu_share(want)
        _res_sub(avail, bundle)
        return True

    async def _h_pg_remove(self, client, msg):
        pg_id = PlacementGroupID(msg["pgid"])
        record = self.pgs.pop(pg_id, None)
        if record is not None:
            self._log_append("pgd", pg_id.binary())
            if record.quota_charged:
                record.quota_charged = False
                self._tenant_release(record.tenant,
                                     self._merge_res(record.bundles))
                self._wake_scheduler()  # quota freed: deferred work rechecks
        if record is not None and record.state == "pending":
            # Stop the placement retry timer: a removed-while-pending
            # group must never commit (the retry loop held the popped
            # record and would have reserved resources into the void once
            # capacity appeared).
            record.state = "removed"
            for conn, req in record.ready_waiters:
                if not conn.closed:
                    conn.reply(req, {"ok": True, "ready": False,
                                     "err": "placement group removed"})
            record.ready_waiters.clear()
        if record is not None and record.state == "ready":
            for node_id, bundle, held in zip(
                    record.placement, record.bundles, record.gpu_held):
                node = self.nodes.get(node_id)
                if node is not None:
                    # Return only unconsumed capacity; consumed capacity is
                    # returned by the releasing tasks as they finish.
                    _res_add(node.avail, bundle)
                    _res_add(node.gpu_free, held)
        # Pending work targeting the removed PG can never place: fail it
        # now (the reference errors such tasks on PG removal) instead of
        # leaving the owner's get() hanging forever.
        pgid_b = pg_id.binary()
        for sig, q in list(self.pending.qs.items()):
            doomed = [r for r in q if getattr(r, "pg", None) is not None
                      and (r.pg.binary() if hasattr(r.pg, "binary")
                           else bytes(r.pg)) == pgid_b]
            for r in doomed:
                try:
                    q.remove(r)
                    self.pending.count -= 1
                except ValueError:
                    continue
                self._fail_pending_for_removed_pg(r)
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})
        self._wake_scheduler()

    def _fail_pending_for_removed_pg(self, record):
        from . import serialization

        if isinstance(record, TaskRecord):
            err = serialization.serialize(ValueError(
                "task's placement group was removed")).to_bytes()
            results = [{"oid": oid.binary(), "nbytes": len(err),
                        "data": err} for oid in record.returns]
            for r in results:
                self._mark_ready(self._obj(ObjectID(r["oid"])),
                                 r["nbytes"], r["data"], False)
            record.state = "done"
            record.ts_done = time.time()
            record.error = True
            self.counters["tasks_failed"] += 1
            self._gc_done_task(record)
            if not record.owner.conn.closed:
                record.owner.conn.send(
                    {"t": "task_done", "tid": record.task_id.binary(),
                     "results": results})
        elif isinstance(record, LeaseDemand):
            # Void the demand so the lessee's queued tasks fail rather
            # than waiting forever for a grant that can never come.
            record.cancelled = True
            if record.client is not None and not record.client.conn.closed:
                try:
                    record.client.conn.send(
                        {"t": "lease_void", "key": record.key,
                         "err": "placement group was removed"})
                except ConnectionError:
                    pass

    async def _h_pg_list(self, client, msg):
        out = [{"pgid": p.pg_id.binary(), "state": p.state, "name": p.name,
                "strategy": p.strategy, "bundles": p.bundles}
               for p in self.pgs.values()]
        client.conn.reply(msg, {"ok": True, "pgs": out})

    # -------------------------------------------------- task events / metrics

    def _gc_done_task(self, record: TaskRecord):
        """Bound the completed-task table (reference: GcsTaskManager caps
        stored task events, gcs_task_manager.h:86)."""
        self._done_tasks.append(record.task_id)
        while len(self._done_tasks) > self.max_done_tasks:
            old = self._done_tasks.popleft()
            rec = self.tasks.get(old)
            if rec is not None and rec.state == "done":
                del self.tasks[old]

    async def _h_task_events(self, client, msg):
        """Profile events pushed from worker TaskEventBuffers
        (reference: task_event_buffer.h:220). Stored raw (positional rows
        + batch header); decoded to dicts only when the state API reads
        them — the hot path here is append-only."""
        wid = bytes(msg.get("wid") or b"")
        nid = bytes(msg.get("nid") or b"")
        pid = msg.get("pid", 0)
        for row in msg["ev"]:
            self.task_events.append((wid, nid, pid, row))

    @staticmethod
    def _event_to_dict(ev) -> dict:
        wid, nid, pid, (tid, name, kind, start, end, ok) = ev
        return {
            "task_id": TaskID(tid).hex() if len(tid) >= 8 else "",
            "name": name, "kind": kind,
            "worker_id": wid.hex(), "node_id": nid.hex(), "pid": pid,
            "start": start, "end": end, "ok": bool(ok),
        }

    async def _h_plane_events(self, client, msg):
        """Plane-event rows pushed from a process's recorder ring
        (util/events.py drain): stored raw + batch header, decoded only
        when read (same stance as task_events). ``drops`` carries the
        sender's per-plane drop DELTA since its last drain — accumulated
        here so a ring overflow anywhere is visible cluster-wide."""
        nid = bytes(msg.get("nid") or b"")
        pid = msg.get("pid", 0)
        for row in msg.get("ev") or []:
            self.plane_events.append((nid, pid, row))
        for plane, n in (msg.get("drops") or {}).items():
            self.plane_event_drops[plane] = \
                self.plane_event_drops.get(plane, 0) + int(n)

    def _ingest_local_plane_events(self):
        """Fold this process's OWN ring into the table (the GCS emits
        lease/admission/wait events but has no worker to push through)."""
        if not plane_events.enabled() or plane_events.pending() == 0:
            return
        rows, drops = plane_events.drain()
        for row in rows:
            self.plane_events.append((b"", os.getpid(), row))
        for plane, n in drops.items():
            self.plane_event_drops[plane] = \
                self.plane_event_drops.get(plane, 0) + n

    def _retention_sweep(self):
        """Bounded-retention sweep, one owner for both stores: evict
        plane-event rows older than ``plane_event_retention_s`` and
        ns="trace" KV blobs older than ``trace_retention_s`` (or beyond
        ``trace_max_traces``, oldest first). Runs on the health-check
        tick; O(evicted + traces) per pass — the trace-key index is
        maintained incrementally (kv_put/kv_del), never by scanning the
        whole KV, except ONE adoption scan for WAL/snapshot-restored
        entries on the first pass after startup."""
        self._ingest_local_plane_events()
        now = time.time()
        horizon = now - _cfg().plane_event_retention_s
        pe = self.plane_events
        while pe and pe[0][2][0] < horizon:
            pe.popleft()
            self.plane_events_evicted += 1
        # ---- trace KV (key = "<tid>:<pid>:..").
        if not self._trace_adopted:
            self._trace_adopted = True
            for (ns, k) in self.kv:
                if ns == "trace":
                    self._trace_keys.setdefault(
                        k.split(":", 1)[0], set()).add((ns, k))
        if not self._trace_keys:
            return
        retention = _cfg().trace_retention_s
        max_traces = _cfg().trace_max_traces
        for tid in [t for t, ks in self._trace_keys.items() if not ks]:
            del self._trace_keys[tid]  # every key individually deleted
            self._trace_touch.pop(tid, None)
        for tid in self._trace_keys:
            self._trace_touch.setdefault(tid, now)
        for tid in list(self._trace_touch):
            if tid not in self._trace_keys:
                del self._trace_touch[tid]
        doomed = {tid for tid, ts in self._trace_touch.items()
                  if now - ts > retention}
        live = len(self._trace_keys) - len(doomed)
        if live > max_traces:
            survivors = sorted(
                (tid for tid in self._trace_keys if tid not in doomed),
                key=lambda t: self._trace_touch.get(t, now))
            doomed.update(survivors[:live - max_traces])
        for tid in doomed:
            for key in self._trace_keys.pop(tid, ()):
                if self.kv.pop(key, None) is not None:
                    self._log_append("kvd", list(key))
            self._trace_touch.pop(tid, None)

    async def _h_clear_traces(self, client, msg):
        """Driver API (``tracing.clear_traces()``): drop every span blob
        in the trace namespace now, without waiting for retention."""
        keys = [(ns, k) for (ns, k) in self.kv if ns == "trace"]
        for key in keys:
            del self.kv[key]
            self._log_append("kvd", list(key))
        self._trace_touch.clear()
        self._trace_keys.clear()
        client.conn.reply(msg, {"ok": True, "cleared": len(keys)})

    async def _h_metrics_push(self, client, msg):
        sender = (client.worker_id.hex() if client.worker_id
                  else str(id(client)))
        for m in msg["m"]:
            tags = tuple(sorted((m.get("tags") or {}).items()))
            self.metrics[(sender, m["name"], tags)] = m

    async def _h_metrics_get(self, client, msg):
        """Aggregate pushed metrics across processes + GCS-internal counters.

        Counters/sums add across senders; gauges keep the latest per tag-set
        (mirroring the per-node metrics agent aggregation,
        python/ray/_private/metrics_agent.py).
        """
        agg: Dict[tuple, dict] = {}
        for (sender, name, tags), m in self.metrics.items():
            key = (name, tags)
            cur = agg.get(key)
            if cur is None:
                cur = {"name": name, "tags": dict(tags),
                       "type": m.get("type", "gauge"), "value": 0.0}
                agg[key] = cur
            if m.get("type") == "gauge":
                cur["value"] = m.get("value", 0.0)
            else:
                cur["value"] += m.get("value", 0.0)
            if m.get("buckets"):
                buckets = cur.setdefault("buckets", {})
                for b, c in m["buckets"].items():
                    buckets[b] = buckets.get(b, 0) + c
                cur["count"] = cur.get("count", 0) + m.get("count", 0)
        out = list(agg.values())
        for name, v in self.counters.items():
            out.append({"name": f"gcs_{name}", "tags": {}, "type": "counter",
                        "value": v})
        out.append({"name": "gcs_object_store_bytes", "tags": {},
                    "type": "gauge", "value": float(self.shm_bytes)})
        out.append({"name": "gcs_pending_tasks", "tags": {}, "type": "gauge",
                    "value": float(len(self.pending))})
        out.append({"name": "gcs_alive_nodes", "tags": {}, "type": "gauge",
                    "value": float(sum(1 for n in self.nodes.values()
                                       if n.alive))})
        out.append({"name": "gcs_draining_nodes", "tags": {},
                    "type": "gauge",
                    "value": float(sum(1 for n in self.nodes.values()
                                       if n.alive and n.draining))})
        out.append({"name": "gcs_alive_actors", "tags": {}, "type": "gauge",
                    "value": float(sum(1 for a in self.actors.values()
                                       if a.state == A_ALIVE))})
        # Queue-depth telemetry (the flight recorder's gauge face): GCS
        # ingress-lane depth per role + total admission-blocked lanes,
        # and the plane-event table's own health. Per-process series
        # (broadcast in-flight, collective pending ops, per-tenant serve
        # queues) arrive through metrics_push like any user metric.
        lane_by_role: Dict[str, int] = {}
        blocked = 0
        for c in self.clients:
            if c.conn is None or c.conn.closed:
                continue
            lane_by_role[c.role or "?"] = \
                lane_by_role.get(c.role or "?", 0) + len(c.inq)
            if c.bp_on:
                blocked += 1
        for role, depth in sorted(lane_by_role.items()):
            out.append({"name": "gcs_lane_depth", "tags": {"role": role},
                        "type": "gauge", "value": float(depth)})
        out.append({"name": "gcs_admission_blocked_lanes", "tags": {},
                    "type": "gauge", "value": float(blocked)})
        out.append({"name": "plane_event_rows", "tags": {},
                    "type": "gauge", "value": float(len(self.plane_events))})
        for plane, n in sorted(self.plane_event_drops.items()):
            out.append({"name": "plane_event_drops",
                        "tags": {"plane": plane}, "type": "counter",
                        "value": float(n)})
        client.conn.reply(msg, {"ok": True, "metrics": out})

    async def _h_autoscaler_state(self, client, msg):
        """Demand + idle view for the autoscaler (reference: GCS
        AutoscalerStateService, autoscaler.proto:315 /
        gcs_autoscaler_state_manager.cc)."""
        now = time.time()
        demands: List[Dict[str, float]] = []
        for record in self.pending:
            if record.pg is None:
                n = record.count if isinstance(record, LeaseDemand) else 1
                demands.extend([record.resources] * n)
        for a in self.actors.values():
            if a.state in (A_PENDING, A_RESTARTING) and a.pg is None:
                demands.append(a.resources)
        for p in self.pgs.values():
            if p.state == "pending":
                demands.extend(p.bundles)
        nodes = []
        for n in self.nodes.values():
            busy = any(
                (w := self.workers.get(wid)) is not None
                and w.state in (W_BUSY, W_ACTOR) for wid in n.workers)
            if busy or demands:
                n.last_active = now
            nodes.append({"node_id": n.node_id.hex(), "alive": n.alive,
                          "state": n.lifecycle_state(),
                          "draining": n.draining, "busy": busy,
                          "drain_deadline": n.drain_deadline,
                          "total": n.total, "avail": n.avail,
                          "idle_s": 0.0 if busy else now - n.last_active})
        # Explicit capacity requests (reference: autoscaler
        # sdk.request_resources — app-level hints that persist until
        # replaced). Appended AFTER the idle computation: a satisfied
        # standing request must not refresh node activity, or idle
        # scale-down would be disabled while any request is outstanding.
        req = self.kv.get(("_autoscaler", "requested"))
        if req:
            try:
                import json as _json

                for bundle in _json.loads(req):
                    demands.append({k: float(v) for k, v in bundle.items()})
            except (ValueError, AttributeError):
                pass
        client.conn.reply(msg, {"ok": True, "demands": demands,
                                "nodes": nodes})

    async def _h_state_list(self, client, msg):
        """Unified state listing (reference: state API server side,
        dashboard/state_aggregator.py sourcing GCS tables)."""
        kind = msg["kind"]
        limit = msg.get("limit", 1000)
        out: List[dict] = []
        if kind == "cluster_events":
            # newest are the interesting ones: serve the ring's tail
            n = max(0, int(limit))
            out = list(self.cluster_events)[-n:] if n else []
            client.conn.reply(msg, {"ok": True, "items": out,
                                    "total": len(self.cluster_events)})
            return
        if kind == "nodes":
            for n in self.nodes.values():
                out.append({"node_id": n.node_id.hex(), "alive": n.alive,
                            "state": n.lifecycle_state(),
                            "draining": n.draining,
                            "drain_reason": n.drain_reason,
                            "drain_deadline": n.drain_deadline,
                            "hostname": n.hostname, "total": n.total,
                            "avail": n.avail, "workers": len(n.workers)})
        elif kind == "workers":
            for w in self.workers.values():
                out.append({"worker_id": w.worker_id.hex(),
                            "node_id": w.node_id.hex(), "pid": w.pid,
                            "state": w.state,
                            "actor_id": w.actor_id.hex() if w.actor_id else "",
                            "task_id": (w.current_task.hex()
                                        if w.current_task else "")})
        elif kind == "actors":
            for a in self.actors.values():
                out.append({"actor_id": a.actor_id.hex(), "state": a.state,
                            "name": a.name or "", "namespace": a.namespace,
                            "node_id": a.node_id.hex() if a.node_id else "",
                            "pid": (self.workers[a.worker_id].pid
                                    if a.worker_id in self.workers else 0),
                            "restarts": a.restarts_used,
                            "detached": a.detached,
                            "death_cause": a.death_cause or ""})
        elif kind == "tasks":
            self._ingest_obs_rows()
            for t in self.tasks.values():
                out.append({"task_id": t.task_id.hex(), "state": t.state,
                            "name": t.name, "error": t.error,
                            "node_id": t.node_id.hex() if t.node_id else "",
                            "worker_id": (t.worker_id.hex()
                                          if t.worker_id else ""),
                            "resources": t.resources,
                            "creation_time": t.ts_created,
                            "start_time": t.ts_running,
                            "end_time": t.ts_done})
        elif kind == "objects":
            for o in self.objects.values():
                out.append({"object_id": o.object_id.hex(),
                            "nbytes": o.nbytes, "ready": o.ready,
                            "refcount": o.refcount,
                            "where": ("spilled" if o.spilled else
                                      "shm" if o.on_shm else "inline"),
                            "reconstructable": o.producing_task is not None})
        elif kind == "placement_groups":
            for p in self.pgs.values():
                out.append({"pg_id": p.pg_id.hex(), "state": p.state,
                            "name": p.name, "strategy": p.strategy,
                            "bundles": p.bundles,
                            "placement": [nid.hex() if nid else ""
                                          for nid in p.placement]})
        elif kind == "task_events":
            out = [self._event_to_dict(e) for e in self.task_events]
        elif kind == "plane_events":
            self._ingest_local_plane_events()
            out = [plane_events.row_to_dict(row, nid.hex(), pid)
                   for nid, pid, row in self.plane_events]
        else:
            client.conn.reply(msg, {"ok": False,
                                    "err": f"unknown kind {kind!r}"})
            return
        client.conn.reply(msg, {"ok": True, "items": out[:limit],
                                "total": len(out)})

    # ----------------------------------------------------------- inspection

    async def _h_gcs_stats(self, client, msg):
        """Control-plane introspection for the multi-tenant surface:
        per-shard directory fill, per-connection ingress rates, admission
        and quota state. The multi-driver bench and the fairness tests
        read this instead of guessing from the outside."""
        shard = {}
        for name in ("objects", "actors", "pgs"):
            table = getattr(self, name)
            if isinstance(table, ShardedDict):
                shard[name] = table.stats()
            else:
                shard[name] = {"nshards": 1, "total": len(table),
                               "sizes": [len(table)], "balance": 1.0}
        conns = []
        for c in self.clients:
            if c.conn is None:
                continue
            conns.append({
                "serial": c.serial, "role": c.role,
                "namespace": c.namespace,
                "worker_id": c.worker_id.hex() if c.worker_id else "",
                "frames_in": getattr(c.conn, "frames_in", 0),
                "bytes_in": getattr(c.conn, "bytes_in", 0),
                "queued": len(c.inq),
                "backpressured": c.bp_on,
            })
        client.conn.reply(msg, {
            "ok": True,
            "shards": shard,
            "ingress": conns,
            "fair_slice": self._fair_slice,
            "admission": {"high": self._adm_high, "low": self._adm_low,
                          "backpressure_events":
                              self.counters["backpressure_events"]},
            "tenant_quotas": self._tenant_quotas,
            "tenant_usage": {ns: {k: round(v, 6) for k, v in u.items()}
                             for ns, u in self.tenant_usage.items()},
            "quota_rejections": self.counters["quota_rejections"],
            # Interference-SLO surface: registered specs + detector
            # state, the live enforcement weights, and the bounded
            # action journal (the soak certificate reads this).
            "slo": self.slo.status(),
            "gangs": {g.name: {"generation": g.generation,
                               "status": g.status,
                               "world": len(g.members),
                               "lost": sorted(g.lost)}
                      for g in self.gangs.values()},
            # Flight-recorder end-state surface (chaos invariants):
            # drop counters are REPORTED (dict present even when all
            # zero) and the oldest row's age proves the table honors
            # its retention bound.
            "plane_events": {
                "rows": len(self.plane_events),
                "drops": dict(self.plane_event_drops),
                "evicted": self.plane_events_evicted,
                "oldest_age_s": (time.time() - self.plane_events[0][2][0]
                                 if self.plane_events else 0.0),
                "retention_s": _cfg().plane_event_retention_s,
            },
        })

    async def _h_cluster_info(self, client, msg):
        nodes = [{"node_id": n.node_id.binary(), "alive": n.alive,
                  "state": n.lifecycle_state(), "draining": n.draining,
                  "drain_reason": n.drain_reason,
                  "hostname": n.hostname, "total": n.total, "avail": n.avail,
                  "workers": len(n.workers)}
                 for n in self.nodes.values()]
        reply = {"ok": True, "nodes": nodes}
        monitor = getattr(self, "loop_monitor", None)
        if monitor is not None:
            reply["loop_stats"] = monitor.stats()
        client.conn.reply(msg, reply)

    async def _h_shutdown(self, client, msg):
        logger.info("shutdown requested")
        for w in self.workers.values():
            if not w.conn.closed:
                try:
                    w.conn.send({"t": "exit"})
                except ConnectionError:
                    pass
        for n in self.nodes.values():
            if n.agent_conn is not None and not n.agent_conn.closed:
                try:
                    n.agent_conn.send({"t": "exit"})
                except ConnectionError:
                    pass
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})
        await asyncio.sleep(0.05)
        self._shutdown_event.set()

    # Senders live in tests/ (crash-restart fault-tolerance drills).
    async def _h_gcs_restart(self, client, msg):  # raylint: disable=RTL122
        """Chaos/test hook: crash-restart the control plane in place.

        Drops every client connection and discards ALL in-memory state; the
        supervisor (head_amain) builds a fresh GcsServer that recovers from
        the WAL + arena while agents/workers/drivers reconnect and resync —
        the same recovery path as a real GCS process death (reference:
        ``test_gcs_fault_tolerance.py`` restarting gcs_server).
        """
        logger.warning("GCS restart injected (chaos)")
        if msg.get("i") is not None:
            client.conn.reply(msg, {"ok": True})
        self.restart_requested = True

        async def _teardown():
            # Tear connections down BEFORE signalling the supervisor:
            # after the restart reply, no request may be served by the
            # dying instance (a client that got a reply in the gap would
            # believe it had reconnected to the fresh one). Runs as its
            # own task — this handler lives inside the requesting
            # connection's read loop, and stop_serving closes that very
            # connection (cancelling the loop, and the handler with it).
            await asyncio.sleep(0.02)  # let the reply flush
            await self.stop_serving()
            self._shutdown_event.set()

        asyncio.get_running_loop().create_task(_teardown())

    async def stop_serving(self):
        """Close listeners and all client connections (restart path).

        Order matters on Python >= 3.12.1: ``Server.wait_closed()`` waits
        for every ACCEPTED TRANSPORT to close, not just the listener — so
        client connections must be torn down first or the supervisor
        deadlocks here and the fresh instance never starts (found via
        test_gcs_fault_tolerance hanging after a chaos restart).

        Idempotent: the restart teardown task and the supervisor both call
        it."""
        if getattr(self, "_stopped_serving", False):
            return
        self._stopped_serving = True
        if self._ingress_task is not None:
            # The fair-drain loop belongs to THIS instance; a restart
            # builds a fresh GcsServer in the same process and must not
            # leave the old drain task running over dead state.
            self._ingress_task.cancel()
            self._ingress_task = None
        servers = [self._server, *getattr(self, "_extra_servers", [])]
        for srv in servers:
            if srv is not None:
                srv.close()  # stop accepting; don't await yet
        for client in list(self.clients):
            try:
                await client.conn.close()
            except Exception:
                pass
        for srv in servers:
            if srv is not None:
                try:
                    # Bounded: a transport wedged in close must not stall
                    # the restart (the listener socket is already closed).
                    await asyncio.wait_for(srv.wait_closed(), timeout=5.0)
                except Exception:
                    pass
        if self.log is not None:
            self.log.close()
        if self._event_file:
            try:
                self._event_file.close()
            except OSError:
                pass
            self._event_file = None
