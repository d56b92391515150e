"""Central typed flag registry.

Analog of the reference's ``RayConfig`` macro file
(``src/ray/common/ray_config_def.h:21`` — 219 typed flags, each settable
via a ``RAY_*`` env var or ``_system_config`` at init, propagated to every
process through the GCS). Here: one dataclass of typed fields; precedence
is ``_system_config`` (explicit, via GCS KV) > ``RAY_TPU_TORCH_<NAME>`` env var >
default. Every process reads the same table; workers receive overrides in
their session bootstrap (env) or from the GCS KV at connect.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional

_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclasses.dataclass
class RayTpuConfig:
    # ---- scheduling / task submission
    lease_window: int = 8           # in-flight pushes per leased worker
    # Burst ceiling for the ADAPTIVE window: under backlog pressure the
    # per-lease pipeline deepens (fewer driver<->worker refill wakeups —
    # the dominant cost for tiny-task storms on few cores) up to this cap.
    lease_window_max: int = 64
    max_leases_per_class: int = 64
    lease_idle_return_s: float = 0.25
    task_pool_threads: int = 8      # concurrent plain tasks per worker
    max_inflight_spawns: int = 16   # concurrent worker spawns per node
    # ---- object store
    store_capacity: int = 2 << 30   # logical capacity before evict/spill
    arena_bytes: int = 4 << 30      # shm arena size (sparse)
    pull_chunk_bytes: int = 4 << 20  # p2p transfer chunk
    pull_window: int = 8            # outstanding chunks per pull PER SOURCE
    # Transport write-buffer ceiling on chunk-serving connections. The
    # asyncio default (64KB high water) empties the pipe between chunks —
    # the serve side stalls a drain round-trip per chunk and fan-out
    # collapses (measured 3x on a 3-puller fan-out). Serving at most a
    # pull window per puller bounds the real buffering anyway.
    obj_serve_buffer: int = 16 << 20
    # ---- cooperative pipelined broadcast (P2P striped pull)
    # Deadlines scale with object size: base + nbytes/min_bandwidth, so a
    # multi-GB pull on a slow link is not killed by a flat cap while tiny
    # pulls still fail fast.
    pull_timeout_base_s: float = 30.0
    pull_min_bandwidth: int = 8 << 20      # bytes/s assumed worst case
    pull_chunk_timeout_floor_s: float = 10.0
    pull_progress_chunks: int = 4          # chunk-bitmap report cadence
    pull_refresh_interval_s: float = 0.05  # mid-pull directory re-locate
    pull_max_sources: int = 8              # stripe fan-in cap per pull
    # ---- object plane v2: sub-chunk striping + serve-from-spill
    # Directory-assigned canonical chunk size: on the FIRST pull-locate of
    # an object the GCS picks a chunk size targeting at least
    # ``stripe_min_chunks`` chunks (never below ``stripe_chunk_floor``,
    # never above pull_chunk_bytes) and publishes it in the locate reply.
    # Sub-chunking is what turns a 16-64MB weight leaf — one or a few
    # pull_chunk_bytes chunks, i.e. unstripeable — into a relay: a puller
    # holding ANY chunk registers as a partial holder and serves it to
    # its peers while its own pull is still in flight. 0 disables (legacy
    # whole-chunk behavior: first puller's client chunk size wins).
    stripe_min_chunks: int = 64
    stripe_chunk_floor: int = 256 << 10    # don't sub-chunk below 256KB
    # Serve chunks straight off the spill file (os.pread per chunk)
    # instead of restoring the whole file into the arena first. Kills the
    # broadcast cliff where a spilled hot object forces a full-file read
    # + arena re-admission (possibly re-evicting what displaced it)
    # before the first byte moves. False restores the legacy
    # restore-then-serve path.
    spill_serve: bool = True
    # Shared byte budget for spill-tier reads (striped chunk serves AND
    # full restores draw from one bucket): max bytes of spill IO in
    # flight per process before further reads queue. Bounds disk
    # thrash when many pullers stripe one spilled object.
    spill_read_budget: int = 64 << 20
    max_peer_conns: int = 32               # cached idle pull connections
    inline_threshold: int = 100 * 1024
    # Direct-lane ceiling: actor-call args above inline_threshold and at
    # most this ride the already-open actor connection out-of-band
    # (scatter-gather frames, zero-copy write side) instead of the
    # per-call shm create/seal + GCS register round trip. Larger args —
    # and anything a second consumer might borrow — keep the shm+GCS
    # object-plane path.
    direct_arg_threshold: int = 1 << 20
    # ---- reference plane (batched obj_waits wait groups)
    # False falls back to the per-ref obj_wait lane (one GCS round trip
    # per unresolved ref) — the escape hatch for A/B measurement and for
    # bisecting directory regressions.
    batched_obj_wait: bool = True
    # Max oids per obj_waits frame: one wait over 100k refs chunks into
    # ceil(n/batch) frames so a single frame never stalls the GCS loop
    # (still O(1) frames per thousand refs, vs O(n) on the per-ref lane).
    obj_waits_max_batch: int = 4096
    # GCS-side resolution-row push coalescing: rows for one client flush
    # when this many accumulate, else on the next loop tick (a burst of
    # obj_put registrations resolves a whole group in one obj_res frame).
    obj_res_flush_rows: int = 512
    # ---- multi-tenant control plane (sharding / fairness / admission)
    # Hot directory tables (objects/actors/PGs) partition into this many
    # independent sub-dicts (rounded up to a power of two). 1 disables.
    gcs_shards: int = 8
    # Fair per-connection frame drain: each registered client gets at
    # most this many frames handled per round-robin cycle, so one
    # flooding connection cannot monopolize the control loop between
    # yields (reference analog: gRPC's per-call completion-queue
    # fairness the single-reader asyncio loop otherwise lacks). 256
    # bounds a tenant's burst monopoly at ~2.5ms of GCS time while
    # keeping the yield overhead unmeasurable (64 cost ~20% of the raw
    # frame ceiling; per-RPC costs at 256 match the pre-fairness plane
    # — SCALE_BENCH_r07 A/B).
    gcs_fair_slice: int = 256
    # Admission control: a DRIVER with more than this many frames queued
    # inside the GCS gets a backpressure frame and its socket stops being
    # read (kernel backpressure) until the queue drains below the low
    # water mark. Lanes are naturally paced to O(fair_slice) by the
    # mid-chunk yields, so a lane this deep means the drain has genuinely
    # stalled behind this tenant (blocking handler, overload) — the
    # budget is a stall guard, not a steady-state throttle. Workers and
    # agents are exempt — stalling the data plane or health checks to
    # punish a tenant would be self-harm.
    admission_inflight_high: int = 4_096
    admission_inflight_low: int = 1_024
    # Per-tenant quotas: JSON {namespace: {resource: amount}} enforced at
    # lease grant and placement-group reservation. A demand that can
    # NEVER fit its namespace quota fails cleanly (lease_void / pg error
    # reply); one that only transiently exceeds it waits like any other
    # resource shortage. Empty = no quotas.
    tenant_quotas: str = ""
    # Namespace isolation: when true, a driver can only resolve/kill
    # named actors in its own namespace (get_actor across namespaces
    # errors). Off by default — the reference allows explicit
    # cross-namespace lookup, and single-tenant clusters rely on it.
    tenant_isolation: bool = False
    # ---- tenant SLO enforcement (interference detector + action ladder)
    # Per-tenant SLO specs: JSON {namespace: {"event": "serve.req.done",
    # "field": "dur", "stat": "p99", "threshold_s": 0.05, ...}} — also
    # registrable at runtime via ray_tpu_torch.util.slo.register(). The
    # GCS-side sweep evaluates each spec over a sliding window of
    # tenant-tagged plane-event rows; `breach_windows` consecutive
    # breached sweeps escalate the enforcement ladder one rung
    # (re-weight -> rebalance -> migrate), `recover_windows` clear
    # sweeps de-escalate and restore the offender's weight. Empty =
    # detector loop idle (zero overhead beyond the timer).
    slo_specs: str = ""
    slo_sweep_interval_s: float = 1.0   # detector cadence
    slo_window_s: float = 5.0           # sliding stat window per sweep
    # Minimum time between two enforcement actions against the same
    # offender — the ladder never machine-guns rungs faster than the
    # cluster can show the previous rung's effect.
    slo_action_cooldown_s: float = 2.0
    # Rung-1 de-weighting: offender's fair-ingress slice and admission
    # budget scale by this factor (floor of 1 frame/cycle keeps the
    # offender live — starvation is migration's job, not re-weighting's).
    slo_reweight_factor: float = 0.05
    # Rung-2 ceiling: at most this many of the offender's held leases
    # are revoked per rebalance action (graceful, restartable work only).
    slo_rebalance_max_leases: int = 4
    # ---- gang fault plane (train worker groups / host collectives)
    # Rendezvous cap for the shm-collective coordinator (was a hard-coded
    # 300s asyncio.wait_for): a rank blocked past this raises a typed
    # CollectiveTimeout NAMING the ranks that never arrived. Membership
    # loss never waits this out — the gang push fails pending ops in
    # event time; the timeout is the backstop for live-but-stuck peers.
    collective_timeout_s: float = 300.0
    # After a membership-loss push, how long the worker group waits for
    # survivors to unwedge themselves (their pending collectives error
    # out via the coordinator's fail-fast path) before SIGKILLing the
    # ranks still blocked (e.g. wedged inside jax.distributed, which has
    # no cooperative abort).
    gang_abort_grace_s: float = 5.0
    # ---- fault tolerance
    reconnect_attempts: int = 75    # GCS reconnect budget (x delay ~15s)
    reconnect_delay_s: float = 0.2
    # Shared jittered-exponential-backoff policy for reconnect/retry
    # loops (_private/backoff.py): delays grow base * factor^n up to the
    # cap, each multiplied by a uniform jitter in [1-j, 1] so retry
    # storms from many peers decorrelate instead of thundering in step.
    retry_backoff_base_s: float = 0.02
    retry_backoff_cap_s: float = 2.0
    retry_backoff_jitter: float = 0.5
    # ---- deterministic failpoints (chaos certification; see
    # _private/failpoints.py for the spec grammar). The env vars
    # RAY_TPU_TORCH_FAILPOINTS / RAY_TPU_TORCH_FAILPOINT_SEED win over these flags so
    # one process can arm/disarm under a cluster-wide _system_config.
    failpoints: str = ""
    failpoint_seed: int = 0
    driver_exit_grace_s: float = 3.0
    actor_adoption_grace_s: float = 5.0
    gcs_wal_compact_every: int = 50_000
    health_check_interval_s: float = 5.0   # GCS->agent active pings
    health_check_failures: int = 3         # misses before node is dead
    # In-flight worker-spawn slots with no worker hello within this
    # window are released (a spawn_worker frame lost between GCS and
    # agent must not pin the pool's spawn budget forever).
    spawn_timeout_s: float = 15.0
    # ---- graceful node drain (ALIVE -> DRAINING -> DEAD)
    drain_deadline_s: float = 30.0         # default migration window
    preemption_poll_interval_s: float = 1.0  # agent notice-source poll
    # Notice-source plug point: "file" polls preemption_notice_file (or
    # <session_dir>/preempt-<node_id> when unset — the fake source tests
    # and simulated fleets use), "gce" polls the GCE metadata server's
    # preempted/maintenance-event keys, "none" disables the watcher.
    preemption_notice_source: str = "file"
    preemption_notice_file: str = ""
    # ---- memory monitor (0 disables; reference: memory_monitor.h)
    memory_monitor_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0
    # ---- static analysis (analysis/: decoration-time anti-pattern
    # warnings; RAY_TPU_TORCH_STATIC_CHECKS env var wins over this flag, so a
    # single process can opt out of a cluster-wide _system_config)
    static_checks: bool = False
    # ---- observability
    max_done_tasks: int = 10_000
    max_task_events: int = 50_000
    event_flush_interval_s: float = 0.5
    # Plane-event flight recorder (util/events.py). ``plane_events``
    # gates every emit site (the --recorder off A/B arm); the ring is
    # per-process and bounded — overflow increments a ``dropped``
    # counter, it never backpressures an emit site.
    plane_events: bool = True
    plane_event_ring: int = 65536
    # GCS-side plane-event table bound (rows) + retention window: the
    # maintenance sweep evicts rows older than the window, and the
    # chaos end-state invariant asserts the table honors it.
    max_plane_events: int = 100_000
    plane_event_retention_s: float = 600.0
    # Trace KV retention: spans flushed to ns="trace" used to accumulate
    # forever; the same GCS maintenance sweep that owns the plane-event
    # table bounds traces by age and count (oldest evicted first).
    trace_retention_s: float = 600.0
    trace_max_traces: int = 512
    # Metrics flusher cadence (was a hard-coded 1.0s daemon sleep); the
    # flusher also drains the driver-side plane-event ring each tick.
    metrics_flush_interval_s: float = 1.0
    # ---- data
    data_memory_limit: int = 0      # 0 = auto (store capacity / 4)

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    def apply_env(self) -> "RayTpuConfig":
        """Overlay ``RAY_TPU_TORCH_<NAME>`` env vars (typed parse)."""
        for f in dataclasses.fields(self):
            raw = os.environ.get(_ENV_PREFIX + f.name.upper())
            if raw is None:
                continue
            try:
                if f.type in ("int", int):
                    setattr(self, f.name, int(float(raw)))
                elif f.type in ("float", float):
                    setattr(self, f.name, float(raw))
                elif f.type in ("bool", bool):
                    setattr(self, f.name,
                            raw.lower() in ("1", "true", "yes"))
                else:
                    setattr(self, f.name, raw)
            except ValueError:
                import logging

                logging.getLogger(__name__).warning(
                    "ignoring unparseable %s%s=%r (expected %s)",
                    _ENV_PREFIX, f.name.upper(), raw, f.type)
        return self

    def apply_overrides(self, overrides: Dict[str, Any]) -> "RayTpuConfig":
        """Overlay explicit ``_system_config`` entries (highest priority).
        Unknown keys raise — typos in config must fail loudly."""
        for k, v in (overrides or {}).items():
            if k not in self.field_names():
                raise ValueError(
                    f"unknown _system_config key {k!r}; known: "
                    f"{sorted(self.field_names())}")
            setattr(self, k, v)
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


_lock = threading.Lock()
_config: Optional[RayTpuConfig] = None
_overrides: Dict[str, Any] = {}
_refresh_hooks = []


def on_config_change(fn):
    """Register a callback run after ``set_system_config`` rebuilds the
    table. Modules that snapshot flags into constants at import time
    (hot-path reads) use this to re-snapshot, so driver-side
    ``_system_config`` overrides land even though the package was already
    imported when ``init()`` ran."""
    _refresh_hooks.append(fn)


def config() -> RayTpuConfig:
    """The process-wide flag table (env applied once, lazily)."""
    global _config
    with _lock:
        if _config is None:
            overrides = _overrides
            if not overrides:
                blob = os.environ.get("RAY_TPU_TORCH_SYSTEM_CONFIG")
                if blob:
                    try:
                        overrides = json.loads(blob)
                    except ValueError:
                        import logging

                        logging.getLogger(__name__).warning(
                            "malformed RAY_TPU_TORCH_SYSTEM_CONFIG blob ignored; "
                            "this process runs with env/default flags only")
                        overrides = {}
            _config = RayTpuConfig().apply_env().apply_overrides(overrides)
        return _config


def set_system_config(overrides: Dict[str, Any]):
    """Install explicit overrides (driver: from ``init(_system_config=)``).

    Also exported through the environment so every spawned session process
    (head, agents, workers) sees the same table — the propagation role the
    reference fills with GCS ``GetInternalConfig``."""
    global _config, _overrides
    # Validate BEFORE exporting to the environment: a typo'd key must fail
    # loudly here in the driver, not crash every spawned child at import.
    known = RayTpuConfig.field_names()
    for k in (overrides or {}):
        if k not in known:
            raise ValueError(
                f"unknown _system_config key {k!r}; known: {sorted(known)}")
    with _lock:
        _overrides = dict(overrides or {})
        if _overrides:
            os.environ["RAY_TPU_TORCH_SYSTEM_CONFIG"] = json.dumps(_overrides)
        else:
            os.environ.pop("RAY_TPU_TORCH_SYSTEM_CONFIG", None)
        _config = None  # rebuilt with the new overlay on next read
    for fn in _refresh_hooks:  # outside the lock: hooks call config()
        fn()


def reset_config():
    """Test hook: drop the cached table so env changes take effect."""
    global _config, _overrides
    with _lock:
        _config = None
        _overrides = {}
        os.environ.pop("RAY_TPU_TORCH_SYSTEM_CONFIG", None)
    for fn in _refresh_hooks:  # keep import-time snapshots in sync
        fn()
