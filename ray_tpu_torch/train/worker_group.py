"""Gang-scheduled actor group for SPMD training.

Analog of the reference's ``WorkerGroup`` + ``BackendExecutor``
(``python/ray/train/_internal/worker_group.py:102``,
``backend_executor.py:135``): N actors created inside one placement group,
each hosting a ``TrainWorker`` that runs the user's train loop. The group
co-schedules them, each pinned to its share of a GPU by the runtime, and
wires the ``torch.distributed`` rendezvous (NCCL on CUDA by default, gloo
when asked or on the CPU). With a gang name it is registered with the GCS,
which pushes member losses and drains to the group (the gang fault plane).
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util import PlacementGroupSchedulingStrategy, placement_group, remove_placement_group


@ray_tpu_torch.remote
class TrainWorker:
    """One training host-process."""

    def __init__(self, rank: int, world_size: int, env: Dict[str, str]):
        import os as _os

        self.rank = rank
        self.world_size = world_size
        _os.environ.update(env)
        if "RAY_TPU_TORCH_FAILPOINTS" in env or "RAY_TPU_TORCH_FAILPOINT_SEED" in env:
            # Per-worker failpoint (dis)arming: the inherited spec was
            # snapshotted at process import — an env_per_worker override
            # (e.g. a reshaped gang running clear of the schedule that
            # killed its predecessor) must take effect HERE.
            from ray_tpu_torch._private import failpoints

            failpoints.reload_failpoints()

    def coordinator_endpoint(self) -> str:
        """Pick a reachable (ip, free port) on THIS host for the
        torch.distributed rendezvous (rank 0 hosts it)."""
        import socket

        from ray_tpu_torch._private.node import get_node_ip_address

        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return f"{get_node_ip_address()}:{port}"

    def setup_torch_distributed(self, master_addr: str, master_port: int,
                                backend: Optional[str] = None,
                                timeout_s: float = 120.0):
        """torch.distributed process group over the gang (reference:
        ``train/torch/config.py:66`` ``_setup_torch_process_group`` —
        rank-0 address broadcast then a collective init). A worker the
        runtime pinned to a GPU first makes its card (visible index 0)
        the current device; the backend is then NCCL unless the caller
        asks for another, and gloo on the CPU."""
        import datetime

        import torch
        import torch.distributed as dist

        import ray_tpu_torch

        on_gpu = bool(ray_tpu_torch.get_gpu_ids())
        if on_gpu and torch.cuda.is_available():
            # a GPU resource on a host without CUDA (a resource test)
            # pins nothing; the loop's own device choice then raises
            torch.cuda.set_device(0)
        backend = backend or ("nccl" if on_gpu else "gloo")
        if self.world_size > 1 and not dist.is_initialized():
            dist.init_process_group(
                backend,
                init_method=f"tcp://{master_addr}:{master_port}",
                rank=self.rank, world_size=self.world_size,
                timeout=datetime.timedelta(seconds=timeout_s))
        return backend

    def run(self, fn_blob: bytes, config: Optional[dict], session_kwargs: dict,
            result_actor, dataset_shards: Optional[dict] = None):
        import cloudpickle

        from . import session as session_mod

        fn = cloudpickle.loads(fn_blob)
        sess = session_mod.init_session(
            result_actor=result_actor,
            dataset_shards=dataset_shards or {}, **session_kwargs)
        if session_kwargs.get("restore_path"):
            sess.restore_path = session_kwargs["restore_path"]
        try:
            import inspect

            sig = inspect.signature(fn)
            if len(sig.parameters) >= 1 and config is not None:
                out = fn(config)
            elif len(sig.parameters) >= 1:
                out = fn({})
            else:
                out = fn()
            return {"ok": True, "out": out}
        except session_mod.RescaleSignal as s:
            # Clean cooperative exit at a report boundary: the trainer
            # re-forms the group at the new size and resumes from the
            # latest checkpoint.
            return {"ok": True, "rescaled_to": s.target_world_size}
        except Exception as e:  # noqa: BLE001
            # Typed failure surface: the trainer's escalation path keys
            # off err_type (CollectiveMemberLost -> reshape at N-k,
            # CollectiveTimeout -> membership probe first) instead of
            # string-matching tracebacks.
            out = {"ok": False, "err": f"{e}", "err_type": type(e).__name__,
                   "tb": traceback.format_exc()}
            if hasattr(e, "lost_ranks"):
                out["lost_ranks"] = list(getattr(e, "lost_ranks"))
            return out
        finally:
            session_mod.shutdown_session()

    def ping(self):
        return True

    def pid(self) -> int:
        import os as _os

        return _os.getpid()

    def join_gang_collectives(self, gang: str, generation: int,
                              group_name: str) -> int:
        """Bind this rank to the gang's shm-collective group: the
        coordinator is formed gang-aware (fails pending ops on the GCS
        membership push) and every op this rank issues is stamped with
        ``generation`` so a superseded gang can never complete a
        collective against the re-formed group."""
        from ray_tpu_torch.util import collective

        collective.init_collective_group(
            self.world_size, self.rank, group_name=group_name,
            gang=gang, generation=generation)
        return self.rank

    def gang_barrier(self, group_name: str, tag: str = "") -> int:
        """One barrier on the gang collective group. Fires the
        ``train.collective.r<rank>`` failpoint in the gap between
        rendezvous (``join_gang_collectives`` returning) and entering
        the op — the exact window the rendezvous-gap chaos schedule
        kills a member in."""
        from ray_tpu_torch._private import failpoints
        from ray_tpu_torch.util import collective

        failpoints.fire("train.collective", key=f"r{self.rank}")
        collective.barrier(group_name=group_name)
        return self.rank

    def gang_allreduce(self, value, group_name: str):
        """Allreduce on the gang collective group (same failpoint gap
        as :meth:`gang_barrier`)."""
        from ray_tpu_torch._private import failpoints
        from ray_tpu_torch.util import collective

        failpoints.fire("train.collective", key=f"r{self.rank}")
        return collective.allreduce(value, group_name=group_name)

    def host_barrier(self, name: str, timeout_s: float = 60.0) -> int:
        """Gang barrier over the host-collective tier (KV-backed — no
        accelerator runtime needed): every rank blocks until all
        ``world_size`` ranks arrive. ``name`` must be FRESH per barrier
        (rounds of a dead group's KV slots would satisfy a reused name).
        The rendezvous-chaos tests drive this as the 'first collective'
        a killed member never reaches."""
        from ray_tpu_torch.parallel.collectives import HostCollectiveGroup

        HostCollectiveGroup(name, self.world_size, self.rank).barrier(
            timeout=timeout_s)
        return self.rank


class WorkerGroupFormationError(TimeoutError):
    """Placement-group reservation for the gang timed out — the cluster
    lacks the capacity right now. Distinct from other timeouts (e.g. a
    rendezvous GetTimeoutError) so elastic trainers can degrade on THIS
    and only this."""


class WorkerGroupMemberLost(RuntimeError):
    """A gang member died between rendezvous and (or during) a
    collective. Detection is PUSHED: the group registers its membership
    with the GCS at formation, and any member death publishes a
    ``gang:<name>`` event the group's watcher (and the collective
    coordinator) receive in event time. Survivors blocked in a
    gang-bound shm collective unwedge themselves (their pending op
    raises ``CollectiveMemberLost``); ranks wedged in a
    non-cooperative tier (torch.distributed, host KV barriers) are
    SIGKILLed after ``gang_abort_grace_s``. The documented contract
    (README "Fault plane"): a member loss at N>2 fails FAST with this
    error — never by waiting out ``collective_timeout_s`` — and the
    group re-forms at the surviving size (generation+1) from the last
    checkpoint."""

    def __init__(self, lost_ranks, world_size: int, cause: str = "",
                 generation: int = 0, stage_idx: Optional[int] = None):
        self.lost_ranks = sorted(lost_ranks)
        self.world_size = world_size
        self.generation = generation
        self.cause = cause
        # pp×fsdp scope tag: when this group is ONE pipeline stage's
        # fsdp submesh (WorkerGroup(stage_idx=...)), the loss names the
        # stage so the trainer's escalation can pick the min-cost
        # recovery — reshape THIS stage's submesh at N−k (params
        # restorable from the stage's own checkpoint shard) vs re-split
        # the whole pipeline at pp−1 (only when the stage is gone).
        self.stage_idx = stage_idx
        scope = (f", stage {stage_idx} submesh" if stage_idx is not None
                 else "")
        super().__init__(
            f"worker group lost rank(s) {self.lost_ranks} of "
            f"{world_size}{scope} (generation {generation}) "
            f"{('— ' + cause) if cause else ''}".strip())

    def __reduce__(self):
        return (type(self), (self.lost_ranks, self.world_size,
                             self.cause, self.generation, self.stage_idx))


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 env_per_worker: Optional[List[Dict[str, str]]] = None,
                 formation_timeout_s: float = 120.0,
                 gang_name: Optional[str] = None,
                 stage_idx: Optional[int] = None):
        import uuid as _uuid

        self.num_workers = num_workers
        # pp×fsdp scope: this group is pipeline stage `stage_idx`'s fsdp
        # submesh. Member losses carry the tag so the escalation ladder
        # can separate submesh-level loss (reshape this stage at N−k)
        # from stage-level loss (re-split the pipeline at pp−1).
        self.stage_idx = stage_idx
        # Stable gang name => monotonic generation across re-formations
        # (the trainer passes its run name); an auto name still registers
        # so membership-loss pushes work for ad-hoc groups. A staged
        # group defaults to a per-stage suffix so each stage's submesh
        # has its own generation line.
        if gang_name is None:
            gang_name = f"wg-{_uuid.uuid4().hex[:8]}"
        elif stage_idx is not None:
            gang_name = f"{gang_name}-s{stage_idx}"
        self.gang_name = gang_name
        self.generation = 0
        self._gang_lost = threading.Event()
        self._gang_lost_info: Optional[dict] = None
        self._gang_draining_info: Optional[dict] = None
        self._gang_sub = None
        self._collective_group: Optional[str] = None
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        for b in bundles:
            if not b:
                b["CPU"] = 1.0
        self.pg = placement_group(bundles, strategy=placement_strategy)
        if not self.pg.wait(formation_timeout_s):
            remove_placement_group(self.pg)
            raise WorkerGroupFormationError(
                f"could not reserve {num_workers} x {resources_per_worker} "
                f"(cluster resources: {ray_tpu_torch.cluster_resources()})")
        env_per_worker = env_per_worker or [{} for _ in range(num_workers)]
        self.workers = []
        # Everything past the reservation must not leak on failure: a
        # formation ping that raises (a worker crashed in __init__, the
        # cluster lost a node mid-spawn) used to strand the placement
        # group AND the spawned actors forever.
        try:
            from ray_tpu_torch._private import failpoints

            for rank in range(num_workers):
                res = dict(resources_per_worker)
                cpu = res.pop("CPU", 0)
                gpu = res.pop("GPU", 0)
                w = TrainWorker.options(
                    num_cpus=cpu, num_gpus=gpu, resources=res or None,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=self.pg,
                        placement_group_bundle_index=rank),
                ).remote(rank, num_workers, env_per_worker[rank])
                self.workers.append(w)
            ray_tpu_torch.get([w.ping.remote() for w in self.workers])
            failpoints.fire("gang.form")
            self._register_gang()
        except WorkerGroupFormationError:
            raise
        except Exception as e:  # noqa: BLE001 — any formation failure
            self._teardown_members()
            raise WorkerGroupFormationError(
                f"worker group formation failed for {num_workers} x "
                f"{resources_per_worker}: {e}") from e
        self._start_gang_watcher()

    # ---------------------------------------------------- gang fault plane

    def _register_gang(self):
        """Register membership with the GCS: the gang record is what
        turns member death/drain lifecycle events into pushes, and the
        returned generation stamps every collective this group runs."""
        from ray_tpu_torch._private.worker import global_worker

        # The formation wrap (__init__) runs _teardown_members ->
        # _deregister_gang on ANY failure past this point, and
        # driver-exit GC retires owned gangs as the backstop — the
        # caller owns this error path, which the per-function pass
        # cannot see.
        reply = global_worker().request_gcs(  # raylint: disable=RTL161 (caller's formation wrap deregisters)
            {"t": "gang_register", "name": self.gang_name,
             "members": [w._id.binary() for w in self.workers]},
            timeout=30)
        if not reply.get("ok"):
            raise RuntimeError(
                f"gang registration failed: {reply.get('err')}")
        self.generation = int(reply["generation"])

    def _start_gang_watcher(self):
        """Driver-side membership watcher: one thread on the gang's
        pubsub channel. ``run_collective`` checks the event every poll
        tick, so detection latency is push latency + at most one tick —
        never the actor-state poll path, never the collective timeout."""

        def watch():
            from ray_tpu_torch.util.pubsub import Subscriber

            try:
                sub = Subscriber(f"gang:{self.gang_name}")
            except Exception:
                return  # cluster tearing down
            self._gang_sub = sub
            for item in sub:
                m = item.get("message") or {}
                if m.get("generation") != self.generation:
                    continue
                if m.get("event") == "member_lost":
                    self._gang_lost_info = m
                    self._gang_lost.set()
                elif m.get("event") == "member_draining":
                    self._gang_draining_info = m

        threading.Thread(target=watch, daemon=True,
                         name=f"gang-watch-{self.gang_name}").start()

    def _deregister_gang(self):
        from ray_tpu_torch._private.worker import global_worker

        try:
            global_worker().request_gcs(
                {"t": "gang_deregister", "name": self.gang_name,
                 "generation": self.generation}, timeout=10)
        except Exception:
            pass  # GCS down / already gone — driver-exit GC covers it

    def membership(self) -> dict:
        """Probe the gang record (the trainer's escalation step between
        a collective timeout and a reshape decision)."""
        from ray_tpu_torch._private.worker import global_worker

        return global_worker().request_gcs(
            {"t": "gang_info", "name": self.gang_name}, timeout=10)

    def draining_notice(self) -> Optional[dict]:
        """The latest member_draining push for this generation, if any."""
        return self._gang_draining_info

    def setup_gang_collectives(self, timeout: float = 60.0) -> str:
        """Form the gang-bound shm collective group on every rank. The
        group name carries the generation, so a re-formed gang gets a
        FRESH coordinator (the superseded one is torn down here and on
        shutdown) while generation stamping rejects any stale rank that
        still resolves a live one."""
        group_name = f"{self.gang_name}-g{self.generation}"
        ray_tpu_torch.get([w.join_gang_collectives.remote(
            self.gang_name, self.generation, group_name)
            for w in self.workers], timeout=timeout)
        self._collective_group = group_name
        return group_name

    def _kill_gang_coordinator(self):
        if self._collective_group is None:
            return
        try:
            coord = ray_tpu_torch.get_actor(
                f"_collective_{self._collective_group}")
            ray_tpu_torch.kill(coord)
        except Exception:
            pass
        self._collective_group = None

    def _teardown_members(self):
        # Retire the gang record first: a formation failure AFTER
        # registration succeeded used to strand it until driver-exit GC
        # (RTL161). Harmless pre-registration — generation 0 never
        # matches a live record.
        if self.generation:
            self._deregister_gang()
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass

    def setup_torch(self, backend: Optional[str] = None,
                    timeout: float = 120.0) -> str:
        """Collective torch.distributed rendezvous across ranks; every
        rank, a lone one too, first takes its pinned card as its device.
        Returns the backend."""
        endpoint = ray_tpu_torch.get(
            self.workers[0].coordinator_endpoint.remote())
        addr, _, port = endpoint.rpartition(":")
        return ray_tpu_torch.get(
            [w.setup_torch_distributed.remote(addr, int(port), backend)
             for w in self.workers], timeout=timeout)[0]

    def run_async(self, method: str, *args, **kwargs):
        return [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]

    def run(self, method: str, *args, timeout=None, **kwargs):
        return ray_tpu_torch.get(self.run_async(method, *args, **kwargs),
                           timeout=timeout)

    def _dead_ranks(self):
        from ray_tpu_torch.util import state

        try:
            states = {a["actor_id"]: a["state"] for a in state.list_actors()}
        except Exception:
            return []
        return [rank for rank, w in enumerate(self.workers)
                if states.get(w._id.hex()) in ("dead", "restarting")]

    def _abort_survivors(self, dead):
        """SIGKILL the surviving ranks: a rank blocked inside a wedged
        collective can only be unwedged by killing its process (the exit
        control message is handled on the worker's event loop, but the
        blocked executor thread never returns)."""
        for rank, w in enumerate(self.workers):
            if rank in dead:
                continue
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

    def _fail_member_lost(self, refs, lost_ranks, cause: str):
        """Membership loss observed: give survivors one grace window to
        unwedge themselves (gang-bound shm collectives raise
        ``CollectiveMemberLost`` off the same push), SIGKILL whoever is
        still blocked (non-cooperative tiers: torch.distributed, host KV
        barriers), and raise the typed loss."""
        from ray_tpu_torch._private.config import config as _cfg

        if self._collective_group is not None:
            # Direct coordinator nudge: redundant with its own gang
            # subscription, but free — and it covers a coordinator whose
            # subscription lost the publish race or dropped a frame.
            try:
                coord = ray_tpu_torch.get_actor(
                    f"_collective_{self._collective_group}")
                coord.member_lost.remote(  # raylint: disable=RTL007 — advisory nudge; the grace wait below is the ack
                    [r for r in lost_ranks if isinstance(r, int)],
                    cause, generation=self.generation)
            except Exception:
                pass
        ready, pending = ray_tpu_torch.wait(
            refs, num_returns=len(refs),
            timeout=max(0.0, _cfg().gang_abort_grace_s))
        if pending:
            self._abort_survivors(set(lost_ranks))
        raise WorkerGroupMemberLost(lost_ranks, self.num_workers, cause,
                                    generation=self.generation,
                                    stage_idx=self.stage_idx)

    def run_collective(self, method: str, *args, timeout: float = 300.0,
                       poll_s: float = 0.5, **kwargs):
        """Run ``method`` on every rank, failing FAST on membership loss
        while the gang is (potentially) blocked inside a collective. A
        member killed between rendezvous and the first collective — or
        mid-collective — wedges the survivors in a cross-process wait
        they cannot observe the death from. Detection, in order:

        1. the gang channel push (GCS publishes member death the moment
           the lifecycle event fires — the normal path),
        2. the actor-state poll (backstop: covers a dropped push frame),
        3. a typed error surfacing from a rank that unwedged itself
           (``CollectiveMemberLost`` via the coordinator's own push).

        All three converge on :class:`WorkerGroupMemberLost` well inside
        ``collective_timeout_s``; the caller re-forms the group (usually
        at the surviving world size, generation+1) from its last
        checkpoint."""
        import time as _time

        from ray_tpu_torch._private.serialization import ActorDiedError
        from ray_tpu_torch.util.collective import CollectiveMemberLost

        refs = self.run_async(method, *args, **kwargs)
        deadline = _time.monotonic() + timeout
        while True:
            if self._gang_lost.is_set():
                info = self._gang_lost_info or {}
                self._fail_member_lost(
                    refs, info.get("lost_ranks") or ["unknown"],
                    f"membership push: {info.get('cause', 'member lost')}")
            ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs),
                timeout=min(poll_s, max(0.0, deadline - _time.monotonic())))
            if not pending:
                try:
                    return ray_tpu_torch.get(refs)
                except CollectiveMemberLost as e:
                    # A rank unwedged itself off the coordinator push
                    # before our own watcher ticked: same loss, same
                    # typed failure, no survivor SIGKILL needed.
                    raise WorkerGroupMemberLost(
                        e.lost_ranks, self.num_workers, str(e),
                        generation=self.generation,
                        stage_idx=self.stage_idx) from e
                except (ActorDiedError, ConnectionError) as e:
                    if self._gang_lost.is_set():
                        info = self._gang_lost_info or {}
                        self._fail_member_lost(
                            refs, info.get("lost_ranks") or ["unknown"],
                            f"membership push: "
                            f"{info.get('cause', 'member lost')}")
                    dead = self._dead_ranks()
                    if dead:
                        self._abort_survivors(dead)
                        raise WorkerGroupMemberLost(
                            dead, self.num_workers, str(e),
                            generation=self.generation,
                            stage_idx=self.stage_idx) from e
                    # No MEMBER died: a collective dependency did (the
                    # group's coordinator actor, a dropped link). The
                    # ranks already unwedged with errors — surface the
                    # typed cause without nuking a healthy gang; the
                    # caller re-joins the collective group and retries.
                    raise
            dead = self._dead_ranks()
            if dead:
                self._abort_survivors(dead)
                raise WorkerGroupMemberLost(
                    dead, self.num_workers, "actor-state poll",
                    generation=self.generation,
                    stage_idx=self.stage_idx)
            if _time.monotonic() >= deadline:
                raise TimeoutError(
                    f"collective {method!r} did not complete in "
                    f"{timeout}s ({len(pending)} rank(s) still blocked)")

    def shutdown(self):
        # Deregister FIRST: the teardown kills below are orchestrated,
        # not membership losses — survivors of the same gang name must
        # not see a storm of member_lost pushes for a closing group.
        self._deregister_gang()
        if self._gang_sub is not None:
            try:
                self._gang_sub.close()
            except Exception:
                pass
        self._kill_gang_coordinator()
        self._teardown_members()
