"""Gang-scheduled actor group for SPMD training.

Analog of the reference's ``WorkerGroup`` + ``BackendExecutor``
(``python/ray/train/_internal/worker_group.py:102``,
``backend_executor.py:135``): N actors created inside one placement group,
each hosting a ``TrainWorker`` that runs the user's train loop. The group
co-schedules them, each pinned to its share of a GPU by the runtime, and
wires the ``torch.distributed`` rendezvous (NCCL on CUDA by default, gloo
when asked or on the CPU). The gang fault plane (membership pushes, gang
collectives, typed member-loss recovery) is not ported: ROADMAP A9.
"""

from __future__ import annotations

import traceback
from typing import Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.util import PlacementGroupSchedulingStrategy, placement_group, remove_placement_group


@ray_tpu_torch.remote
class TrainWorker:
    """One training host-process."""

    def __init__(self, rank: int, world_size: int):
        self.rank = rank
        self.world_size = world_size

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
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "err": f"{e}", "err_type": type(e).__name__,
                    "tb": traceback.format_exc()}
        finally:
            session_mod.shutdown_session()

    def ping(self):
        return True

    def pid(self) -> int:
        import os as _os

        return _os.getpid()

    def join_gang_collectives(self, gang: str, generation: int,
                              group_name: str) -> int:
        from .._private.roadmap import not_ported

        raise not_ported("gang collectives", "gang")


class WorkerGroupFormationError(TimeoutError):
    """Placement-group reservation for the gang timed out — the cluster
    lacks the capacity right now. Distinct from other timeouts (e.g. a
    rendezvous GetTimeoutError)."""


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 formation_timeout_s: float = 120.0):
        self.num_workers = num_workers
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
                ).remote(rank, num_workers)
                self.workers.append(w)
            ray_tpu_torch.get([w.ping.remote() for w in self.workers])
            failpoints.fire("gang.form")
        except WorkerGroupFormationError:
            raise
        except Exception as e:  # noqa: BLE001 — any formation failure
            self._teardown_members()
            raise WorkerGroupFormationError(
                f"worker group formation failed for {num_workers} x "
                f"{resources_per_worker}: {e}") from e

    # ---------------------------------------------------- gang fault plane

    def setup_gang_collectives(self, timeout: float = 60.0) -> str:
        from .._private.roadmap import not_ported

        raise not_ported("setup_gang_collectives", "gang")

    def _teardown_members(self):
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

    def run_collective(self, method: str, *args, timeout: float = 300.0,
                       poll_s: float = 0.5, **kwargs):
        from .._private.roadmap import not_ported

        raise not_ported("run_collective (typed member-loss recovery)",
                         "gang")

    def shutdown(self):
        self._teardown_members()
