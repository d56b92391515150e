"""Chaos-testing harness: component killers + RPC fault injection control.

Analog of the reference's chaos tooling: ``ResourceKillerActor`` /
``WorkerKillerActor`` / ``RayletKiller`` (``python/ray/_private/test_utils.py:
1433,1500,1536``, driven by ``python/ray/tests/test_chaos.py``) and the C++
RPC chaos env-var injection (``src/ray/rpc/rpc_chaos.h:23``, see
``ray_tpu_torch._private.protocol`` for the injection point).

Killer methods are synchronous on purpose: they run on the actor's executor
thread so the state-API round-trips they make don't re-enter the worker's IO
loop. ``max_concurrency=2`` lets ``stop()`` land while ``run()`` loops.
"""

from __future__ import annotations

import os
import random
import signal
import time

import ray_tpu_torch


@ray_tpu_torch.remote
class WorkerKillerActor:
    """Kills busy task-worker processes on an interval (SIGKILL), exercising
    task retries. Runs until ``stop()``. Victim choice is driven by the
    ``seed`` — ``schedule()`` reports it with the kill list so any red
    chaos run reproduces from one command (repro ergonomics)."""

    def __init__(self, kill_interval_s: float = 0.3,
                 max_kills: int = 1_000_000, seed: int = 0):
        self.kill_interval_s = kill_interval_s
        self.max_kills = max_kills
        self.killed_pids = []
        self._stop = False
        self.seed = seed
        self._rng = random.Random(seed)

    def run(self):
        from ray_tpu_torch.util import state

        while not self._stop and len(self.killed_pids) < self.max_kills:
            try:
                victims = [w for w in state.list_workers()
                           if w["state"] == "busy" and w["pid"] != os.getpid()]
            except Exception:
                victims = []
            if victims:
                victim = self._rng.choice(victims)
                try:
                    os.kill(victim["pid"], signal.SIGKILL)
                    self.killed_pids.append(victim["pid"])
                except (ProcessLookupError, PermissionError):
                    pass
            time.sleep(self.kill_interval_s)
        return len(self.killed_pids)

    def stop(self):
        self._stop = True
        return list(self.killed_pids)

    def kills(self):
        return list(self.killed_pids)

    def schedule(self):
        """Reproduction record: the seed that drove victim choice plus
        what actually died, printable on any failing chaos run."""
        return {"seed": self.seed, "killed_pids": list(self.killed_pids)}


@ray_tpu_torch.remote
class ActorKillerActor:
    """Kills alive actor workers (except itself and excluded names) on an
    interval, exercising actor restarts. Victim choice rides a private
    seeded RNG (NOT the module-global ``random`` — a workload reseeding
    the global generator must not change the kill schedule)."""

    def __init__(self, kill_interval_s: float = 0.5, exclude=(),
                 seed: int = 0):
        self.kill_interval_s = kill_interval_s
        self.exclude = set(exclude) | {"_chaos_actor_killer",
                                       "_chaos_worker_killer",
                                       "_ray_tpu_job_manager"}
        self.killed = 0
        self.killed_pids = []
        self._stop = False
        self.seed = seed
        self._rng = random.Random(seed)

    def run(self):
        from ray_tpu_torch.util import state

        while not self._stop:
            try:
                victims = [a for a in state.list_actors()
                           if a["state"] == "alive"
                           and a["name"] not in self.exclude
                           and a["pid"] not in (0, os.getpid())]
            except Exception:
                victims = []
            if victims:
                victim = self._rng.choice(victims)
                try:
                    os.kill(victim["pid"], signal.SIGKILL)
                    self.killed += 1
                    self.killed_pids.append(victim["pid"])
                except (ProcessLookupError, PermissionError):
                    pass
            time.sleep(self.kill_interval_s)
        return self.killed

    def stop(self):
        self._stop = True
        return self.killed

    def schedule(self):
        return {"seed": self.seed, "killed_pids": list(self.killed_pids)}


def get_and_run_worker_killer(kill_interval_s: float = 0.3,
                              max_kills: int = 1_000_000):
    """Start a WorkerKillerActor and kick off its kill loop."""
    killer = WorkerKillerActor.options(
        name="_chaos_worker_killer", max_concurrency=2).remote(
            kill_interval_s=kill_interval_s, max_kills=max_kills)
    # the kill loop runs until stop(): fire-and-forget by design
    killer.run.remote()  # raylint: disable=RTL007
    return killer


def get_and_run_actor_killer(kill_interval_s: float = 0.5, exclude=(),
                             seed: int = 0):
    killer = ActorKillerActor.options(
        name="_chaos_actor_killer", max_concurrency=2).remote(
            kill_interval_s=kill_interval_s, exclude=exclude, seed=seed)
    # the kill loop runs until stop(): fire-and-forget by design
    killer.run.remote()  # raylint: disable=RTL007
    return killer


RPC_FAILURE_ENV = "RAY_TPU_TORCH_RPC_FAILURE"


def set_rpc_failure(spec: str):
    """Enable client-side RPC chaos in THIS process.

    ``spec`` is ``"type=prob,type=prob"`` — e.g. ``"actor_call=0.2"`` makes
    20% of outgoing actor_call frames fail with a connection error before
    hitting the wire (reference: ``RAY_testing_rpc_failure``,
    ``rpc_chaos.h:23``). Empty string disables.
    """
    from ray_tpu_torch._private import protocol

    os.environ[RPC_FAILURE_ENV] = spec
    protocol.reload_rpc_chaos()


def clear_rpc_failure():
    set_rpc_failure("")


# ----------------------------------------------- deterministic failpoints
# The seeded named-site injection registry (``_private/failpoints.py``) —
# re-exported here so chaos drivers arm schedules and print repro records
# from one import. ``set_failpoints`` exports through the env, so worker/
# agent processes spawned AFTER the call inherit the schedule.

from ray_tpu_torch._private.failpoints import (  # noqa: E402,F401
    FailpointError, clear_failpoints, fired_schedule, format_schedule,
    set_failpoints)
