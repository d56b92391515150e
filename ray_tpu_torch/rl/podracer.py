"""Podracer (Sebulba) three-tier IMPALA riding the private planes.

Port of ``ray_tpu/rl/podracer.py``. The learner tier is one
``PodLearnerActor`` whose ``VtraceMeshLearner`` runs the update of a
``learner_mesh_devices``-rank mesh on its lease's device: with
``learners(use_gpu=True)`` it leases one whole card (``{"num_gpus": 1}``)
whatever the mesh size, and a pixel module's attention runs the flash
kernels there. Runners lease no GPU unless placed on one and run their
forwards on the CPU, as the JAX design runs them on the host.

Reference: "Podracer architectures for scalable RL" (Hessel et al.,
PAPERS.md) — the Sebulba split: many env-runner actors batch rollouts,
an aggregation tier concatenates them into learner-shaped batches and
keeps the learner queue full, and ONE process drives the whole learner
mesh, with weight broadcast as the staleness-bounded back-edge. The
driver is control plane only; payload bytes never route through it
after the initial weight publish.

Tier diagram (one host or many)::

    PodRunner x N  --rollout refs-->  PodAggregator x M
        ^           (resolved in the     |  time-major batch rides the
        | pull       aggregator worker:  |  PR 3 DIRECT ARG LANE to the
        | (PR 4      worker-to-worker    v  learner actor
        | broadcast  data plane)      PodLearnerActor
        | relay)                      (VtraceMeshLearner, >=4 ranks,
        |                              V-trace inside the step)
        +---- [version, ref] box <---- driver: ONE ray_tpu_torch.put per
              in every dispatch         published version

* **Weights**: per version the driver fetches the learner params once
  and ``put``s them ONCE (``TRANSPORT_STATS["weight_bcast_puts"]`` is
  the proof surface); runners pull the ref through the PR 4 cooperative
  chunk-striped broadcast (egress accounted by ``obj_xfer_stats``) and
  cache by version, so an unchanged version costs zero pulls.
* **Staleness**: every rollout records the ``weights_version`` it was
  collected under; the learner measures ``published_version -
  batch_version`` per rollout at update time — the broadcast staleness
  distribution is data, not a guess.
* **Waits**: the driver's many-in-flight pattern (sample refs +
  aggregator results + learner stats refs) rides ``ray_tpu_torch.wait`` — the
  PR 5 batched ``obj_waits`` wait groups — one frame per burst.

Fault model (certified by the ``impala_runner_kill`` chaos schedule):
a SIGKILLed runner errors its in-flight rollout refs (the wait group
resolves — never stalls); the poisoned aggregation surfaces at the
aggregator result, the driver restarts dead runners (fresh incarnation
seed), re-subscribes surviving rollout refs into the next bucket, and
training continues on the survivors throughout.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig, make_env
from .env_runner import EnvRunnerGroup, EnvRunnerImpl
from .rl_module import MLPModuleConfig, PixelModuleConfig


class PodRunnerImpl(EnvRunnerImpl):
    """Env runner for the Podracer tier: pulls weights from the
    versioned broadcast box (cached by version) and returns time-major
    rollouts stamped with the version they were collected under."""

    def __init__(self, env_id, num_envs, module_cfg_blob, seed=0,
                 env_fn_blob=None, rank: int = 0):
        super().__init__(env_id, num_envs, module_cfg_blob, seed,
                         env_fn_blob)
        self.rank = rank
        self._params = None
        self._weights_version = -1
        self._pull_s: List[float] = []
        self._rollout_s: List[Tuple[float, int]] = []

    def run_rollout(self, wbox, num_steps: int) -> Dict[str, np.ndarray]:
        """``wbox = [version, weights_ref]`` — the ref rides INSIDE a
        list so the arg loader does not resolve it; the pull below is
        the cooperative broadcast under test, and it only happens when
        the version actually changed."""
        from ray_tpu_torch._private import failpoints
        from ray_tpu_torch.util import events as plane_events

        if failpoints.active():
            failpoints.fire("podracer.sample", f"r{self.rank}")
        version, ref = wbox
        if version != self._weights_version:
            # the pull IS the broadcast plane (chunk-striped, relayed)
            t0 = time.time()
            self._params = self._on_device(
                ray_tpu_torch.get(ref))  # raylint: disable=RTL001
            self._pull_s.append(time.time() - t0)
            plane_events.emit(
                "rl.weights.pull", plane="rl", dur=time.time() - t0,
                tenant=plane_events.process_tenant(),
                rank=self.rank, version=int(version),
                staleness=int(version) - int(self._weights_version))
            self._weights_version = version
        t0 = time.time()
        out = self._collect(self._params, num_steps)
        out["weights_version"] = int(version)
        self._rollout_s.append((time.time() - t0, int(num_steps)))
        # Tenant tag: rollout egress is one of the traffic classes the
        # SLO interference detector attributes breaches to.
        plane_events.emit("rl.rollout.push", plane="rl",
                          dur=time.time() - t0, rank=self.rank,
                          tenant=plane_events.process_tenant(),
                          steps=int(num_steps), version=int(version))
        return out

    def timings(self) -> Dict[str, list]:
        """This incarnation's weight pulls (s) and ms an env step of each
        rollout (all ``num_envs`` envs stepped once, the forward
        included)."""
        return {"pull_s": list(self._pull_s),
                "env_step_ms": [1e3 * s / n for s, n in self._rollout_s]}


PodRunner = ray_tpu_torch.remote(PodRunnerImpl)


class PodRunnerGroup(EnvRunnerGroup):
    """Runner tier: driver-managed replacement (no actor auto-restart —
    the driver owns recovery so a kill is a measured event, not a
    silent revival), incarnation-salted seeds so a replacement explores
    fresh state."""

    def __init__(self, env_id: str, num_runners: int,
                 num_envs_per_runner: int, module_cfg, env_fn=None,
                 seed: int = 0):
        import cloudpickle

        self.env_id = env_id
        self.num_envs_per_runner = num_envs_per_runner
        self._incarnation = [0] * num_runners
        self._seed = seed
        blob = cloudpickle.dumps(module_cfg)
        efb = cloudpickle.dumps(env_fn) if env_fn is not None else None
        self._make = lambda i: PodRunner.options(
            **self._runner_opts(i)).remote(
            env_id, num_envs_per_runner, blob,
            self._seed + i + 9973 * self._incarnation[i], efb, rank=i)
        self._placement: List[dict] = [{} for _ in range(num_runners)]
        self.runners = [self._make(i) for i in range(num_runners)]
        ray_tpu_torch.get([r.ping.remote() for r in self.runners])

    def _runner_opts(self, i: int) -> dict:
        return dict(self._placement[i])

    def set_placement(self, placements: List[dict]):
        """Per-runner actor options (e.g. ``{"resources": {...}}``) for
        multi-node benches; applies to runners created AFTER the call."""
        self._placement = list(placements)

    def restart_runner(self, i: int):
        self._incarnation[i] += 1
        self.runners[i] = self._make(i)
        return self.runners[i]


@ray_tpu_torch.remote
class PodAggregator:
    """Aggregation tier: rollout refs resolve in THIS worker (the
    runner->aggregator hop is worker-to-worker data plane, no driver
    copy), the concatenated time-major batch is pushed straight to the
    learner actor — riding the PR 3 direct arg lane when it fits under
    ``direct_arg_threshold`` — and only a ref-sized summary returns to
    the driver."""

    def __init__(self, learner):
        self.learner = learner
        self.batches_built = 0

    def ping(self) -> bool:
        return True

    def transport_stats(self) -> Dict[str, int]:
        """This process's data-plane counters — the direct-arg-lane
        evidence lives HERE (the batch push is aggregator->learner;
        driver-side counters never see it)."""
        from ray_tpu_torch._private import serialization

        return serialization.transport_stats()

    def push(self, *rollouts) -> Dict[str, Any]:
        keys = ("obs", "actions", "logp", "rewards", "dones", "mask")
        batch = {k: np.concatenate([r[k] for r in rollouts], axis=1)
                 for k in keys}  # concat along env axis: [T, sum_N, ...]
        batch["bootstrap_value"] = np.concatenate(
            [r["bootstrap_value"] for r in rollouts], axis=0)
        versions = [int(r["weights_version"]) for r in rollouts]
        batch["weights_versions"] = np.asarray(versions, np.int64)
        T, B = batch["rewards"].shape
        nbytes = sum(v.nbytes for v in batch.values())
        stats_ref = self.learner.update_on.remote(batch)
        self.batches_built += 1
        return {"stats_ref": stats_ref, "env_steps": int(T * B),
                "versions": versions, "batch_bytes": int(nbytes)}


@ray_tpu_torch.remote
class PodLearnerActor:
    """Learner tier: a V-trace mesh learner plus the version /
    staleness bookkeeping. ``update_on`` calls arrive from aggregators;
    ``publish_weights`` from the driver — the actor mailbox serializes
    them, so a publish observes every update queued before it."""

    def __init__(self, module_cfg_blob: bytes, hparams: dict,
                 n_devices: int = 4, seed: int = 0):
        import cloudpickle

        from .learner import lease_device
        from .mesh_learner import VtraceMeshLearner

        self.learner = VtraceMeshLearner(
            cloudpickle.loads(module_cfg_blob), hparams,
            n_devices=n_devices, seed=seed, device=lease_device())
        self.published_version = 0
        self.updates_done = 0
        self._staleness: Dict[int, int] = {}

    def ping(self) -> bool:
        return True

    def update_on(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        versions = batch.pop("weights_versions")
        env_steps = int(batch["rewards"].size)
        stats = self.learner.update(batch)
        self.updates_done += 1
        stal = [int(self.published_version - v) for v in versions]
        for s in stal:
            self._staleness[s] = self._staleness.get(s, 0) + 1
        return {"stats": stats, "staleness": stal,
                "updates_done": self.updates_done, "env_steps": env_steps}

    def publish_weights(self) -> Tuple[int, Any]:
        """Bump the published version and hand the driver the params to
        ``put`` — staleness is measured against THIS counter."""
        self.published_version += 1
        return self.published_version, self.learner.get_weights()

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params):
        return self.learner.set_weights(params)

    def staleness_counts(self) -> Dict[int, int]:
        return dict(self._staleness)


class Podracer(Algorithm):
    """Driver: pure control plane over the three tiers.

    One event loop multiplexes {sample refs, aggregator result refs,
    learner stats refs} through batched ``ray_tpu_torch.wait`` groups; each
    completion is handled O(1): ready rollouts bucket toward
    ``agg_fanin``, full buckets dispatch to the aggregator tier gated on
    ``queue_depth`` (learner backpressure), completed updates publish
    weights every ``broadcast_interval`` via one driver put."""

    _uses_learner_group = False

    def __init__(self, config: "PodracerConfig"):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        probe = self._probe_env_spaces()
        self._build_module_and_runners(probe)
        ray_tpu_torch.get(self.learner.ping.remote())
        self.aggregators = [PodAggregator.remote(self.learner)
                            for _ in range(config.num_aggregators)]
        ray_tpu_torch.get([a.ping.remote() for a in self.aggregators])
        self._agg_rr = 0
        # dataflow state
        self._inflight: Dict[Any, Tuple[int, int]] = {}  # sample ref
        self._backlog: List[Tuple[Any, int]] = []        # (ref, version)
        self._agg_inflight: Dict[Any, List[Any]] = {}    # res ref -> refs
        self._learner_inflight: Dict[Any, float] = {}    # stats ref -> t
        # metrics
        self._updates_done = 0
        self._env_steps_this_iter = 0
        self._staleness: Dict[int, int] = {}
        self._occupancy: List[int] = []
        self._runner_restarts = 0
        self._agg_replacements = 0
        self._last_stats: Dict[str, float] = {}
        # the newest updates' stats, one dict an update
        self._stats_log: collections.deque = collections.deque(maxlen=256)
        self._updates_since_broadcast = 0
        self._wbox = None
        self._published_version = 0
        self._publish_s: List[Tuple[float, float]] = []
        self._publish_weights()

    # ------------------------------------------------------------ build

    def _probe_env_spaces(self) -> dict:
        env = make_env(self.config)
        shape = env.observation_space.shape
        num_actions = int(env.action_space.n)
        env.close()
        return {"shape": tuple(shape), "num_actions": num_actions,
                "obs_dim": int(np.prod(shape))}

    def _build_module_and_runners(self, probe: dict):
        config = self.config
        shape = probe["shape"]
        if len(shape) == 3 and shape[0] == shape[1]:
            # Image observations -> the ViT pixel path.
            m = config.pixel_model or {}
            self.module_cfg = PixelModuleConfig(
                image_size=shape[0], channels=shape[2],
                num_actions=probe["num_actions"], **m)
        else:
            self.module_cfg = MLPModuleConfig(
                obs_dim=probe["obs_dim"],
                num_actions=probe["num_actions"], hidden=config.hidden)
        self._start_learners()
        self.env_runner_group = PodRunnerGroup(
            config.env, config.num_env_runners,
            config.num_envs_per_env_runner, self.module_cfg,
            env_fn=config.env_fn, seed=config.seed)

    def _start_learners(self):
        """The learner actor, created before the runners so that its start
        (the card's lease, a CUDA context, the weights) overlaps theirs."""
        import cloudpickle

        config = self.config
        n_dev = config.learner_mesh_devices or 4
        opts = {"num_gpus": 1} if config.use_gpu else {}
        self.learner = PodLearnerActor.options(**opts).remote(
            cloudpickle.dumps(self.module_cfg), config.hparams(),
            n_devices=n_dev, seed=config.seed)

    # --------------------------------------------------------- dataflow

    def _publish_weights(self):
        from ray_tpu_torch._private import serialization

        t0 = time.perf_counter()
        version, weights = ray_tpu_torch.get(
            self.learner.publish_weights.remote(), timeout=300)
        t1 = time.perf_counter()
        ref = ray_tpu_torch.put(weights)
        serialization.TRANSPORT_STATS["weight_bcast_puts"] += 1
        self._publish_s.append((t1 - t0, time.perf_counter() - t1))
        self._wbox = [int(version), ref]
        self._published_version = int(version)
        self._updates_since_broadcast = 0

    def _refill(self):
        cfg = self.config
        cap = cfg.agg_fanin * max(2, cfg.queue_depth)
        if len(self._backlog) >= cap:
            return  # learner-side backpressure: stop sampling, not drop
        busy = {idx for idx, _ in self._inflight.values()}
        for i, runner in enumerate(self.env_runner_group.runners):
            if i in busy:
                continue
            ref = runner.run_rollout.remote(
                self._wbox, cfg.rollout_fragment_length)
            self._inflight[ref] = (i, self._published_version)

    def _dispatch_buckets(self):
        cfg = self.config
        while (len(self._backlog) >= cfg.agg_fanin
               and (len(self._agg_inflight) + len(self._learner_inflight)
                    < cfg.queue_depth)):
            bucket = [self._backlog.pop(0) for _ in range(cfg.agg_fanin)]
            agg = self.aggregators[self._agg_rr % len(self.aggregators)]
            self._agg_rr += 1
            refs = [r for r, _ in bucket]
            res = agg.push.remote(*refs)
            self._agg_inflight[res] = refs

    def _handle_agg_result(self, res_ref):
        rollout_refs = self._agg_inflight.pop(res_ref)
        try:
            out = ray_tpu_torch.get(res_ref, timeout=60)
        except Exception:
            self._recover(rollout_refs)
            return
        self._learner_inflight[out["stats_ref"]] = time.monotonic()

    def _handle_learner_stats(self, stats_ref):
        self._learner_inflight.pop(stats_ref)
        try:
            out = ray_tpu_torch.get(stats_ref, timeout=300)
        except Exception:
            # The stats ref is OWNED by the aggregator that pushed the
            # batch: an aggregator dying after the driver harvested its
            # push result but before this collect dereferences it. The
            # update may well have landed on the learner — only its
            # receipt is lost. Heal the tiers and move on; crashing the
            # loop here would defeat the recovery path.
            self._recover([])
            return
        self._updates_done += 1
        self._updates_since_broadcast += 1
        self._total_env_steps += out["env_steps"]
        self._env_steps_this_iter += out["env_steps"]
        self._last_stats = out["stats"]
        self._stats_log.append(out["stats"])
        for s in out["staleness"]:
            self._staleness[s] = self._staleness.get(s, 0) + 1
        if self._updates_since_broadcast >= self.config.broadcast_interval:
            self._publish_weights()

    def _recover(self, rollout_refs: List[Any]):
        """A poisoned aggregation: restart dead runners, drop errored
        rollout refs, re-subscribe survivors into the next bucket, and
        replace any dead aggregator (the re-subscribe half of the
        ``impala_runner_kill`` certification)."""
        pings = [r.ping.remote() for r in self.env_runner_group.runners]
        ray_tpu_torch.wait(pings, num_returns=len(pings), timeout=15)
        dead = set()
        for i, ref in enumerate(pings):
            try:
                ray_tpu_torch.get(ref, timeout=5)
            except Exception:
                dead.add(i)
                self.env_runner_group.restart_runner(i)
                self._runner_restarts += 1
        # In-flight samples on a replaced runner's OLD handle can only
        # error — drop them now so the index redispatches immediately.
        for ref, (idx, _v) in list(self._inflight.items()):
            if idx in dead:
                del self._inflight[ref]
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        for ref in rollout_refs:
            # Classify WITHOUT routing rollout bytes through the driver:
            # a dead runner's ref resolved as an inline error blob
            # (errors never ride shm), while a real rollout resolved as
            # a shm payload — only the inline case needs a (local,
            # cheap) get to surface the error.
            fut = w.object_future(ref.id)
            if fut.done() and fut._value and fut._value[0] == "inline":
                try:
                    ray_tpu_torch.get(ref, timeout=5)
                except Exception:
                    continue  # the dead runner's rollout: dropped
            self._backlog.insert(0, (ref, -1))
        apings = [a.ping.remote() for a in self.aggregators]
        ray_tpu_torch.wait(apings, num_returns=len(apings), timeout=15)
        for j, ref in enumerate(apings):
            try:
                ray_tpu_torch.get(ref, timeout=5)
            except Exception:
                self.aggregators[j] = PodAggregator.remote(self.learner)
                self._agg_replacements += 1

    def step(self, max_wall_s: float = 120.0) -> int:
        """Advance the dataflow until at least one learner update lands
        (or the wall bound passes); returns updates completed."""
        deadline = time.monotonic() + max_wall_s
        before = self._updates_done
        while self._updates_done == before:
            self._refill()
            self._dispatch_buckets()
            all_refs = (list(self._inflight)
                        + list(self._agg_inflight)
                        + list(self._learner_inflight))
            # ONE batched wait-group frame for the whole in-flight set
            # (sample + aggregation + learner futures together); the
            # zero-timeout second wait harvests every completion that
            # already landed, so a burst is drained in one tick.
            ray_tpu_torch.wait(all_refs, num_returns=1, timeout=5)
            ready, _ = ray_tpu_torch.wait(all_refs, num_returns=len(all_refs),
                                    timeout=0)
            self._occupancy.append(len(self._learner_inflight)
                                   + len(self._agg_inflight))
            for ref in ready:
                if ref in self._inflight:
                    _idx, version = self._inflight.pop(ref)
                    self._backlog.append((ref, version))
                elif ref in self._agg_inflight:
                    self._handle_agg_result(ref)
                elif ref in self._learner_inflight:
                    self._handle_learner_stats(ref)
            if time.monotonic() > deadline:
                break
        return self._updates_done - before

    def training_step(self) -> Dict[str, Any]:
        self._env_steps_this_iter = 0
        updates = self.step()
        return {"learner": dict(self._last_stats),
                "num_env_steps_sampled": self._env_steps_this_iter,
                "updates_this_iter": updates,
                "weights_version": self._published_version,
                "inflight": len(self._inflight)}

    # ---------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, Any]:
        from ray_tpu_torch._private import serialization

        occ = self._occupancy or [0]
        return {
            "env_steps": self._total_env_steps,
            "updates": self._updates_done,
            "published_versions": self._published_version,
            "staleness": {str(k): v
                          for k, v in sorted(self._staleness.items())},
            "queue_occupancy": {
                "mean": round(float(np.mean(occ)), 3),
                "max": int(np.max(occ)),
            },
            "runner_restarts": self._runner_restarts,
            # per publish: (learner -> driver s, the driver's put s)
            "publish_s": [list(p) for p in self._publish_s],
            "learner_stats": list(self._stats_log),
            "agg_replacements": self._agg_replacements,
            "transport": serialization.transport_stats(),
            "agg_transport": self._agg_transport(),
        }

    def _agg_transport(self) -> Dict[str, int]:
        """Summed data-plane counters from the aggregator tier (the
        batch->learner pushes ride THEIR processes' direct arg lane)."""
        try:
            stats = ray_tpu_torch.get(
                [a.transport_stats.remote() for a in self.aggregators],
                timeout=30)
        except Exception:
            return {}
        out: Dict[str, int] = {}
        for s in stats:
            for k, v in s.items():
                out[k] = out.get(k, 0) + v
        return out

    # ------------------------------------------------------- lifecycle

    def get_state(self) -> dict:
        return {"weights": ray_tpu_torch.get(
                    self.learner.get_weights.remote()),
                "iteration": self.iteration}

    def set_state(self, state: dict):
        ray_tpu_torch.get(self.learner.set_weights.remote(state["weights"]))
        self.iteration = state.get("iteration", 0)

    def stop(self):
        self.env_runner_group.shutdown()
        for a in self.aggregators:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        try:
            ray_tpu_torch.kill(self.learner)
        except Exception:
            pass


class PodracerConfig(AlgorithmConfig):
    """Fluent config for the Sebulba tier (same builder surface as the
    other algorithms, plus the aggregation knobs)."""

    def __init__(self):
        super().__init__(Podracer)
        self.num_aggregators = 1
        self.agg_fanin = 2
        self.queue_depth = 4
        self.broadcast_interval = 1
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.vtrace_lambda = 1.0
        self.learner_mesh_devices = 4
        self.pixel_model: Optional[dict] = None

    def aggregation(self, *, num_aggregators: Optional[int] = None,
                    agg_fanin: Optional[int] = None,
                    queue_depth: Optional[int] = None) -> "PodracerConfig":
        if num_aggregators is not None:
            self.num_aggregators = max(1, num_aggregators)
        if agg_fanin is not None:
            self.agg_fanin = max(1, agg_fanin)
        if queue_depth is not None:
            self.queue_depth = max(1, queue_depth)
        return self

    def training(self, *, broadcast_interval=None, vtrace_clip_rho=None,
                 vtrace_clip_c=None, vtrace_lambda=None,
                 pixel_model=None, **kw) -> "PodracerConfig":
        super().training(**kw)
        for name, val in [("broadcast_interval", broadcast_interval),
                          ("vtrace_clip_rho", vtrace_clip_rho),
                          ("vtrace_clip_c", vtrace_clip_c),
                          ("vtrace_lambda", vtrace_lambda),
                          ("pixel_model", pixel_model)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def hparams(self) -> dict:
        hp = super().hparams()
        hp.update({
            "gamma": self.gamma,
            "vtrace_clip_rho": self.vtrace_clip_rho,
            "vtrace_clip_c": self.vtrace_clip_c,
            "vtrace_lambda": self.vtrace_lambda,
        })
        return hp

    def build(self) -> Podracer:
        per_batch = self.agg_fanin * self.num_envs_per_env_runner
        mesh = self.learner_mesh_devices or 4
        if per_batch % mesh:
            raise ValueError(
                f"agg_fanin * num_envs_per_env_runner = {per_batch} must "
                f"divide evenly over the {mesh}-rank learner mesh")
        return Podracer(self)
