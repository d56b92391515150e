"""IMPALA: async sampling + v-trace learner + optional aggregation tier.

Port of ``ray_tpu/rl/impala.py``: the driver's V-trace pass runs the
module's forward in torch on the learner's weights (CPU tensors).

Reference: ``rllib/algorithms/impala/impala.py:606-700`` — env runners
sample continuously and return episode *refs*; an optional aggregation
actor tier batches them; the learner updates asynchronously off the queue
and weights broadcast periodically rather than every pass. Same dataflow
here: the driver keeps ``num_env_runners`` sample requests in flight
(``ray_tpu_torch.wait`` on the ref pool), aggregators concatenate k rollouts
into train batches inside worker processes (off the driver), and the
learner consumes whatever is ready each ``training_step``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from .algorithm import Algorithm, AlgorithmConfig
from .vtrace import vtrace


def policy_logp_values(params, flat_obs: np.ndarray):
    """The MLP module's log-probabilities [N, A] and values [N] of
    ``flat_obs``, numpy, computed on the params' device."""
    import torch

    from . import rl_module

    with torch.no_grad():
        logits, values = rl_module.forward(
            params, rl_module.as_obs(flat_obs, rl_module.params_device(
                params)))
        return (torch.log_softmax(logits, dim=-1).cpu().numpy(),
                values.cpu().numpy())


@ray_tpu_torch.remote
class _Aggregator:
    """Batches rollout refs into a learner-ready train batch (reference:
    IMPALA aggregation workers, ``impala.py:637-643``)."""

    def ping(self) -> bool:
        return True

    def build_batch(self, *rollouts) -> Dict[str, np.ndarray]:
        keys = ("obs", "actions", "logp", "rewards", "dones", "values",
                "mask")
        out = {k: np.concatenate([r[k] for r in rollouts], axis=1)
               for k in keys}  # concat along env axis: [T, sum_N, ...]
        out["bootstrap_value"] = np.concatenate(
            [r["bootstrap_value"] for r in rollouts], axis=0)
        return out


class IMPALA(Algorithm):
    """Async training_step: drain ready rollouts, vtrace-correct, update."""

    def __init__(self, config: "IMPALAConfig"):
        super().__init__(config)
        self.aggregators = [
            _Aggregator.remote()
            for _ in range(config.num_aggregation_workers)]
        self._agg_rr = 0
        self._inflight: Dict[Any, int] = {}  # sample ref -> runner idx
        self._weights_ref = self.learner_group.get_weights_ref()
        self._updates_since_broadcast = 0

    def _refill(self):
        cfg = self.config
        want = len(self.env_runner_group.runners)
        while len(self._inflight) < want:
            busy = set(self._inflight.values())
            idle = [i for i in range(want) if i not in busy]
            if not idle:
                break
            i = idle[0]
            r = self.env_runner_group.runners[i]
            ref = r.sample.remote(self._weights_ref,
                                  cfg.rollout_fragment_length)
            self._inflight[ref] = i

    def _vtrace_train_batch(self, batch):
        """V-trace-corrected train batch from a behaviour-policy rollout
        batch. IMPALA corrects against the CURRENT policy (ratio 1 in the
        downstream surrogate => pure vtrace policy gradient); APPO
        overrides to keep the behaviour logp for its clipped surrogate and
        to target-network the values."""
        cfg = self.config
        cur = ray_tpu_torch.get(self.learner_group.get_weights_ref())
        T, N = batch["rewards"].shape
        flat_obs = batch["obs"].reshape(T * N, -1).astype(np.float32)
        logp_all, values = policy_logp_values(cur, flat_obs)
        tgt_logp = logp_all[
            np.arange(T * N), batch["actions"].reshape(-1).astype(np.int64)
        ].reshape(T, N)
        tgt_values = values.reshape(T, N)
        vs, pg_adv = vtrace(
            batch["logp"], tgt_logp, batch["rewards"], tgt_values,
            batch["dones"], batch["bootstrap_value"], cfg.gamma,
            cfg.vtrace_clip_rho, cfg.vtrace_clip_c, cfg.vtrace_lambda)
        flat = lambda x: x.reshape(T * N, *x.shape[2:])  # noqa: E731
        keep = flat(batch["mask"]) if "mask" in batch else \
            np.ones(T * N, bool)
        train_batch = {
            "obs": flat_obs[keep],
            "actions": flat(batch["actions"])[keep],
            "logp": flat(tgt_logp).astype(np.float32)[keep],
            "advantages": flat(pg_adv)[keep],
            "returns": flat(vs)[keep],
            "values": flat(tgt_values)[keep],
        }
        return train_batch, T, N

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self._refill()
        refs = list(self._inflight)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=30)
        rollouts = [(self._inflight.pop(ref), ref) for ref in ready]
        if not rollouts:
            return {"learner": {}, "num_env_steps_sampled": 0}
        try:
            # Aggregation tier (refs pass through; resolved in the worker).
            if self.aggregators:
                agg = self.aggregators[self._agg_rr % len(self.aggregators)]
                self._agg_rr += 1
                batch = ray_tpu_torch.get(
                    agg.build_batch.remote(*[r for _, r in rollouts]),
                    timeout=300)
            else:
                parts = ray_tpu_torch.get([r for _, r in rollouts],
                                          timeout=300)
                keys = ("obs", "actions", "logp", "rewards", "dones",
                        "values", "mask")
                batch = {k: np.concatenate([p[k] for p in parts], axis=1)
                         for k in keys}
                batch["bootstrap_value"] = np.concatenate(
                    [p["bootstrap_value"] for p in parts], axis=0)
        except (ray_tpu_torch.ActorDiedError, ray_tpu_torch.WorkerCrashedError,
                ray_tpu_torch.ObjectLostError):
            # A sampler or aggregator died mid-round: replace the dead
            # actor(s), drop this round (FaultAwareApply restart semantics).
            for i, ref in rollouts:
                try:
                    ray_tpu_torch.get(ref, timeout=1)
                except Exception:
                    self.env_runner_group.restart_runner(i)
            # Dead aggregators would otherwise poison every later round the
            # round-robin lands on them. One batched wait-group subscribe
            # covers the whole ping fan-out (PR 5 lane); the per-ref gets
            # below are already-resolved-future reads.
            pings = [a.ping.remote() for a in self.aggregators]
            ray_tpu_torch.wait(pings, num_returns=len(pings), timeout=5)
            for j, ref in enumerate(pings):
                try:
                    ray_tpu_torch.get(ref, timeout=5)
                except Exception:
                    self.aggregators[j] = _Aggregator.remote()
            return {"learner": {}, "num_env_steps_sampled": 0}
        self._refill()  # keep samplers busy while we update

        train_batch, T, N = self._vtrace_train_batch(batch)
        self._total_env_steps += T * N
        stats = self.learner_group.update(train_batch)
        self._updates_since_broadcast += 1
        if self._updates_since_broadcast >= cfg.broadcast_interval:
            self.learner_group.sync_weights()
            self._weights_ref = self.learner_group.get_weights_ref()
            self._updates_since_broadcast = 0
        return {"learner": stats, "num_env_steps_sampled": T * N,
                "inflight": len(self._inflight)}

    def stop(self):
        super().stop()
        for a in self.aggregators:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(IMPALA)
        self.num_aggregation_workers = 0
        self.broadcast_interval = 1
        self.vtrace_clip_rho = 1.0
        self.vtrace_clip_c = 1.0
        self.vtrace_lambda = 1.0
        self.num_epochs = 1          # IMPALA is single-pass
        self.minibatch_size = 1 << 30  # full batch

    def training(self, *, num_aggregation_workers=None,
                 broadcast_interval=None, vtrace_clip_rho=None,
                 vtrace_clip_c=None, vtrace_lambda=None, **kw):
        super().training(**kw)
        for name, val in [
                ("num_aggregation_workers", num_aggregation_workers),
                ("broadcast_interval", broadcast_interval),
                ("vtrace_clip_rho", vtrace_clip_rho),
                ("vtrace_clip_c", vtrace_clip_c),
                ("vtrace_lambda", vtrace_lambda)]:
            if val is not None:
                setattr(self, name, val)
        return self
