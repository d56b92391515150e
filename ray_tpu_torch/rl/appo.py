"""APPO: asynchronous PPO — IMPALA dataflow + clipped surrogate + target net.

Port of ``ray_tpu/rl/appo.py``; the target network's pass runs in torch
on its CPU snapshot.

Reference: ``rllib/algorithms/appo/`` (``appo.py``: "APPO is an
asynchronous variant of PPO based on the IMPALA architecture"; ``torch/
appo_torch_learner.py``: clipped-surrogate loss on v-trace advantages with
a periodically-synced target network providing the value baselines). Here
APPO reuses IMPALA's async sampler/aggregator machinery and differs only
in how the train batch is built: the behaviour logp is kept so the PPO
learner's ratio clip is live, and v-trace bootstraps off a slow-moving
target network snapshot.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

import ray_tpu_torch

from .impala import IMPALA, IMPALAConfig, policy_logp_values
from .vtrace import vtrace


class APPO(IMPALA):
    def __init__(self, config: "APPOConfig"):
        super().__init__(config)
        # Target network = a lagging CPU-side snapshot of learner weights.
        self._target_params = ray_tpu_torch.get(
            self.learner_group.get_weights_ref())
        self._steps_since_target_sync = 0

    def _vtrace_train_batch(self, batch):
        cfg = self.config
        T, N = batch["rewards"].shape
        flat_obs = batch["obs"].reshape(T * N, -1).astype(np.float32)
        # Values + correction logp come from the TARGET network: the
        # surrogate then measures current-vs-behaviour drift while the
        # baseline stays stable between target syncs (APPO learner
        # semantics, ``appo_torch_learner.py``).
        logp_all, values = policy_logp_values(self._target_params,
                                              flat_obs)
        tgt_logp = logp_all[
            np.arange(T * N), batch["actions"].reshape(-1).astype(np.int64)
        ].reshape(T, N)
        tgt_values = values.reshape(T, N)
        vs, pg_adv = vtrace(
            batch["logp"], tgt_logp, batch["rewards"], tgt_values,
            batch["dones"], batch["bootstrap_value"], cfg.gamma,
            cfg.vtrace_clip_rho, cfg.vtrace_clip_c)
        flat = lambda x: x.reshape(T * N, *x.shape[2:])  # noqa: E731
        keep = flat(batch["mask"]) if "mask" in batch else \
            np.ones(T * N, bool)
        train_batch = {
            "obs": flat_obs[keep],
            # Behaviour logp stays: the PPO loss ratio pi_cur/pi_behaviour
            # is clipped (this is the "PPO" in APPO).
            "logp": flat(batch["logp"]).astype(np.float32)[keep],
            "actions": flat(batch["actions"])[keep],
            "advantages": flat(pg_adv)[keep],
            "returns": flat(vs)[keep],
            "values": flat(tgt_values)[keep],
        }
        return train_batch, T, N

    def training_step(self) -> Dict[str, Any]:
        out = super().training_step()
        if out.get("num_env_steps_sampled", 0) > 0:
            self._steps_since_target_sync += 1
            if self._steps_since_target_sync >= \
                    self.config.target_update_frequency:
                self._target_params = ray_tpu_torch.get(
                    self.learner_group.get_weights_ref())
                self._steps_since_target_sync = 0
        return out


class APPOConfig(IMPALAConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = APPO
        self.target_update_frequency = 4
        self.num_epochs = 1
        self.clip_param = 0.2

    def training(self, *, target_update_frequency=None, **kw):
        super().training(**kw)
        if target_update_frequency is not None:
            self.target_update_frequency = target_update_frequency
        return self
