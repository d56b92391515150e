"""Mesh learner: the update of a ``dp`` mesh whose ranks share one device.

Port of ``ray_tpu/rl/mesh_learner.py``. The reference scales learners with
N torch-DDP actors over NCCL (``rllib/core/learner/learner_group.py:
152-167``); the JAX package runs ONE process driving a GSPMD mesh, whose
compiled step is numerically the full-batch step. Here the learner builds
the port's mesh (``parallel.mesh.make_mesh(MeshSpec(dp=n))``); with no
process group all of its ranks live on one device and take global
tensors, so the update is that full-batch step, run once. The mesh size
still shapes the work: minibatches are a whole number of ranks, and a
V-trace batch's env axis must divide over them. A learner over several
cards (one rank a card under a process group) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch

from .learner import copy_into, host_copy, lease_device, to_tensors


class MeshLearner:
    """PPO update over ``n_devices`` ``dp`` ranks on one device, in process.
    ``device`` is CUDA unless the caller names another; ``attn_impl`` is a
    pixel module's encoder attention (``flash_attention`` unless given)."""

    def __init__(self, module_cfg, hparams: dict,
                 n_devices: Optional[int] = None, seed: int = 0,
                 device=None, attn_impl=None):
        import torch

        from ..parallel.mesh import MeshSpec, make_mesh
        from . import rl_module
        from .ppo_loss import ClipAdam, make_ppo_update

        n = n_devices or 1
        self.mesh = make_mesh(MeshSpec(dp=n), device=device)
        self.device = self.mesh.device
        self.n_devices = n
        self.hparams = hparams
        self.module_cfg = module_cfg
        self.attn_impl = attn_impl
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = rl_module.init(module_cfg, gen, self.device)
        self.opt = ClipAdam(self.params, hparams.get("lr", 3e-4),
                            hparams.get("grad_clip", 0.5))
        self._update = make_ppo_update(self.opt, hparams)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        hp = self.hparams
        n = batch["obs"].shape[0]
        mb = hp.get("minibatch_size", min(n, 128))
        mb -= mb % self.n_devices  # dp sharding needs even shards
        mb = max(mb, self.n_devices)
        epochs = hp.get("num_epochs", 4)
        rng = np.random.RandomState(0)
        stats: Dict[str, Any] = {}
        for _ in range(epochs):
            perm = rng.permutation(n)
            for s in range(0, n - mb + 1, mb):
                idx = perm[s:s + mb]
                minibatch = to_tensors({k: v[idx] for k, v in batch.items()},
                                       self.device)
                stats = self._update.step(self.params, minibatch)
        return {k: float(v) for k, v in stats.items()}

    def get_weights(self):
        return host_copy(self.params)

    def set_weights(self, params):
        copy_into(self.params, params)
        return True


class VtraceMeshLearner(MeshLearner):
    """IMPALA update on the mesh: time-major [T, B] batches, V-trace
    folded INTO the step (``vtrace.vtrace_scan``), single pass.

    The env axis divides over ``dp`` (V-trace's reverse scan is per-env
    independent); the loss reductions are over the whole batch. This is
    the Podracer learner tier: one process runs the update, and the host
    never sees the advantage tensors."""

    def __init__(self, module_cfg, hparams: dict,
                 n_devices: Optional[int] = None, seed: int = 0,
                 device=None, attn_impl=None):
        super().__init__(module_cfg, hparams, n_devices=n_devices,
                         seed=seed, device=device, attn_impl=attn_impl)
        self._vloss = self._build_vtrace_loss()

    def _build_vtrace_loss(self):
        import torch

        from . import rl_module
        from .vtrace import vtrace_scan

        hp = self.hparams
        gamma = hp.get("gamma", 0.99)
        clip_rho = hp.get("vtrace_clip_rho", 1.0)
        clip_c = hp.get("vtrace_clip_c", 1.0)
        lam = hp.get("vtrace_lambda", 1.0)
        vf_coeff = hp.get("vf_loss_coeff", 0.5)
        ent_coeff = hp.get("entropy_coeff", 0.01)
        fwd = rl_module.make_forward(self.module_cfg, attn_impl=self.attn_impl)

        def loss_fn(params, batch):
            T, B = batch["rewards"].shape
            obs = batch["obs"].reshape((T * B,) + batch["obs"].shape[2:])
            logits, values = fwd(params, obs.to(torch.float32))
            logp_all = torch.log_softmax(logits, dim=-1)
            actions = batch["actions"].reshape(T * B).long()
            tgt_logp = torch.gather(
                logp_all, 1, actions[:, None])[:, 0].reshape(T, B)
            values_tb = values.reshape(T, B)
            vs, pg_adv = vtrace_scan(
                batch["logp"], tgt_logp, batch["rewards"], values_tb,
                batch["dones"], batch["bootstrap_value"], gamma,
                clip_rho, clip_c, lam)
            vs = vs.detach()
            pg_adv = pg_adv.detach()
            # NEXT_STEP-autoreset pseudo-rows carry no decision — mask
            # them out of every reduction (the flat-batch paths drop the
            # rows instead; dropping would ragged the [T, B] layout).
            mask = batch["mask"].to(torch.float32)
            denom = torch.clamp(mask.sum(), min=1.0)
            pi_loss = -torch.sum(tgt_logp * pg_adv * mask) / denom
            vf_loss = 0.5 * torch.sum(
                torch.square(values_tb - vs) * mask) / denom
            ent = -torch.sum(torch.softmax(logits, dim=-1) * logp_all,
                             dim=-1).reshape(T, B)
            entropy = torch.sum(ent * mask) / denom
            total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
            stats = {"policy_loss": pi_loss, "vf_loss": vf_loss,
                     "entropy": entropy, "total_loss": total,
                     "mean_rho": torch.sum(
                         torch.exp(tgt_logp - batch["logp"]) * mask) / denom}
            return total, stats

        return loss_fn

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One single-pass V-trace update over a time-major batch
        ({obs, actions, logp, rewards, dones, mask} [T, B, ...] +
        bootstrap_value [B]). The env axis B must divide evenly over
        the mesh (the aggregation tier guarantees it)."""
        from .ppo_loss import loss_grads

        B = batch["rewards"].shape[1]
        if B % self.n_devices:
            raise ValueError(
                f"env axis {B} not divisible by mesh size "
                f"{self.n_devices} — size agg_fanin * num_envs so it is")
        put = to_tensors(batch, self.device)
        grads, stats = loss_grads(self._vloss, self.opt, self.params, put)
        self.opt.apply(grads)
        return {k: float(v) for k, v in stats.items()}


@ray_tpu_torch.remote
class MeshLearnerActor:
    """Actor hosting a MeshLearner on its lease's device (a whole card
    when it leases a GPU, whatever ``n_devices`` says)."""

    def __init__(self, module_cfg_blob: bytes, hparams: dict,
                 n_devices: Optional[int] = None, seed: int = 0):
        import cloudpickle

        self.learner = MeshLearner(cloudpickle.loads(module_cfg_blob),
                                   hparams, n_devices=n_devices, seed=seed,
                                   device=lease_device())

    def update(self, batch):
        return self.learner.update(batch)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params):
        return self.learner.set_weights(params)
