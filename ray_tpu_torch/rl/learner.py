"""Learner: gradient updates in torch; LearnerGroup for data parallelism.

Port of ``ray_tpu/rl/learner.py``. Reference:
``Learner.compute_losses/compute_gradients/apply_gradients``
(``rllib/core/learner/learner.py:442-585``) and ``LearnerGroup``
(``learner_group.py:81``) which the reference builds on Train's
BackendExecutor + torch DDP. Here a learner holds a parameter tree and
:class:`ppo_loss.ClipAdam`; multi-learner data parallelism shards the
batch across learner actors and averages gradients over the host
collective. A learner actor runs on its lease's device
(``train.torch.get_device()``: its card when it holds a GPU, the CPU when
it holds none, and a raise when it holds a GPU but finds no CUDA).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch


def gae(rewards: np.ndarray, values: np.ndarray, dones: np.ndarray,
        bootstrap_value: np.ndarray, gamma: float = 0.99,
        lam: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over [T, N] arrays.

    The reference computes this in its learner connector pipeline
    (``rllib/connectors/learner``); here it's a plain numpy scan.
    """
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last = np.zeros(N, np.float32)
    next_value = bootstrap_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_value = values[t]
    returns = adv + values
    return adv, returns


def lease_device():
    """The device of this process's lease (``train.torch.get_device``):
    its card when it holds a GPU, the CPU when it holds none; a process
    that holds a GPU but finds no CUDA raises."""
    from ..train.torch import get_device

    return get_device()


def to_tensors(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A batch of numpy arrays as tensors on ``device``."""
    import torch

    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def tree_to(params, device, copy: bool = False):
    """The tree's tensors detached on ``device`` (copies with ``copy``)."""
    if isinstance(params, dict):
        return {k: tree_to(v, device, copy) for k, v in params.items()}
    if isinstance(params, list):
        return [tree_to(v, device, copy) for v in params]
    return params.detach().to(device, copy=copy)


def host_copy(params):
    """The tree as CPU tensors of its own (the counterpart of
    ``jax.device_get``): a runner on either device takes the same
    object, and later updates do not reach it."""
    return tree_to(params, "cpu", copy=True)


def copy_into(params, new) -> None:
    """Copy the tree ``new`` (tensors or arrays, any device) into
    ``params`` in place, so an optimiser bound to its leaves keeps its
    state."""
    import torch

    if isinstance(params, dict):
        for k in params:
            copy_into(params[k], new[k])
    elif isinstance(params, list):
        for p, n in zip(params, new):
            copy_into(p, n)
    else:
        with torch.no_grad():
            params.copy_(new if isinstance(new, torch.Tensor)
                         else torch.from_numpy(np.array(new)))


@ray_tpu_torch.remote
class Learner:
    """One learner actor: holds params + optimizer state, applies updates."""

    def __init__(self, module_cfg_blob: bytes, hparams: dict,
                 rank: int = 0, world_size: int = 1,
                 group_name: Optional[str] = None, seed: int = 0,
                 device=None):
        import cloudpickle
        import torch

        from . import rl_module
        from .ppo_loss import ClipAdam, make_ppo_update

        self.cfg = cloudpickle.loads(module_cfg_blob)
        self.hparams = hparams
        self.rank = rank
        self.world_size = world_size
        self.device = (torch.device(device) if device is not None
                       else lease_device())
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = rl_module.init(self.cfg, gen, self.device)
        self.opt = ClipAdam(self.params, hparams.get("lr", 3e-4),
                            hparams.get("grad_clip", 0.5))
        self.update_fn = make_ppo_update(self.opt, hparams)
        self.group = None
        if world_size > 1 and group_name:
            from ..parallel.collectives import HostCollectiveGroup

            self.group = HostCollectiveGroup(group_name, world_size, rank)

    def get_weights(self):
        return host_copy(self.params)

    def set_weights(self, params):
        copy_into(self.params, params)
        return True

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One PPO update over the (already sharded) batch: minibatch SGD
        epochs; gradients averaged across learners when in a group."""
        import numpy as np_
        import torch

        hp = self.hparams
        n = batch["obs"].shape[0]
        mb = hp.get("minibatch_size", min(n, 128))
        epochs = hp.get("num_epochs", 4)
        rng = np_.random.RandomState(0)
        stats = {}
        for _ in range(epochs):
            perm = rng.permutation(n)
            for s in range(0, n, mb):
                idx = perm[s:s + mb]
                minibatch = to_tensors({k: v[idx] for k, v in batch.items()},
                                       self.device)
                if self.group is not None:
                    # Multi-learner: average gradients across actors
                    # (the DDP-allreduce analog on the host tier), flat
                    # in the tree's leaf order.
                    grads, stats = self.update_fn.compute_grads(
                        self.params, minibatch)
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    avg = torch.from_numpy(np_.asarray(self.group.allreduce(
                        flat.cpu().numpy(), op="mean"))).to(self.device)
                    grads = [a.view_as(g) for a, g in zip(
                        avg.split([g.numel() for g in grads]), grads)]
                    self.update_fn.apply_grads(self.params, grads)
                else:
                    stats = self.update_fn.step(self.params, minibatch)
        return {k: float(v) for k, v in stats.items()}


class LearnerGroup:
    """The learner tier (``learner_group.py:81`` analog).

    Two scaling modes:
      * ``mesh_devices=K``: ONE ``MeshLearnerActor`` runs the update of a
        K-rank ``dp`` mesh whose ranks share its device (the full-batch
        step, no actor choreography); with ``use_gpu`` it leases one
        whole card.
      * ``num_learners=N`` (host tier): N actors average gradients over
        the host collective — the reference's DDP-actor shape, each on
        a card of its own with ``use_gpu``.
    """

    def __init__(self, module_cfg, hparams: dict, num_learners: int = 1,
                 use_gpu: bool = False, seed: int = 0,
                 mesh_devices: Optional[int] = None):
        import cloudpickle
        import uuid

        blob = cloudpickle.dumps(module_cfg)
        self.mesh_devices = mesh_devices
        if mesh_devices:
            from .mesh_learner import MeshLearnerActor

            opts = {"num_gpus": 1} if use_gpu else {}
            self.learners = [MeshLearnerActor.options(**opts).remote(
                blob, hparams, n_devices=mesh_devices, seed=seed)]
            self.num_learners = 1
            return
        group_name = f"lg_{uuid.uuid4().hex[:8]}" if num_learners > 1 else None
        opts = {}
        if use_gpu:
            opts["num_gpus"] = 1
        self.learners = [
            Learner.options(**opts).remote(
                blob, hparams, rank=i, world_size=num_learners,
                group_name=group_name, seed=seed)
            for i in range(num_learners)
        ]
        self.num_learners = num_learners

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        n = batch["obs"].shape[0]
        per = n // self.num_learners
        refs = []
        for i, learner in enumerate(self.learners):
            shard = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            refs.append(learner.update.remote(shard))
        all_stats = ray_tpu_torch.get(refs, timeout=600)
        return {k: float(np.mean([s[k] for s in all_stats]))
                for k in all_stats[0]} if all_stats else {}

    def get_weights_ref(self):
        """Weights as an ObjectRef for zero-copy broadcast to runners."""
        return self.learners[0].get_weights.remote()

    def sync_weights(self):
        """Learner 0's weights to all learners (after divergence).

        The weights ride as ONE object ref resolved on each receiving
        worker (cooperative chunk-striped broadcast) — materializing them
        on the driver and re-shipping a copy per learner made the driver
        the bandwidth bottleneck at exactly the weight sizes where it
        hurts."""
        if self.num_learners <= 1:
            return
        wref = self.learners[0].get_weights.remote()
        ray_tpu_torch.get([l.set_weights.remote(wref)
                           for l in self.learners[1:]])

    def shutdown(self):
        for l in self.learners:
            try:
                ray_tpu_torch.kill(l)
            except Exception:
                pass
