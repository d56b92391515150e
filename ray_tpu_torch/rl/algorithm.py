"""Algorithm: config builder + training loop driver (PPO first).

Port of ``ray_tpu/rl/algorithm.py``: ``learners(use_gpu=...)`` takes the
place of ``use_tpu`` (a learner then leases a whole card), registered env
names resolve through the port's ``tune.registry``, the space probe reads
``env_fn()``'s spaces without gymnasium (which it imports only for a
string env id), and checkpoints go through the port's
``train.checkpoint.save_pytree``.

Reference: ``AlgorithmConfig`` builder (``rllib/algorithms/algorithm_config.
py``) and ``Algorithm.training_step`` (``algorithms/algorithm.py:1662``;
PPO's at ``algorithms/ppo/ppo.py:400``): synchronous parallel sampling over
the EnvRunnerGroup, learner-group update, weight broadcast — the same
3-phase step, with weights broadcast as object-store refs.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from .env_runner import EnvRunnerGroup
from .learner import LearnerGroup, gae
from .rl_module import MLPModuleConfig


def make_env(config):
    """One env of ``config``: ``env_fn()``, or ``gymnasium.make`` of a
    string id (the only place the probes import gymnasium)."""
    if config.env_fn is not None:
        return config.env_fn()
    import gymnasium as gym

    return gym.make(config.env)


class AlgorithmConfig:
    """Fluent config builder (same surface shape as the reference's)."""

    def __init__(self, algo_class=None):
        self.algo_class = algo_class or PPO
        self.env: Optional[str] = None
        self.env_fn: Optional[Callable] = None
        self.num_env_runners = 2
        self.num_envs_per_env_runner = 4
        self.rollout_fragment_length = 64
        self.num_learners = 1
        self.learner_mesh_devices: Optional[int] = None
        self.use_gpu = False
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.train_batch_size = 512
        self.minibatch_size = 128
        self.num_epochs = 4
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.grad_clip = 0.5
        self.hidden = (64, 64)
        self.seed = 0

    # builder sections, mirroring the reference's method names
    def environment(self, env: Optional[str] = None, *, env_fn=None,
                    **kw) -> "AlgorithmConfig":
        self.env = env
        self.env_fn = env_fn
        if env_fn is None and isinstance(env, str):
            # tune.register_env names resolve to creator closures that
            # ship to env-runner workers like any env_fn.
            from ray_tpu_torch.tune.registry import get_env_creator

            creator = get_env_creator(env)
            if creator is not None:
                self.env_fn = creator
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    **kw) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 use_gpu: Optional[bool] = None,
                 mesh_devices: Optional[int] = None,
                 **kw) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = max(1, num_learners)
        if use_gpu is not None:
            self.use_gpu = use_gpu
        if mesh_devices is not None:
            # Mesh learner: one process runs the update of a mesh of this
            # many ranks (ray_tpu_torch.rl.mesh_learner).
            self.learner_mesh_devices = max(1, mesh_devices)
        return self

    def training(self, *, lr=None, gamma=None, lambda_=None,
                 train_batch_size=None, minibatch_size=None, num_epochs=None,
                 clip_param=None, entropy_coeff=None, vf_loss_coeff=None,
                 grad_clip=None, model=None, **kw) -> "AlgorithmConfig":
        for name, val in [("lr", lr), ("gamma", gamma), ("lambda_", lambda_),
                          ("train_batch_size", train_batch_size),
                          ("minibatch_size", minibatch_size),
                          ("num_epochs", num_epochs),
                          ("clip_param", clip_param),
                          ("entropy_coeff", entropy_coeff),
                          ("vf_loss_coeff", vf_loss_coeff),
                          ("grad_clip", grad_clip)]:
            if val is not None:
                setattr(self, name, val)
        if model and "hidden" in model:
            self.hidden = tuple(model["hidden"])
        return self

    def debugging(self, *, seed: Optional[int] = None, **kw):
        if seed is not None:
            self.seed = seed
        return self

    def hparams(self) -> dict:
        return {
            "lr": self.lr, "clip_param": self.clip_param,
            "entropy_coeff": self.entropy_coeff,
            "vf_loss_coeff": self.vf_loss_coeff,
            "grad_clip": self.grad_clip,
            "minibatch_size": self.minibatch_size,
            "num_epochs": self.num_epochs,
        }

    def build(self) -> "Algorithm":
        return self.algo_class(self)


class Algorithm:
    """Base: owns the runner group + learner group; subclasses define
    ``training_step``. Checkpointable via get/set state."""

    # Value-based subclasses bring their own learner (e.g. DQN's TD
    # learner); policy-gradient ones use the PPO-style LearnerGroup.
    _uses_learner_group = True

    def __init__(self, config: AlgorithmConfig):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.config = config
        self.iteration = 0
        self._total_env_steps = 0
        probe = self._probe_env_spaces()
        self._build_module_and_runners(probe)

    def _start_learners(self):
        """Create the learner tier's actors once ``self.module_cfg`` is
        set and before the runners: their starts (a card's lease, a CUDA
        context, the weights) overlap the runners' (the group waits for
        its runners)."""
        if self._uses_learner_group:
            config = self.config
            self.learner_group = LearnerGroup(
                self.module_cfg, config.hparams(),
                num_learners=config.num_learners, use_gpu=config.use_gpu,
                seed=config.seed,
                mesh_devices=config.learner_mesh_devices)

    def _probe_env_spaces(self) -> dict:
        env = make_env(self.config)
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        env.close()
        return {"obs_dim": obs_dim, "num_actions": num_actions}

    def _build_module_and_runners(self, probe: dict):
        """Build ``self.module_cfg`` + ``self.env_runner_group`` from the
        probed spaces. Continuous-control subclasses (SAC) override both
        this and ``_probe_env_spaces``."""
        config = self.config
        self.module_cfg = MLPModuleConfig(
            obs_dim=probe["obs_dim"], num_actions=probe["num_actions"],
            hidden=config.hidden)
        self._start_learners()
        self.env_runner_group = EnvRunnerGroup(
            config.env, config.num_env_runners,
            config.num_envs_per_env_runner, self.module_cfg,
            env_fn=config.env_fn, seed=config.seed)

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        t0 = time.time()
        result = self.training_step()
        self.iteration += 1
        stats = self.env_runner_group.episode_stats()
        returns = stats["returns"]
        result.update({
            "training_iteration": self.iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "episode_len_mean": (float(np.mean(stats["lengths"]))
                                 if stats["lengths"] else float("nan")),
            "episodes_this_iter": len(returns),
            "time_this_iter_s": time.time() - t0,
        })
        return result

    def get_state(self) -> dict:
        return {"weights": ray_tpu_torch.get(
                    self.learner_group.get_weights_ref()),
                "iteration": self.iteration}

    def set_state(self, state: dict):
        ray_tpu_torch.get([l.set_weights.remote(state["weights"])
                     for l in self.learner_group.learners])
        self.iteration = state.get("iteration", 0)

    def save_checkpoint(self, path: str):
        from ray_tpu_torch.train.checkpoint import save_pytree

        save_pytree(self.get_state(), path)

    def restore_from_path(self, path: str):
        from ray_tpu_torch.train.checkpoint import load_pytree

        self.set_state(load_pytree(path))

    def stop(self):
        self.env_runner_group.shutdown()
        if self._uses_learner_group:
            self.learner_group.shutdown()


class PPO(Algorithm):
    """PPO training step (reference: ``ppo.py:400``):
    1. synchronous_parallel_sample over env runners
    2. GAE on the learner side
    3. LearnerGroup.update (minibatch SGD epochs)
    4. weight broadcast to runners (object-store ref)
    """

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        weights_ref = self.learner_group.get_weights_ref()
        rollouts = self.env_runner_group.sample(
            weights_ref, cfg.rollout_fragment_length)
        batches = []
        for ro in rollouts:
            adv, ret = gae(ro["rewards"], ro["values"], ro["dones"],
                           ro["bootstrap_value"], cfg.gamma, cfg.lambda_)
            T, N = ro["rewards"].shape
            flat = lambda x: x.reshape(T * N, *x.shape[2:])  # noqa: E731
            # Drop NEXT_STEP-autoreset pseudo-rows (env ignored the action).
            keep = flat(ro["mask"]) if "mask" in ro else \
                np.ones(T * N, bool)
            batches.append({
                "obs": flat(ro["obs"]).astype(np.float32)[keep],
                "actions": flat(ro["actions"])[keep],
                "logp": flat(ro["logp"]).astype(np.float32)[keep],
                "advantages": flat(adv)[keep],
                "returns": flat(ret)[keep],
                "values": flat(ro["values"])[keep],
            })
        batch = {k: np.concatenate([b[k] for b in batches])
                 for k in batches[0]}
        self._total_env_steps += len(batch["obs"])
        stats = self.learner_group.update(batch)
        self.learner_group.sync_weights()
        return {"learner": stats,
                "num_env_steps_sampled": len(batch["obs"])}


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__(PPO)
