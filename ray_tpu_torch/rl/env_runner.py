"""EnvRunner: sampling actors over vectorised envs.

Port of ``ray_tpu/rl/env_runner.py``. Reference: ``SingleAgentEnvRunner``
(``rllib/env/single_agent_env_runner.py:64``) grouped by ``EnvRunnerGroup``
(``rllib/env/env_runner_group.py``) with fault-tolerant apply
(``env/env_runner.py:28`` FaultAwareApply). Runners do inference with the
current RLModule weights on their lease's device (the CPU unless they
hold a GPU) and return fixed-size rollout batches as numpy dicts
(zero-copy through the object store).

``env_fn`` envs step in :class:`SyncVectorEnv`, the port's own copy of
gymnasium 1.x's synchronous vector env (per-env seeds ``seed + i``,
``NEXT_STEP`` autoreset), so the runner needs no gymnasium; a string env
id goes through ``gymnasium.make_vec``, imported only there.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

import ray_tpu_torch


class SyncVectorEnv:
    """gymnasium 1.x ``SyncVectorEnv`` with ``NEXT_STEP`` autoreset: the
    step after an env's episode ends ignores its action and returns the
    reset observation with reward 0 and no termination or truncation.
    Observations stack in the single observation space's dtype, rewards
    are float64 and the flags bool, as gymnasium's."""

    autoreset_mode = "NextStep"

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._autoreset = np.zeros(self.num_envs, bool)

    def _stack(self, obs):
        return np.stack([np.asarray(o) for o in obs]).astype(
            self.single_observation_space.dtype, copy=False)

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[dict] = None):
        seeds = ([None] * self.num_envs if seed is None
                 else [seed + i for i in range(self.num_envs)])
        self._autoreset = np.zeros(self.num_envs, bool)
        obs = [env.reset(seed=s, options=options)[0]
               for env, s in zip(self.envs, seeds)]
        return self._stack(obs), {}

    def step(self, actions):
        obs, rewards = [], np.zeros(self.num_envs, np.float64)
        terms = np.zeros(self.num_envs, bool)
        truncs = np.zeros(self.num_envs, bool)
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            if self._autoreset[i]:
                o, _ = env.reset()
            else:
                o, rewards[i], terms[i], truncs[i], _ = env.step(action)
            obs.append(o)
        self._autoreset = np.logical_or(terms, truncs)
        return self._stack(obs), rewards, terms, truncs, {}

    def close(self):
        for env in self.envs:
            env.close()


def _next_step_autoreset(env) -> bool:
    """Whether ``env`` (the port's vector env or gymnasium's) resets on
    the step after a done, read without importing gymnasium."""
    mode = getattr(env, "autoreset_mode", None)
    return getattr(mode, "value", mode) == "NextStep"


class EnvRunnerImpl:
    """Undecorated runner body — subclassable (the Podracer tier's
    ``PodRunner`` extends it with versioned weight pulls and time-major
    output); ``EnvRunner`` below is the registered actor class."""

    def __init__(self, env_id: str, num_envs: int, module_cfg_blob: bytes,
                 seed: int = 0, env_fn_blob: Optional[bytes] = None,
                 device=None):
        import cloudpickle
        import torch

        from . import rl_module
        from .learner import lease_device

        self.rl_module = rl_module
        if env_fn_blob is not None:
            env_fn = cloudpickle.loads(env_fn_blob)
            self.env = SyncVectorEnv(
                [lambda i=i: env_fn() for i in range(num_envs)])
        else:
            import gymnasium as gym

            self.env = gym.make_vec(env_id, num_envs=num_envs,
                                    vectorization_mode="sync")
        self.cfg = cloudpickle.loads(module_cfg_blob)
        if device is not None:
            self.device = torch.device(device)
        else:
            self.device = lease_device()
            if self.device.type == "cpu":
                # one torch thread, as the reference's workers set
                # OMP_NUM_THREADS=1: runners of eight threads sharing a
                # host's cores spun against each other, ~50x slower
                torch.set_num_threads(1)
        # Config-dispatched forwards (MLP or the ViT pixel path): the
        # sampling loop below is module-family agnostic.
        self._sample_fn = rl_module.make_sample_fn(self.cfg)
        self._value_fn = rl_module.make_forward(self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.num_envs = num_envs
        # gymnasium 1.x NEXT_STEP autoreset: the step after a done ignores
        # the action and returns the reset obs with zero reward. Those
        # pseudo-steps must be masked out of training data.
        self._next_step_autoreset = _next_step_autoreset(self.env)
        self._prev_done = np.zeros(num_envs, bool)
        # episode-return bookkeeping
        self._ep_return = np.zeros(num_envs)
        self._ep_len = np.zeros(num_envs, dtype=np.int64)
        self.completed_returns: List[float] = []
        self.completed_lengths: List[int] = []

    def _on_device(self, params):
        """The weights on this runner's device (a copy only when they are
        elsewhere)."""
        from .learner import tree_to

        return (params
                if self.rl_module.params_device(params) == self.device
                else tree_to(params, self.device))

    def sample(self, weights_ref, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect ``num_steps`` per env; returns [T, N, ...] arrays plus
        bootstrap values."""
        params = self._on_device(weights_ref)  # resolved ObjectRef
        return self._collect(params, num_steps)

    def _collect(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        import torch

        obs_buf, act_buf, logp_buf, rew_buf, done_buf, val_buf, mask_buf = \
            [], [], [], [], [], [], []
        for _ in range(num_steps):
            valid = ~self._prev_done  # False on NEXT_STEP autoreset steps
            actions, logp, value = self._sample_fn(params, self.obs,
                                                   self.generator)
            nxt, rew, term, trunc, _ = self.env.step(actions)
            done = np.logical_or(term, trunc)
            obs_buf.append(self.obs.copy())
            act_buf.append(actions)
            logp_buf.append(logp)
            rew_buf.append(rew)
            done_buf.append(done)
            val_buf.append(value)
            mask_buf.append(valid)
            self._ep_return += rew
            self._ep_len += valid.astype(np.int64)
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_return[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done if self._next_step_autoreset else \
                np.zeros(self.num_envs, bool)
            self.obs = nxt
        with torch.no_grad():
            _, last_value = self._value_fn(
                params, self.rl_module.as_obs(self.obs, self.device))
        return {
            "obs": np.stack(obs_buf),            # [T, N, obs]
            "actions": np.stack(act_buf),        # [T, N]
            "logp": np.stack(logp_buf),
            "rewards": np.stack(rew_buf).astype(np.float32),
            "dones": np.stack(done_buf),
            "values": np.stack(val_buf).astype(np.float32),
            "mask": np.stack(mask_buf),          # [T, N] valid rows
            "bootstrap_value": last_value.cpu().numpy().astype(
                np.float32),                     # [N]
        }

    def sample_transitions(self, weights_ref, num_steps: int,
                           epsilon: float) -> Dict[str, np.ndarray]:
        """Off-policy sampling: flat (s, a, r, s', done) transitions with
        epsilon-greedy exploration (DQN-family runners)."""
        from . import rl_module

        params = self._on_device(weights_ref)
        obs_b, act_b, rew_b, nxt_b, done_b, mask_b = [], [], [], [], [], []
        for _ in range(num_steps):
            valid = ~self._prev_done  # False on NEXT_STEP autoreset steps
            actions = rl_module.epsilon_greedy_actions(
                params, self.obs, self.generator, epsilon)
            nxt, rew, term, trunc, _ = self.env.step(actions)
            # Terminations bootstrap to 0; truncations are NOT terminal for
            # the Bellman target (gymnasium semantics).
            obs_b.append(self.obs.copy())
            act_b.append(actions)
            rew_b.append(rew)
            nxt_b.append(nxt.copy())
            done_b.append(term)
            mask_b.append(valid)
            done = np.logical_or(term, trunc)
            self._ep_return += rew
            self._ep_len += valid.astype(np.int64)
            for i in np.nonzero(done)[0]:
                self.completed_returns.append(float(self._ep_return[i]))
                self.completed_lengths.append(int(self._ep_len[i]))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done if self._next_step_autoreset else \
                np.zeros(self.num_envs, bool)
            self.obs = nxt
        cat = lambda xs: np.concatenate(xs, axis=0)  # noqa: E731
        keep = cat(mask_b)
        return {
            "obs": cat(obs_b).astype(np.float32)[keep],
            "actions": cat(act_b).astype(np.int64)[keep],
            "rewards": cat(rew_b).astype(np.float32)[keep],
            "next_obs": cat(nxt_b).astype(np.float32)[keep],
            "dones": cat(done_b).astype(np.float32)[keep],
        }

    def episode_stats(self, clear: bool = True) -> Dict[str, Any]:
        out = {"returns": list(self.completed_returns),
               "lengths": list(self.completed_lengths)}
        if clear:
            self.completed_returns = []
            self.completed_lengths = []
        return out

    def ping(self):
        return True


EnvRunner = ray_tpu_torch.remote(EnvRunnerImpl)


class EnvRunnerGroup:
    """Fault-aware group of sampling actors (EnvRunnerGroup analog)."""

    def __init__(self, env_id: str, num_runners: int, num_envs_per_runner: int,
                 module_cfg, env_fn=None, seed: int = 0, runner_cls=None):
        import cloudpickle

        runner_cls = runner_cls or EnvRunner
        self.env_id = env_id
        self.num_envs_per_runner = num_envs_per_runner
        self._make = lambda i: runner_cls.options(max_restarts=2).remote(
            env_id, num_envs_per_runner, cloudpickle.dumps(module_cfg),
            seed + i,
            cloudpickle.dumps(env_fn) if env_fn is not None else None)
        self.runners = [self._make(i) for i in range(num_runners)]
        ray_tpu_torch.get([r.ping.remote() for r in self.runners])

    def _fanout(self, method: str, *args) -> List[Dict[str, np.ndarray]]:
        """Fault-tolerant parallel call on every runner: a dead runner is
        replaced and retried once (FaultAwareApply restart semantics,
        ``env/env_runner.py:28``)."""
        refs = [getattr(r, method).remote(*args) for r in self.runners]
        # ONE batched wait-group subscribe for the whole fan-out (the
        # PR 5 obj_waits lane) — the per-ref gets below then hit
        # already-resolved futures, so the n-runner sync point costs one
        # frame instead of n serial round trips (per-ref error handling
        # is why this is not a single list-get).
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=300)
        out = []
        for i, ref in enumerate(refs):
            try:
                out.append(ray_tpu_torch.get(ref, timeout=300))
            except (ray_tpu_torch.ActorDiedError,
                    ray_tpu_torch.WorkerCrashedError):
                # single-runner crash recovery: the immediate retry IS
                # the point — not a fan-out opportunity
                self.runners[i] = self._make(i)
                out.append(ray_tpu_torch.get(  # raylint: disable=RTL002
                    getattr(self.runners[i], method).remote(*args),
                    timeout=300))
        return out

    def sample(self, weights_ref, num_steps: int) -> List[Dict[str, np.ndarray]]:
        return self._fanout("sample", weights_ref, num_steps)

    def sample_transitions(self, weights_ref, num_steps: int,
                           epsilon: float) -> List[Dict[str, np.ndarray]]:
        return self._fanout("sample_transitions", weights_ref, num_steps,
                            epsilon)

    def restart_runner(self, i: int):
        self.runners[i] = self._make(i)
        return self.runners[i]

    def episode_stats(self) -> Dict[str, list]:
        stats = ray_tpu_torch.get([r.episode_stats.remote()
                                   for r in self.runners])
        return {
            "returns": [x for s in stats for x in s["returns"]],
            "lengths": [x for s in stats for x in s["lengths"]],
        }

    def shutdown(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
