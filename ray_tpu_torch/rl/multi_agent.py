"""Multi-agent: env interface, runner, and per-policy PPO training.

Port of ``ray_tpu/rl/multi_agent.py``: the runner draws from a
``torch.Generator`` on its lease's device, where its forwards run.

Reference: ``rllib/env/multi_agent_env.py`` (dict-keyed obs/rewards per
agent), ``MultiAgentEnvRunner`` (``rllib/env/multi_agent_env_runner.py``),
``MultiRLModule`` (``core/rl_module/multi_rl_module.py``), and the
policy-mapping function. Each policy id owns an independent MLP module;
agents map to policies via ``policy_mapping_fn``; PPO updates run
per-policy on that policy's share of the batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch


class MultiAgentEnv:
    """Dict-keyed multi-agent env interface (subset of the reference's):
    ``reset() -> (obs_dict, info)``, ``step(action_dict) ->
    (obs, rewards, terminateds, truncateds, infos)`` with an ``__all__``
    key in terminateds/truncateds."""

    possible_agents: List[str] = []

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, int]):
        raise NotImplementedError

    def observation_space_shape(self, agent: str) -> Tuple[int, ...]:
        raise NotImplementedError

    def num_actions(self, agent: str) -> int:
        raise NotImplementedError


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """Samples a multi-agent env with per-policy modules (host inference)."""

    def __init__(self, env_fn_blob: bytes, module_cfgs_blob: bytes,
                 policy_mapping_blob: bytes, seed: int = 0):
        import cloudpickle
        import torch

        from .learner import lease_device

        self.env = cloudpickle.loads(env_fn_blob)()
        self.module_cfgs = cloudpickle.loads(module_cfgs_blob)
        self.policy_of = cloudpickle.loads(policy_mapping_blob)
        self.device = lease_device()
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.obs, _ = self.env.reset(seed=seed)
        self.ep_returns: Dict[str, float] = {}
        self.completed: List[Dict[str, float]] = []

    def sample(self, weights_by_policy, num_steps: int
               ) -> Dict[str, Dict[str, np.ndarray]]:
        """Returns per-POLICY batches of [T, A_policy] rollout arrays.

        Agents sharing a policy become columns of that policy's batch (so
        GAE runs per-trajectory, never across interleaved agents). Requires
        every agent to be present each step (the common fully-observable
        case; the reference's episode lists handle ragged agents).
        """
        import torch

        from . import rl_module
        from .learner import tree_to

        weights_by_policy = {pid: tree_to(w, self.device)
                             for pid, w in weights_by_policy.items()}
        buf: Dict[tuple, Dict[str, list]] = {}
        ended_episode = False
        for _ in range(num_steps):
            actions = {}
            step_cache: Dict[str, tuple] = {}
            for agent, ob in self.obs.items():
                pid = self.policy_of(agent)
                a, logp, v = rl_module.sample_actions(
                    weights_by_policy[pid], np.asarray(ob)[None],
                    self.generator)
                actions[agent] = int(a[0])
                step_cache[agent] = (pid, ob, int(a[0]), float(logp[0]),
                                     float(v[0]))
            nxt, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = terms.get("__all__", False) or \
                truncs.get("__all__", False)
            for agent, (pid, ob, act, logp, val) in step_cache.items():
                b = buf.setdefault((pid, agent), {
                    "obs": [], "actions": [], "logp": [], "rewards": [],
                    "dones": [], "values": []})
                b["obs"].append(np.asarray(ob, np.float32))
                b["actions"].append(act)
                b["logp"].append(logp)
                b["rewards"].append(float(rewards.get(agent, 0.0)))
                b["dones"].append(bool(terms.get(agent, done_all))
                                  or done_all)
                b["values"].append(val)
                self.ep_returns[agent] = self.ep_returns.get(agent, 0.0) + \
                    float(rewards.get(agent, 0.0))
            if done_all:
                self.completed.append(dict(self.ep_returns))
                self.ep_returns = {}
                self.obs, _ = self.env.reset()
                ended_episode = True
            else:
                self.obs = nxt
                ended_episode = False
        # Group agent columns by policy; bootstrap with V(s_T) unless the
        # fragment ended exactly at an episode boundary.
        by_pid: Dict[str, list] = {}
        for (pid, agent), b in buf.items():
            by_pid.setdefault(pid, []).append((agent, b))
        out = {}
        for pid, cols in by_pid.items():
            cols.sort(key=lambda ab: ab[0])
            stack = lambda k, dt=None: np.stack(  # noqa: E731
                [np.asarray(b[k], dt) for _, b in cols], axis=1)
            boot = np.zeros(len(cols), np.float32)
            if not ended_episode:
                for j, (agent, _) in enumerate(cols):
                    if agent in self.obs and self.policy_of(agent) == pid:
                        with torch.no_grad():
                            _, v = rl_module.forward(
                                weights_by_policy[pid], rl_module.as_obs(
                                    np.asarray(self.obs[agent])[None],
                                    self.device))
                        boot[j] = float(v[0])
            out[pid] = {
                "obs": stack("obs", np.float32),       # [T, A, obs]
                "actions": stack("actions"),
                "logp": stack("logp", np.float32),
                "rewards": stack("rewards", np.float32),
                "dones": stack("dones"),
                "values": stack("values", np.float32),
                "bootstrap_value": boot,               # [A]
            }
        return out

    def episode_stats(self, clear: bool = True):
        out = list(self.completed)
        if clear:
            self.completed = []
        return out

    def ping(self):
        return True


class MultiAgentPPO:
    """Per-policy PPO: independent learner per policy id (reference:
    MultiRLModule + one Learner optimizing all submodules; independent
    optimizers here, same effect for non-shared parameters)."""

    def __init__(self, env_fn: Callable[[], MultiAgentEnv],
                 policies: Dict[str, dict],
                 policy_mapping_fn: Callable[[str], str],
                 num_env_runners: int = 2, rollout_fragment_length: int = 64,
                 lr: float = 3e-4, gamma: float = 0.99, lambda_: float = 0.95,
                 seed: int = 0):
        import cloudpickle

        from .learner import LearnerGroup
        from .rl_module import MLPModuleConfig

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(ignore_reinit_error=True)
        self.gamma, self.lambda_ = gamma, lambda_
        self.rollout_fragment_length = rollout_fragment_length
        probe = env_fn()
        self.module_cfgs = {}
        for pid, spec in policies.items():
            agent = next(a for a in probe.possible_agents
                         if policy_mapping_fn(a) == pid)
            self.module_cfgs[pid] = MLPModuleConfig(
                obs_dim=int(np.prod(probe.observation_space_shape(agent))),
                num_actions=probe.num_actions(agent),
                hidden=tuple(spec.get("hidden", (64, 64))))
        self.learners = {
            pid: LearnerGroup(cfg, {"lr": lr, "minibatch_size": 128,
                                    "num_epochs": 4},
                              num_learners=1, seed=seed + i)
            for i, (pid, cfg) in enumerate(self.module_cfgs.items())}
        self.runners = [
            MultiAgentEnvRunner.remote(
                cloudpickle.dumps(env_fn),
                cloudpickle.dumps(self.module_cfgs),
                cloudpickle.dumps(policy_mapping_fn), seed=seed + i)
            for i in range(num_env_runners)]
        ray_tpu_torch.get([r.ping.remote() for r in self.runners])
        self.iteration = 0

    def train(self) -> Dict[str, Any]:
        from .learner import gae

        weights = {pid: ray_tpu_torch.get(lg.get_weights_ref())
                   for pid, lg in self.learners.items()}
        rollouts = ray_tpu_torch.get(
            [r.sample.remote(weights, self.rollout_fragment_length)
             for r in self.runners], timeout=300)
        stats: Dict[str, Any] = {}
        steps = 0
        for pid, lg in self.learners.items():
            parts = [ro[pid] for ro in rollouts if pid in ro]
            if not parts:
                continue
            batches = []
            for ro in parts:
                adv, ret = gae(ro["rewards"], ro["values"],
                               ro["dones"], ro["bootstrap_value"],
                               self.gamma, self.lambda_)
                T, A = ro["rewards"].shape
                flat = lambda x: x.reshape(T * A, *x.shape[2:])  # noqa: E731
                batches.append({
                    "obs": flat(ro["obs"]).astype(np.float32),
                    "actions": flat(ro["actions"]),
                    "logp": flat(ro["logp"]),
                    "advantages": flat(adv),
                    "returns": flat(ret),
                    "values": flat(ro["values"]),
                })
            batch = {k: np.concatenate([b[k] for b in batches])
                     for k in batches[0]}
            steps += len(batch["obs"])
            stats[pid] = lg.update(batch)
        self.iteration += 1
        ep_stats = [s for r in ray_tpu_torch.get(
            [r.episode_stats.remote() for r in self.runners]) for s in r]
        mean_returns = {}
        if ep_stats:
            agents = set().union(*[set(e) for e in ep_stats])
            mean_returns = {a: float(np.mean(
                [e[a] for e in ep_stats if a in e])) for a in agents}
        return {"training_iteration": self.iteration,
                "num_env_steps_sampled": steps,
                "episode_return_mean_per_agent": mean_returns,
                "learner": stats}

    def get_weights(self) -> Dict[str, Any]:
        return {pid: ray_tpu_torch.get(lg.get_weights_ref())
                for pid, lg in self.learners.items()}

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        for lg in self.learners.values():
            lg.shutdown()
