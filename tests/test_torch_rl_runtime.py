"""The port's ``rl/`` on its runtime, on the CPU: PPO, the two-learner
group, IMPALA, APPO, multi-agent PPO and the Podracer tier in actors.

One module-scoped port cluster runs every scenario. It is started with
the chaos schedule ``impala_runner_kill``'s failpoint armed
(``podracer.sample.r1=hit2:kill``, ``benchmarks/chaos_suite.py``): every
incarnation of a Podracer's rank-1 runner is SIGKILLed at its second
rollout, so the Podracer scenarios run under runner churn, and the kill
scenario asserts on the restart count and the updates that continue, not
on wall time. No other site fires. The cluster declares one GPU, which
a learner with ``use_gpu`` leases and then, finding no CUDA here, raises
on. Env factories are lambdas over the
port's ``CatchEnv`` (shipped by reference to ``ray_tpu_torch.rl``), and
no worker imports this module. The fixture shuts the cluster down and
removes its arenas and session directory, and checks that no process of
the session is left.
"""

import glob
import os
import shutil
import tempfile
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import failpoints

KILL_SPEC = "podracer.sample.r1=hit2:kill"
KILL_SEED = 81


def _session_root():
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rtl", dir=base if len(base) < 48
                            else "/tmp")


def _session_pids(root):
    """Live processes whose environment names the session root."""
    out = []
    for env in glob.glob("/proc/[0-9]*/environ"):
        try:
            with open(env, "rb") as f:
                if root.encode() in f.read():
                    out.append(int(env.split("/")[2]))
        except OSError:
            pass
    return [p for p in out if p != os.getpid()]


@pytest.fixture(scope="module")
def cluster():
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    root = _session_root()
    saved = {k: os.environ.get(k) for k in (
        "RAY_TPU_TORCH_TMPDIR", failpoints.ENV_SPEC, failpoints.ENV_SEED)}
    session = None
    try:
        os.environ["RAY_TPU_TORCH_TMPDIR"] = root
        failpoints.set_failpoints(KILL_SPEC, KILL_SEED)
        try:
            # one GPU declared as a resource: a lease pins "0" on a host
            # with no CUDA
            ray_tpu_torch.init(num_cpus=4, num_gpus=1, probe_gpu=False)
        finally:
            failpoints.clear_failpoints()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            failpoints.reload_failpoints()
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield {"root": root, "session": session}
    finally:
        ray_tpu_torch.shutdown()
        deadline = time.time() + 20
        while _session_pids(root) and time.time() < deadline:
            time.sleep(0.2)
        left = _session_pids(root)
        for p in glob.glob("/dev/shm/rtpt*"):
            if session and session[-8:] in p:
                os.unlink(p)
        shutil.rmtree(root, ignore_errors=True)
        assert not left, f"session processes left: {left}"


def _flat(tree):
    from ray_tpu_torch.ops.quant import tree_leaves

    return [t.numpy() for t in tree_leaves(tree)]


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(fa, fb))


def test_ppo_trains_and_round_trips_a_checkpoint(cluster, tmp_path):
    from ray_tpu_torch.rl import PPOConfig

    algo = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(minibatch_size=32, num_epochs=2)
            .debugging(seed=0)).build()
    try:
        for it in (1, 2):
            out = algo.train()
            assert out["training_iteration"] == it
            assert np.isfinite(out["learner"]["total_loss"])
            assert out["num_env_steps_sampled"] > 0
        saved = algo.get_state()
        assert all(t.device.type == "cpu" for t in
                   _leaves(saved["weights"]))
        algo.save_checkpoint(str(tmp_path / "ckpt"))
        algo.train()
        assert not _same(algo.get_state()["weights"], saved["weights"])
        algo.restore_from_path(str(tmp_path / "ckpt"))
        assert algo.iteration == 2
        assert _same(algo.get_state()["weights"], saved["weights"])
    finally:
        algo.stop()


def _leaves(tree):
    from ray_tpu_torch.ops.quant import tree_leaves

    return list(tree_leaves(tree))


def test_two_learner_group_syncs_bit_for_bit(cluster):
    from ray_tpu_torch.rl import LearnerGroup, MLPModuleConfig

    lg = LearnerGroup(MLPModuleConfig(obs_dim=4, num_actions=2, hidden=(8,)),
                      {"lr": 1e-3, "minibatch_size": 8, "num_epochs": 1},
                      num_learners=2, seed=3)
    try:
        rng = np.random.default_rng(0)
        n = 16
        batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, n),
                 "logp": np.full(n, -0.69, np.float32),
                 "advantages": rng.standard_normal(n).astype(np.float32),
                 "returns": rng.standard_normal(n).astype(np.float32),
                 "values": rng.standard_normal(n).astype(np.float32)}
        w0 = ray_tpu_torch.get(lg.get_weights_ref())
        stats = lg.update(batch)
        assert np.isfinite(stats["total_loss"])
        a, b = ray_tpu_torch.get([l.get_weights.remote()
                                  for l in lg.learners])
        # the averaged gradient keeps the two learners equal
        assert _same(a, b) and not _same(a, w0)
        ray_tpu_torch.get(lg.learners[1].set_weights.remote(w0))
        lg.sync_weights()
        a, b = ray_tpu_torch.get([l.get_weights.remote()
                                  for l in lg.learners])
        assert _same(a, b)
    finally:
        lg.shutdown()


@pytest.mark.parametrize("algo_name", ["IMPALA", "APPO"])
def test_impala_and_appo_take_a_training_step(cluster, algo_name):
    from ray_tpu_torch import rl

    cfg = getattr(rl, f"{algo_name}Config")()
    algo = (cfg.environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(num_aggregation_workers=1)
            .debugging(seed=1)).build()
    try:
        out = {"num_env_steps_sampled": 0}
        for _ in range(5):
            out = algo.training_step()
            if out["num_env_steps_sampled"]:
                break
        assert out["num_env_steps_sampled"] == 8 * 2
        assert np.isfinite(out["learner"]["total_loss"])
    finally:
        algo.stop()


def test_multi_agent_ppo_trains(cluster):
    from ray_tpu_torch.rl import MultiAgentEnv, MultiAgentPPO

    class TwoCatch(MultiAgentEnv):
        possible_agents = ["a", "b"]

        def __init__(self):
            from ray_tpu_torch.rl import CatchEnv

            self.envs = {a: CatchEnv(4) for a in self.possible_agents}

        def reset(self, seed=None):
            return {a: e.reset(seed=None if seed is None else seed + i)[0]
                    .reshape(-1) for i, (a, e) in
                    enumerate(self.envs.items())}, {}

        def step(self, actions):
            obs, rew, term = {}, {}, {}
            for a, e in self.envs.items():
                o, r, t, _, _ = e.step(actions[a])
                obs[a], rew[a], term[a] = o.reshape(-1), r, t
            term["__all__"] = all(term.values())
            return obs, rew, term, {"__all__": False}, {}

        def observation_space_shape(self, agent):
            return (16,)

        def num_actions(self, agent):
            return 3

    algo = MultiAgentPPO(TwoCatch, {"p": {"hidden": (8,)}},
                         lambda agent: "p", num_env_runners=1,
                         rollout_fragment_length=6, seed=0)
    try:
        out = algo.train()
        assert out["num_env_steps_sampled"] == 2 * 6
        assert np.isfinite(out["learner"]["p"]["total_loss"])
        assert set(out["episode_return_mean_per_agent"]) == {"a", "b"}
    finally:
        algo.stop()


def _run_pod(pod, min_updates, min_restarts=0, wall_s=90):
    deadline = time.time() + wall_s
    while ((pod._updates_done < min_updates
            or pod._runner_restarts < min_restarts)
           and time.time() < deadline):
        pod.step(max_wall_s=30)
    return pod.metrics()


def test_podracer_pixel_catch_smoke(cluster):
    """The three tiers on pixel CatchEnv(8) through the ViT module, its
    rank-1 runner under the armed kill schedule."""
    from ray_tpu_torch._private.serialization import reset_transport_stats
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rl import CatchEnv, PodracerConfig
    from ray_tpu_torch.rl.rl_module import PixelModuleConfig

    reset_transport_stats()
    puts_before = global_worker()._put_counter._value
    pod = (PodracerConfig()
           .environment("catch", env_fn=lambda: CatchEnv(8))
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .aggregation(num_aggregators=1, agg_fanin=2, queue_depth=2)
           .learners(mesh_devices=4)
           .training(broadcast_interval=2)
           .debugging(seed=0)).build()
    try:
        assert isinstance(pod.module_cfg, PixelModuleConfig)
        m = _run_pod(pod, min_updates=4)
        assert m["updates"] >= 4, m
        assert np.isfinite(pod._last_stats["total_loss"])
        assert set(pod._last_stats) == {"policy_loss", "vf_loss", "entropy",
                                        "total_loss", "mean_rho"}
        assert sum(m["staleness"].values()) >= 4 * 2, m["staleness"]
        assert all(int(k) >= 0 for k in m["staleness"])
        assert m["published_versions"] >= 2
        assert (m["transport"]["weight_bcast_puts"]
                == m["published_versions"] == len(m["publish_s"]))
        assert (global_worker()._put_counter._value - puts_before
                == m["published_versions"])
        agg = m["agg_transport"]
        assert (agg.get("inline_args", 0) + agg.get("direct_lane_args", 0)
                + agg.get("shm_args", 0)) >= m["updates"], agg
        t = ray_tpu_torch.get(pod.env_runner_group.runners[0]
                              .timings.remote())
        assert t["pull_s"] and t["env_step_ms"]
        # the learner updated on its lease's device: the CPU here
        w = ray_tpu_torch.get(pod.learner.get_weights.remote())
        assert w["vit"]["head"]["w"].dtype == torch.float32
    finally:
        pod.stop()


def test_podracer_runner_kill_recovers(cluster):
    """impala_runner_kill on the port: CartPole, three runners, rank 1
    killed at every incarnation's second rollout; the learner keeps
    training on the survivors and the driver restarts the dead runner."""
    from ray_tpu_torch.rl import PodracerConfig

    pod = (PodracerConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=3, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .aggregation(num_aggregators=1, agg_fanin=2, queue_depth=2)
           .learners(mesh_devices=2)
           .training(broadcast_interval=1)
           .debugging(seed=0)).build()
    try:
        m = _run_pod(pod, min_updates=6, min_restarts=1)
        assert m["runner_restarts"] >= 1, m
        assert m["updates"] >= 6, m
        assert sum(m["staleness"].values()) >= 6 * 2, m["staleness"]
        # training continues after the restart
        before = m["updates"]
        m = _run_pod(pod, min_updates=before + 2)
        assert m["updates"] >= before + 2, m
    finally:
        pod.stop()


def test_state_shows_leases_and_a_gpu_learner_without_cuda_raises(
        cluster):
    """util.state shows each actor's leased cards; a learner that leases
    the card but finds no CUDA raises rather than train on the CPU."""
    import cloudpickle

    from ray_tpu_torch.rl import LearnerGroup, MLPModuleConfig
    from ray_tpu_torch.rl.env_runner import EnvRunner
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote(num_gpus=1)
    class Holder:
        def ids(self):
            return ray_tpu_torch.get_gpu_ids()

    holder = Holder.remote()
    runner = EnvRunner.remote(
        "CartPole-v1", 1, cloudpickle.dumps(MLPModuleConfig(
            obs_dim=4, num_actions=2)))
    try:
        assert ray_tpu_torch.get(holder.ids.remote()) == ["0"]
        assert ray_tpu_torch.get(runner.ping.remote())
        rows = {a["actor_id"]: a for a in state.list_actors()}
        assert rows[holder._actor_id.hex()]["gpu_ids"] == ["0"]
        assert rows[runner._actor_id.hex()]["gpu_ids"] == []
    finally:
        ray_tpu_torch.kill(holder)
        ray_tpu_torch.kill(runner)

    @ray_tpu_torch.remote(num_gpus=1)
    def device_of_a_gpu_lease():
        from ray_tpu_torch.rl.learner import lease_device

        return str(lease_device())

    # the learners' and runners' device rule, in a task that leases "0"
    with pytest.raises(RuntimeError, match="finds no CUDA"):
        ray_tpu_torch.get(device_of_a_gpu_lease.remote(), timeout=60)
    lg = LearnerGroup(MLPModuleConfig(obs_dim=4, num_actions=2), {},
                      use_gpu=True)
    # the learner's creation raised; the call's error may say so or name
    # the worker that exited after it
    with pytest.raises(ray_tpu_torch.ActorDiedError):
        ray_tpu_torch.get(lg.get_weights_ref(), timeout=60)
    lg.shutdown()
