"""Parity of the port's ``rl/`` (``ray_tpu_torch.rl``) with the JAX
package's ``ray_tpu.rl`` on the CPU, with no cluster.

Inputs come from numpy with a seed; weights are drawn by the JAX modules'
``init`` and carried across by ``models.convert.params_from_numpy``. Both
sides compute in fp32 and differ only in the order of their sums (and,
for the pixel module, blockwise flash attention against JAX's dense
oracle), so values are held at rtol 1e-5 and atol 1e-5 and gradients at
rtol 1e-4 and atol 1e-6 (``VALUE_TOL``, ``GRAD_TOL``). An Adam step
divides by the gradient's running scale, so where a gradient is near
zero its step follows the gradient's last digits: parameters after an
update are held at ``PARAM_TOL`` (atol 2e-6 at lr 3e-4, under a hundredth
of a step). The rollouts are held exactly: their policy makes one action
certain, so the draws cannot differ.
"""

import ast
import importlib
import re
import threading
from pathlib import Path

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import env_runner as jenv
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import mesh_learner as jmesh
from ray_tpu.rl import pixel_env as jpix
from ray_tpu.rl import ppo_loss as jppo
from ray_tpu.rl import rl_module as jrm
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.rl import env_runner as tenv
from ray_tpu_torch.rl import learner as tlearner
from ray_tpu_torch.rl import mesh_learner as tmesh
from ray_tpu_torch.rl import pixel_env as tpix
from ray_tpu_torch.rl import ppo_loss as tppo
from ray_tpu_torch.rl import rl_module as trm

# the packages export a function named vtrace over the module's name
jvt = importlib.import_module("ray_tpu.rl.vtrace")
tvt = importlib.import_module("ray_tpu_torch.rl.vtrace")
REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=2e-6)
HP = {"lr": 3e-4, "grad_clip": 0.5, "clip_param": 0.2,
      "entropy_coeff": 0.01, "vf_loss_coeff": 0.5}
MLP = dict(obs_dim=6, num_actions=3, hidden=(16, 16))
PIXEL8 = dict(image_size=8, num_actions=3)  # the defaults: head dim 8
PIXEL64 = dict(image_size=16, num_actions=3, patch_size=8, d_model=128,
               n_layers=2, n_heads=2, d_ff=256)  # head dim 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jcfg, seed=0):
    return _np(jrm.init(jcfg, jax.random.PRNGKey(seed)))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


def _close_trees(got, want, tol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_trees(got[k], want[k], tol, f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_trees(g, w, tol, f"{what}/{i}")
    else:
        _close(got, want, tol, what)


def _rollout(rng, T, N, A):
    return dict(
        behaviour=np.log(rng.dirichlet(np.ones(A), (T, N))[..., 0]
                         ).astype(np.float32),
        target=np.log(rng.dirichlet(np.ones(A), (T, N))[..., 0]
                      ).astype(np.float32),
        rewards=rng.standard_normal((T, N)).astype(np.float32),
        values=rng.standard_normal((T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.2,
        bootstrap=rng.standard_normal(N).astype(np.float32))


# ------------------------------------------------------- vtrace and gae


def test_vtrace_and_gae_are_the_reference_numpy():
    rng = np.random.default_rng(0)
    r = _rollout(rng, 12, 5, 3)
    args = (r["behaviour"], r["target"], r["rewards"], r["values"],
            r["dones"], r["bootstrap"])
    for kw in ({}, {"gamma": 0.9, "clip_rho": 0.8, "clip_c": 1.2,
                    "lam": 0.7}):
        for got, want in zip(tvt.vtrace(*args, **kw),
                             jvt.vtrace(*args, **kw)):
            np.testing.assert_array_equal(got, want)
    gargs = (r["rewards"], r["values"], r["dones"], r["bootstrap"])
    for got, want in zip(tlearner.gae(*gargs, 0.97, 0.9),
                         jlearner.gae(*gargs, 0.97, 0.9)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lam", [1.0, 0.9, 0.5])
def test_vtrace_scan_matches_jax(lam):
    rng = np.random.default_rng(1)
    r = _rollout(rng, 16, 6, 4)
    args = (r["behaviour"], r["target"], r["rewards"], r["values"],
            r["dones"], r["bootstrap"])
    want = jvt.vtrace_scan(*[jnp.asarray(a) for a in args], 0.99, 1.0,
                           0.9, lam)
    got = tvt.vtrace_scan(*[torch.from_numpy(np.asarray(a)) for a in args],
                          0.99, 1.0, 0.9, lam)
    for g, w in zip(got, want):
        _close(g, w, VALUE_TOL, f"vtrace_scan lam={lam}")
    # and the numpy function of the same package
    for g, w in zip(got, tvt.vtrace(*args, 0.99, 1.0, 0.9, lam)):
        _close(g, w, VALUE_TOL, f"vtrace lam={lam}")


# ------------------------------------------------------------ forwards


def test_mlp_forward_and_sample_match_jax():
    jcfg = jrm.MLPModuleConfig(**MLP)
    tcfg = trm.MLPModuleConfig(**MLP)
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jp, device=CPU)
    obs = np.random.default_rng(2).standard_normal((7, 6)).astype(np.float32)
    want = jrm.forward_jit(jp, jnp.asarray(obs))
    got = trm.forward(tp, torch.from_numpy(obs))
    for g, w in zip(got, want):
        _close(g, w, VALUE_TOL, "mlp forward")
    # a port init has the JAX tree, shapes and dtypes
    mine = trm.init(tcfg, torch.Generator().manual_seed(0), device=CPU)
    assert jax.tree_util.tree_structure(params_to_numpy(mine)) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(mine)),
                    jax.tree_util.tree_leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
    actions, logp, value = trm.sample_actions(
        tp, obs, torch.Generator().manual_seed(0))
    logits = np.asarray(want[0])
    ref = jax.nn.log_softmax(logits)[np.arange(7), actions]
    _close(logp, ref, VALUE_TOL, "sampled logp")
    _close(value, want[1], VALUE_TOL, "sampled value")


@pytest.mark.parametrize("widths", [PIXEL8, PIXEL64],
                         ids=["head_dim_8", "head_dim_64"])
def test_pixel_forward_matches_jax(widths):
    jcfg = jrm.PixelModuleConfig(**widths)
    tcfg = trm.PixelModuleConfig(**widths)
    assert tcfg.vit.dtype == torch.float32
    assert tcfg.vit.head_dim == jcfg.vit.head_dim
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jp, device=CPU)
    n = widths["image_size"]
    obs = np.random.default_rng(3).random((5, n, n, 1)).astype(np.float32)
    want = jrm.make_forward(jcfg)(jp, jnp.asarray(obs))
    got = trm.make_forward(tcfg)(tp, torch.from_numpy(obs))
    for g, w in zip(got, want):
        _close(g, w, VALUE_TOL, f"pixel forward {widths}")
    # the learner's and a runner's attention shapes at phase 24's widths
    # (ViT-B/16 on 64 x 64 x 1 pixels: 17 tokens, 12 heads of 64) are the
    # kernels'; the repo's pixel defaults (head dim 8) and the bench's
    # (16) are not, and would run dense_attention on CUDA
    hd = tcfg.vit.head_dim
    q = torch.empty(2, tcfg.vit.num_patches + 1, tcfg.vit.n_heads, hd)
    assert tattn.kernel_takes(q, q, q) == (hd == 64)
    for B in (512, 64, 16):
        q = torch.empty(B, 17, 12, 64)
        assert tattn.kernel_takes(q, q, q)
    for head_dim in (8, 16):
        q = torch.empty(16, 17, 4, head_dim)
        assert not tattn.kernel_takes(q, q, q)


def test_sample_under_no_grad_has_no_graph():
    tcfg = trm.PixelModuleConfig(**PIXEL8)
    tp = trm.init(tcfg, torch.Generator().manual_seed(0), device=CPU)
    from ray_tpu_torch.models.convert import trainable

    trainable(tp)
    obs = np.zeros((3, 8, 8, 1), np.float32)
    a, logp, v = trm.make_sample_fn(tcfg)(tp, obs,
                                          torch.Generator().manual_seed(1))
    assert a.shape == (3,) and logp.dtype == np.float32 and v.shape == (3,)
    eps = trm.epsilon_greedy_actions(
        trm.init(trm.MLPModuleConfig(**MLP), torch.Generator(), CPU),
        np.zeros((4, 6), np.float32), torch.Generator().manual_seed(0), 0.5)
    assert eps.shape == (4,) and eps.dtype == np.int32


# ---------------------------------------------------------------- PPO


def _ppo_batch(rng, n, obs_dim=6, A=3):
    return {
        "obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, A, n).astype(np.int64),
        "logp": np.log(rng.uniform(0.2, 0.5, n)).astype(np.float32),
        "advantages": (3 * rng.standard_normal(n)).astype(np.float32),
        "returns": (3 * rng.standard_normal(n)).astype(np.float32),
        "values": rng.standard_normal(n).astype(np.float32),
    }


def _optax_chain(hp):
    return optax.chain(optax.clip_by_global_norm(hp["grad_clip"]),
                       optax.adam(hp["lr"]))


def test_ppo_loss_and_grads_match_jax():
    jcfg = jrm.MLPModuleConfig(**MLP)
    jp = _jax_params(jcfg, 1)
    tp = params_from_numpy(jp, device=CPU)
    batch = _ppo_batch(np.random.default_rng(4), 24)
    jupd = jppo.make_ppo_update(_optax_chain(HP), HP)
    jgrads, jstats = jupd.compute_grads(jax.tree_util.tree_map(
        jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    opt = tppo.ClipAdam(tp, HP["lr"], HP["grad_clip"])
    tupd = tppo.make_ppo_update(opt, HP)
    tgrads, tstats = tupd.compute_grads(tp, tlearner.to_tensors(batch, CPU))
    assert set(tstats) == set(jstats)
    for k in jstats:
        _close(tstats[k], jstats[k], VALUE_TOL, k)
    # the advantage is normalised by the population std, as jnp.std
    adv = batch["advantages"]
    assert float(np.std(adv)) != float(np.std(adv, ddof=1))
    # grads come in the port's leaf order: the tree's insertion order
    from ray_tpu_torch.ops.quant import tree_leaves

    names = _leaf_paths(jp)
    want = dict(zip(names, jax.tree_util.tree_leaves(_np(jgrads))))
    order = _leaf_paths_in_order(tp)
    assert len(tgrads) == len(list(tree_leaves(tp)))
    for name, g in zip(order, tgrads):
        _close(g, want[name], GRAD_TOL, f"grad {name}")


def _leaf_paths(tree, prefix=""):
    """Leaf paths in JAX's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(
            tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(
            v, f"{prefix}/{i}")]
    return [prefix]


def _leaf_paths_in_order(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths_in_order(
            v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths_in_order(
            v, f"{prefix}/{i}")]
    return [prefix]


@pytest.mark.parametrize("steps", [1, 3])
def test_clip_adam_matches_the_optax_chain(steps):
    """optax's clip_by_global_norm then adam, with a gradient norm above
    the clip (and one step below it). torch.optim.Adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8) is optax.adam's step."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    tx = _optax_chain(HP)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    tp = params_from_numpy(tree, device=CPU)
    opt = tppo.ClipAdam(tp, HP["lr"], HP["grad_clip"])
    norms = []
    for s in range(steps):
        scale = 0.01 if s == 1 else 5.0  # step 2 is under the clip
        g = {"a": (scale * rng.standard_normal((4, 3))).astype(np.float32),
             "b": [(scale * rng.standard_normal(5)).astype(np.float32)]}
        norms.append(float(optax.global_norm(g)))
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.apply([torch.from_numpy(g["a"]), torch.from_numpy(g["b"][0])])
    assert norms[0] > HP["grad_clip"]
    if steps > 1:
        assert norms[1] < HP["grad_clip"]
    _close_trees(params_to_numpy(tp), _np(jparams),
                 dict(rtol=1e-6, atol=1e-7), f"{steps} steps")


def _jax_learner_update(jp, batch, hp):
    """``ray_tpu.rl.Learner.update``'s loop (one learner) on JAX's jitted
    step: RandomState(0)'s permutation each call."""
    tx = _optax_chain(hp)
    upd = jppo.make_ppo_update(tx, hp)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    state = tx.init(params)
    n = batch["obs"].shape[0]
    mb = hp.get("minibatch_size", min(n, 128))
    rng = np.random.RandomState(0)
    stats = {}
    for _ in range(hp.get("num_epochs", 4)):
        perm = rng.permutation(n)
        for s in range(0, n, mb):
            idx = perm[s:s + mb]
            params, state, stats = upd.step(
                params, state, {k: jnp.asarray(v[idx])
                                for k, v in batch.items()})
    return _np(params), {k: float(v) for k, v in stats.items()}


def _port_learner(jcfg_kw, hp, jp, **kw):
    learner = tlearner.Learner._cls(
        cloudpickle.dumps(trm.MLPModuleConfig(**jcfg_kw)), hp, device=CPU,
        **kw)
    learner.set_weights(jp)
    return learner


def test_learner_update_matches_jax_step():
    hp = dict(HP, minibatch_size=8, num_epochs=2)
    jp = _jax_params(jrm.MLPModuleConfig(**MLP), 2)
    batch = _ppo_batch(np.random.default_rng(6), 20)  # a short last mb
    want_params, want_stats = _jax_learner_update(jp, batch, hp)
    learner = _port_learner(MLP, hp, jp)
    stats = learner.update(batch)
    assert set(stats) == set(want_stats)
    for k in want_stats:
        _close(stats[k], want_stats[k], VALUE_TOL, k)
    got = learner.get_weights()
    assert all(t.device.type == "cpu" for t in _tensors(got))
    _close_trees(params_to_numpy(got), want_params, PARAM_TOL)
    # get_weights is a copy: a later update does not reach it
    before = params_to_numpy(got)
    learner.update(batch)
    _close_trees(params_to_numpy(got), before, dict(rtol=0, atol=0))


def _tensors(tree):
    from ray_tpu_torch.ops.quant import tree_leaves

    return list(tree_leaves(tree))


class _ThreadGroup:
    """HostCollectiveGroup's ``allreduce`` for learners in threads."""

    def __init__(self, n):
        self.n = n
        self.parts = {}
        self.barrier = threading.Barrier(n)

    def member(self, rank):
        group = self

        class Member:
            def allreduce(self, arr, op="sum"):
                assert op == "mean"
                group.parts[rank] = np.array(arr)
                group.barrier.wait()
                out = np.stack([group.parts[r] for r in range(group.n)])
                group.barrier.wait()
                return out.mean(0)

        return Member()


def test_two_learner_average_matches_jax_shards():
    hp = dict(HP, minibatch_size=10, num_epochs=1)
    jp = _jax_params(jrm.MLPModuleConfig(**MLP), 3)
    batch = _ppo_batch(np.random.default_rng(7), 20)
    shards = [{k: v[i * 10:(i + 1) * 10] for k, v in batch.items()}
              for i in range(2)]
    # JAX: each shard's gradient on its own permutation, averaged, one
    # optax step
    tx = _optax_chain(hp)
    upd = jppo.make_ppo_update(tx, hp)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    perm = np.random.RandomState(0).permutation(10)
    grads = [upd.compute_grads(params, {k: jnp.asarray(v[perm])
                                        for k, v in s.items()})[0]
             for s in shards]
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    want, _ = upd.apply_grads(params, tx.init(params), mean)
    group = _ThreadGroup(2)
    learners = []
    for rank in range(2):
        lrn = _port_learner(MLP, hp, jp, rank=rank, world_size=2)
        lrn.group = group.member(rank)
        learners.append(lrn)
    errors = []

    def run(i):
        try:
            learners[i].update(shards[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    a, b = (params_to_numpy(lrn.get_weights()) for lrn in learners)
    _close_trees(a, b, dict(rtol=0, atol=0), "the two learners")
    _close_trees(a, _np(want), PARAM_TOL, "against JAX")


# ------------------------------------------------------------ V-trace


def _vtrace_batch(rng, T, B, image):
    mask = np.ones((T, B), bool)
    dones = np.zeros((T, B), bool)
    dones[2, 0] = dones[4, 1] = True
    mask[3, 0] = mask[5, 1] = False  # the autoreset rows after them
    return {
        "obs": rng.random((T, B, image, image, 1)).astype(np.float32),
        "actions": rng.integers(0, 3, (T, B)).astype(np.int64),
        "logp": np.log(rng.uniform(0.2, 0.5, (T, B))).astype(np.float32),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "dones": dones, "mask": mask,
        "bootstrap_value": rng.standard_normal(B).astype(np.float32),
    }


def test_vtrace_mesh_learner_matches_jax():
    widths = PIXEL8
    hp = dict(HP, gamma=0.97, vtrace_lambda=0.9)
    jl = jmesh.VtraceMeshLearner(jrm.PixelModuleConfig(**widths), hp,
                                 n_devices=1, seed=0)
    jp = _np(jl.get_weights())
    tl = tmesh.VtraceMeshLearner(trm.PixelModuleConfig(**widths), hp,
                                 n_devices=1, seed=0, device=CPU)
    tl.set_weights(jp)
    batch = _vtrace_batch(np.random.default_rng(8), 6, 2, 8)
    want = jl.update({k: v.copy() for k, v in batch.items()})
    got = tl.update(batch)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], VALUE_TOL, k)
    _close_trees(params_to_numpy(tl.get_weights()), _np(jl.get_weights()),
                 PARAM_TOL)
    # the divisibility contract of the mesh stays
    four = tmesh.VtraceMeshLearner(trm.PixelModuleConfig(**widths), hp,
                                   n_devices=4, seed=0, device=CPU)
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        four.update(batch)


def test_mesh_learner_ppo_matches_jax():
    hp = dict(HP, minibatch_size=8, num_epochs=2)
    jl = jmesh.MeshLearner(jrm.MLPModuleConfig(**MLP), hp, n_devices=1,
                           seed=0)
    tl = tmesh.MeshLearner(trm.MLPModuleConfig(**MLP), hp, n_devices=1,
                           seed=0, device=CPU)
    tl.set_weights(_np(jl.get_weights()))
    batch = _ppo_batch(np.random.default_rng(9), 20)
    want = jl.update(batch)
    got = tl.update(batch)
    for k in want:
        _close(got[k], want[k], VALUE_TOL, k)
    _close_trees(params_to_numpy(tl.get_weights()), _np(jl.get_weights()),
                 PARAM_TOL)


def test_mesh_learner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.VtraceMeshLearner(trm.PixelModuleConfig(**PIXEL8), HP)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trm.init(trm.MLPModuleConfig(**MLP), torch.Generator())


# ------------------------------------------------------------ runners


def _certain(params, action, value=0.5):
    """Set the policy head so ``action`` is certain and the value fixed."""
    head = params["vit"]["head"] if "vit" in params else params["pi"]
    head["w"] = np.zeros_like(head["w"])
    b = np.zeros_like(head["b"])
    b[action] = 1e4
    head["b"] = b
    params["vf"]["w"] = np.zeros_like(params["vf"]["w"])
    params["vf"]["b"] = np.full_like(params["vf"]["b"], value)
    return params


@pytest.mark.parametrize("env", ["catch8", "cartpole"])
def test_runner_rollouts_match_jax(env):
    if env == "catch8":
        jcfg = jrm.PixelModuleConfig(**PIXEL8)
        tcfg = trm.PixelModuleConfig(**PIXEL8)
        jfn = cloudpickle.dumps(lambda: jpix.CatchEnv(8))
        tfn = cloudpickle.dumps(lambda: tpix.CatchEnv(8))
        env_id, action = "catch", 2
    else:
        jcfg = jrm.MLPModuleConfig(obs_dim=4, num_actions=2)
        tcfg = trm.MLPModuleConfig(obs_dim=4, num_actions=2)
        jfn = tfn = None
        env_id, action = "CartPole-v1", 0
    jp = _certain(_jax_params(jcfg), action)
    jr = jenv.EnvRunnerImpl(env_id, 3, cloudpickle.dumps(jcfg), seed=11,
                            env_fn_blob=jfn)
    tr = tenv.EnvRunnerImpl(env_id, 3, cloudpickle.dumps(tcfg), seed=11,
                            env_fn_blob=tfn, device=CPU)
    tp = params_from_numpy(jp, device=CPU)
    for _ in range(2):  # the second fragment starts mid-episode
        want = jr._collect(jax.tree_util.tree_map(jnp.asarray, jp), 24)
        got = tr.sample(tp, 24)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (~got["mask"]).any()  # autoreset rows were masked
    assert tr.episode_stats() == jr.episode_stats()


@pytest.mark.parametrize("env", ["catch4", "cartpole"])
def test_vector_env_matches_gymnasium(env):
    import gymnasium as gym

    make = ((lambda: tpix.CatchEnv(4)) if env == "catch4"
            else (lambda: gym.make("CartPole-v1")))
    mine = tenv.SyncVectorEnv([make for _ in range(3)])
    ref = gym.vector.SyncVectorEnv([make for _ in range(3)])
    assert mine.autoreset_mode == ref.autoreset_mode.value
    assert tenv._next_step_autoreset(mine) and tenv._next_step_autoreset(ref)
    o1, _ = mine.reset(seed=5)
    o2, _ = ref.reset(seed=5)
    np.testing.assert_array_equal(o1, o2)
    assert o1.dtype == o2.dtype
    rng = np.random.default_rng(0)
    for _ in range(40):
        actions = rng.integers(0, 2, 3)
        for a, b in zip(mine.step(actions)[:4], ref.step(actions)[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- copies


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["connectors.py", "replay.py"])
def test_copies_are_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch/rl" / module).read_text()
    want = _renamed((REPO / "ray_tpu/rl" / module).read_text())
    assert _code(got) == _code(want)


def test_connectors_run_like_the_reference():
    from ray_tpu.rl import connectors as jc
    from ray_tpu_torch.rl import connectors as tc

    rng = np.random.default_rng(12)
    batch = {"obs": rng.standard_normal((6, 4, 2, 2)).astype(np.float32),
             "rewards": 3 * rng.standard_normal((6, 4)).astype(np.float32),
             "values": rng.standard_normal((6, 4)).astype(np.float32),
             "dones": rng.random((6, 4)) < 0.3,
             "bootstrap_value": rng.standard_normal(4).astype(np.float32)}
    outs = []
    for mod in (jc, tc):
        pipe = mod.default_learner_pipeline(0.9, 0.8)
        pipe.prepend(mod.ClipRewards(1.0)).append(mod.NormalizeObs())
        outs.append(pipe({k: v.copy() for k, v in batch.items()}))
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])


def test_second_half_names_raise_not_ported():
    import ray_tpu_torch.rl as rl
    from ray_tpu_torch._private.roadmap import ITEMS

    for name in ("DQN", "SAC", "CQL", "BC", "MARWIL", "DreamerV3",
                 "DreamerV3Algo", "DQNConfig", "SACConfig", "CQLConfig",
                 "BCConfig", "MARWILConfig"):
        with pytest.raises(NotImplementedError, match="A14b"):
            getattr(rl, name)
    for module in ("dqn.py", "sac.py", "continuous.py", "cql.py",
                   "offline.py", "dreamerv3.py"):
        assert module in ITEMS["rl"]
        assert not (REPO / "ray_tpu_torch/rl" / module).exists()
    with pytest.raises(AttributeError):
        rl.NoSuchName
    import ray_tpu.rl as jrl

    assert rl.Impala is rl.IMPALA and rl.ImpalaConfig is rl.IMPALAConfig
    missing = set(jrl.__all__) - set(rl.__all__) - set(rl.NOT_PORTED)
    assert not missing, missing


def test_catch_env_without_gymnasium_carries_plain_spaces():
    env = tpix.CatchEnv(8, seed=0)
    plain_obs = tpix.Box(0.0, 1.0, (8, 8, 1))
    assert env.observation_space.shape == plain_obs.shape
    assert env.action_space.n == tpix.Discrete(3).n == 3
    j = jpix.CatchEnv(8, seed=0)
    for a in (0, 1, 2, 1, 0, 2, 2, 1, 0, 1):
        o1, r1, t1, u1, _ = env.step(a)
        o2, r2, t2, u2, _ = j.step(a)
        np.testing.assert_array_equal(o1, o2)
        assert (r1, t1, u1) == (r2, t2, u2)
        if t1:
            np.testing.assert_array_equal(env.reset(seed=3)[0],
                                          j.reset(seed=3)[0])
