"""The port's ``TorchTrainer`` against the JAX package's ``JaxTrainer``,
on the CPU.

Each trainer runs three AdamW steps of ``LLAMA_DEBUG`` (fp32) in one
worker actor of its own package's cluster, from the same weights (JAX's
``init_params``, handed to the port as numpy) and the same tokens, both
put into the object store by the driver. Both sides compute in fp32 and
differ only in the order of their sums, so the reported losses are held
at rtol 1e-5 (as ``test_torch_training.py`` holds ``loss_fn`` and AdamW).
The port's restart after a planted worker death, restored from step 2's
checkpoint, must give the uninterrupted step 3's loss exactly, and two
gloo workers on halves of the batch must give one worker's losses on the
whole of it within 1e-5.

The loops are defined inside the tests, so cloudpickle ships them by
value: no worker imports this module (which imports JAX), and the port's
workers never import JAX at all. The fixture shuts both clusters down and
removes the port's arenas and session directory, failures included.
"""

import glob
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jllama

STEPS = 3
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtt", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    # a cluster another module left behind would have other resources
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(num_cpus=4, probe_tpu=False, ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=4, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield root
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in glob.glob("/dev/shm/rtpt*"):
                if session and session[-8:] in p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def inputs():
    """LLAMA_DEBUG's weights from JAX's init_params (seed 0) as numpy, and
    [4, 32] tokens from a numpy seed."""
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jllama.LLAMA_DEBUG,
                                       jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(
        0, jllama.LLAMA_DEBUG.vocab_size, (4, 32)).astype(np.int64)
    return params, tokens


def _port_fit(tmp_path, name, config, num_workers=1, max_failures=0):
    from ray_tpu_torch import train

    def loop(cfg):
        import os

        import torch

        import ray_tpu_torch
        from ray_tpu_torch import models, parallel, train

        torch.set_num_threads(1)
        params = models.params_from_numpy(ray_tpu_torch.get(cfg["params"]),
                                          device="cpu")
        tokens = torch.as_tensor(ray_tpu_torch.get(cfg["tokens"]))
        leaves = models.trainable(params)
        opt = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.1)
        ctx = train.get_context()
        mesh = None
        if ctx.get_world_size() > 1:
            mesh = parallel.make_mesh(
                parallel.MeshSpec(dp=ctx.get_world_size()), device="cpu")
        losses, start = [], 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            state = train.load_pytree(ckpt.path)
            with torch.no_grad():
                for t, saved in zip(leaves, state["leaves"]):
                    t.copy_(saved)
            opt.load_state_dict(state["opt"])
            losses, start = state["losses"], state["step"]
        for step in range(start, cfg["steps"]):
            opt.zero_grad(set_to_none=True)
            if mesh is None:
                loss = models.loss_fn(params, {"tokens": tokens},
                                      models.LLAMA_DEBUG)
                loss.backward()
                total = loss.detach()
            else:
                loss = parallel.sharded_loss_fn(params, tokens,
                                                models.LLAMA_DEBUG, mesh)
                loss.backward()
                parallel.allreduce_grads(leaves, mesh)
                total = parallel.collectives.allreduce(loss.detach(), mesh)
            opt.step()
            losses.append(float(total))
            checkpoint = None
            if step + 1 == cfg["checkpoint_after"]:
                path = os.path.join(ctx.get_storage_path(),
                                    ctx.get_trial_name(),
                                    f"checkpoint_{step:06d}")
                if ctx.get_world_rank() == 0:
                    train.save_pytree(
                        {"leaves": [t.detach() for t in leaves],
                         "opt": opt.state_dict(), "losses": losses,
                         "step": step + 1}, path)
                checkpoint = train.Checkpoint(path)
            train.report({"losses": list(losses),
                          "rank": ctx.get_world_rank()},
                         checkpoint=checkpoint)
            if cfg["die_after"] == step + 1 and ckpt is None:
                os._exit(1)  # the planted death, first attempt only

    trainer = train.TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=num_workers),
        run_config=train.RunConfig(
            name=name, storage_path=str(tmp_path),
            failure_config=train.FailureConfig(max_failures=max_failures)))
    result = trainer.fit()
    assert result.error is None, result.error
    return result


def _port_config(inputs, **kw):
    params, tokens = inputs
    cfg = {"params": ray_tpu_torch.put(params),
           "tokens": ray_tpu_torch.put(tokens), "steps": STEPS,
           "checkpoint_after": 2, "die_after": 0}
    cfg.update(kw)
    return cfg


def test_torch_trainer_matches_jax_trainer(clusters, inputs, tmp_path):
    from ray_tpu.train import JaxTrainer, RunConfig, ScalingConfig

    def jax_loop(cfg):
        import jax
        import jax.numpy as jnp
        import optax

        import ray_tpu
        from ray_tpu import train
        from ray_tpu.models import llama

        params = jax.tree_util.tree_map(jnp.asarray,
                                        ray_tpu.get(cfg["params"]))
        batch = {"tokens": jnp.asarray(ray_tpu.get(cfg["tokens"]),
                                       jnp.int32)}
        opt = optax.adamw(3e-4, weight_decay=0.1)
        state = opt.init(params)
        losses = []
        value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, b: llama.loss_fn(p, b, llama.LLAMA_DEBUG)))
        for _ in range(cfg["steps"]):
            loss, grads = value_and_grad(params, batch)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
            train.report({"losses": list(losses)})

    params, tokens = inputs
    jres = JaxTrainer(
        jax_loop, train_loop_config={"params": ray_tpu.put(params),
                                     "tokens": ray_tpu.put(tokens),
                                     "steps": STEPS},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="jax", storage_path=str(tmp_path))).fit()
    assert jres.error is None, jres.error
    pres = _port_fit(tmp_path, "port", _port_config(inputs))
    jl, pl = jres.metrics["losses"], pres.metrics["losses"]
    assert len(jl) == len(pl) == STEPS
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL, atol=0)
    assert pl[-1] < pl[0]
    # step 2's checkpoint is in the run's storage, parameters and AdamW
    ckpt = pres.checkpoint
    assert ckpt is not None and ckpt.path.endswith("checkpoint_000001")
    from ray_tpu_torch.train import load_pytree

    state = load_pytree(ckpt.path)
    assert state["step"] == 2 and len(state["leaves"]) == len(
        jax.tree_util.tree_leaves(params))
    assert set(state["opt"]["state"][0]) == {"step", "exp_avg",
                                             "exp_avg_sq"}


def test_restart_restores_the_uninterrupted_step(clusters, inputs, tmp_path):
    """A worker that exits hard just after step 2's checkpoint, on its
    first attempt: the trainer restarts it once, the loop restores the
    parameters and AdamW state, and step 3's loss is the uninterrupted
    run's, bit for bit."""
    plain = _port_fit(tmp_path, "plain", _port_config(inputs))
    restarted = _port_fit(tmp_path, "restarted",
                          _port_config(inputs, die_after=2),
                          max_failures=1)
    assert restarted.metrics["losses"] == plain.metrics["losses"]


def test_two_gloo_workers_equal_one_on_the_global_batch(clusters, inputs,
                                                         tmp_path):
    one = _port_fit(tmp_path, "one", _port_config(inputs, steps=2))
    two = _port_fit(tmp_path, "two", _port_config(inputs, steps=2),
                    num_workers=2)
    ranks = two.metrics_all_workers
    assert sorted(m["rank"] for m in ranks.values()) == [0, 1]
    for m in ranks.values():
        np.testing.assert_allclose(m["losses"], one.metrics["losses"],
                                   rtol=LOSS_RTOL, atol=0)
