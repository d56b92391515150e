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

Since the ``data`` slice the same clusters also hold the trainers'
dataset shards (``datasets=``, ``get_dataset_shard``) to JAX's for one
and two workers, ``train.torch``'s ``prepare_model``,
``prepare_data_loader`` and ``backward`` over gloo to the JAX package's
``TorchTrainer``, ``get_device`` (C3) in workers with and without a GPU,
and run a real HF ``Trainer`` in a port worker fed by a port dataset.

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
        # two GPUs as a resource only (no card is probed): C3's worker
        # that holds one
        ray_tpu_torch.init(num_cpus=4, num_gpus=2, probe_gpu=False)
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


# ----------------------------------------------------- datasets and helpers


@pytest.mark.parametrize("workers", [1, 2])
def test_dataset_shards_match_jax_trainer(clusters, tmp_path, workers):
    """``TorchTrainer(datasets=)``: "train" (named by ``DataConfig``) is
    streaming-split one shard a worker and "eval" handed whole to each,
    as the JAX trainer does; ``get_dataset_shard`` returns them. The
    port's worker reads its shards; the JAX worker reports them and the
    driver reads them, since a JAX worker killed at the end of ``fit()``
    keeps the CPUs of the tasks it leased (C6 in the reference), which
    would leave its cluster without a CPU for the next test."""
    from ray_tpu import data as jd
    from ray_tpu import train as jtrain
    from ray_tpu_torch import data as td
    from ray_tpu_torch import train as ptrain

    rng = np.random.default_rng(3)
    rows = [{"id": i, "v": float(v)} for i, v in
            enumerate(rng.standard_normal(90))]

    def run(data, train, trainer_cls, name, read_in_worker):
        def loop(cfg):
            import importlib

            t = importlib.import_module(cfg["pkg"] + ".train")
            shards = {n: t.get_dataset_shard(n) for n in ("train", "eval")}
            if cfg["read"]:
                shards = {n: [r["id"] for r in sh.iter_rows()]
                          for n, sh in shards.items()}
            t.report({"rank": t.get_context().get_world_rank(), **shards})

        res = trainer_cls(
            loop, train_loop_config={"pkg": data.__name__.split(".")[0],
                                     "read": read_in_worker},
            datasets={"train": data.from_items(rows, parallelism=5),
                      "eval": data.from_items(rows[:7])},
            dataset_config=train.DataConfig(datasets_to_split=["train"]),
            scaling_config=train.ScalingConfig(num_workers=workers),
            run_config=train.RunConfig(name=name,
                                       storage_path=str(tmp_path))).fit()
        assert res.error is None, res.error
        return {rank: {n: m[n] if read_in_worker else
                       [r["id"] for r in m[n].iter_rows()]
                       for n in ("train", "eval")}
                for rank, m in res.metrics_all_workers.items()}

    want = run(jd, jtrain, jtrain.JaxTrainer, "jax", read_in_worker=False)
    got = run(td, ptrain, ptrain.TorchTrainer, "port", read_in_worker=True)
    assert sorted(got) == sorted(want) == list(range(workers))
    for rank in want:
        assert got[rank]["train"] == want[rank]["train"]
        assert got[rank]["eval"] == want[rank]["eval"] == list(range(7))
    assert sorted(i for r in got.values() for i in r["train"]) == \
        list(range(90))


def test_prepare_helpers_over_gloo_match_jax_torch_trainer(clusters,
                                                           tmp_path):
    """``prepare_model`` (DDP), ``prepare_data_loader`` (a
    DistributedSampler) and ``backward`` over a two-worker gloo group:
    each rank's sampled indices and its parameters after an epoch of SGD
    equal the JAX package's ``TorchTrainer``'s (fp32, the same sums)."""
    import ray_tpu.train as jtrain
    from ray_tpu_torch import train as ptrain

    rng = np.random.default_rng(8)
    x = rng.standard_normal((96, 8)).astype(np.float32)
    y = rng.standard_normal(96).astype(np.float32)

    def loop(cfg):
        import importlib

        import torch
        import torch.nn.functional as F
        from torch.nn.parallel import DistributedDataParallel

        t = importlib.import_module(cfg["pkg"] + ".train")
        tt = importlib.import_module(cfg["pkg"] + ".train.torch")
        torch.manual_seed(0)
        model = tt.prepare_model(torch.nn.Sequential(
            torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1)))
        data = torch.utils.data.TensorDataset(torch.from_numpy(cfg["x"]),
                                              torch.from_numpy(cfg["y"]))
        loader = tt.prepare_data_loader(torch.utils.data.DataLoader(
            data, batch_size=12, shuffle=True))
        loader.sampler.set_epoch(1)
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        for xb, yb in loader:
            opt.zero_grad()
            tt.backward(F.mse_loss(model(xb).squeeze(-1), yb))
            opt.step()
        t.report({"rank": t.get_context().get_world_rank(),
                  "ddp": isinstance(model, DistributedDataParallel),
                  "device": str(tt.get_device()),
                  "indices": list(loader.sampler),
                  "params": [p.detach().numpy().copy()
                             for p in model.parameters()]})

    def run(train, trainer_cls, pkg):
        return trainer_cls(
            loop, train_loop_config={"pkg": pkg, "x": x, "y": y},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name=pkg,
                                       storage_path=str(tmp_path))).fit()

    want = run(jtrain, jtrain.TorchTrainer, "ray_tpu")
    got = run(ptrain, ptrain.TorchTrainer, "ray_tpu_torch")
    assert want.error is None and got.error is None, (want.error, got.error)
    for rank in (0, 1):
        w, g = want.metrics_all_workers[rank], got.metrics_all_workers[rank]
        assert g["ddp"] and w["ddp"]
        assert g["device"] == w["device"] == "cpu"
        assert g["indices"] == w["indices"] and len(g["indices"]) == 48
        for gp, wp in zip(g["params"], w["params"]):
            np.testing.assert_allclose(gp, wp, rtol=1e-6, atol=1e-7)
    assert set(got.metrics_all_workers[0]["indices"]).isdisjoint(
        got.metrics_all_workers[1]["indices"])


def test_get_device_is_the_workers_card(clusters, tmp_path):
    """C3. The reference's ``get_device()`` is the CPU in every worker.
    The port's is the CPU in a worker that holds no GPU; ``cuda:0`` in one
    that holds a GPU, where the loop fakes CUDA (this host has none); and
    such a worker without CUDA raises rather than fall back."""
    from ray_tpu.train import torch as jtorch
    from ray_tpu_torch import train

    assert str(jtorch.get_device()) == "cpu"

    def loop(cfg):
        import torch

        import ray_tpu_torch
        from ray_tpu_torch import train

        if cfg["fake_cuda"]:
            torch.cuda.is_available = lambda: True
        try:
            device = str(train.torch.get_device())
        except RuntimeError as e:
            device = f"raised: {e}"
        train.report({"device": device,
                      "gpu_ids": ray_tpu_torch.get_gpu_ids()})

    def run(name, use_gpu, fake_cuda):
        res = train.TorchTrainer(
            loop, train_loop_config={"fake_cuda": fake_cuda},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=use_gpu),
            run_config=train.RunConfig(name=name,
                                       storage_path=str(tmp_path))).fit()
        assert res.error is None, res.error
        return res.metrics

    cpu = run("cpu", False, False)
    assert cpu["device"] == "cpu" and cpu["gpu_ids"] == []
    gpu = run("gpu", True, True)
    assert gpu["device"] == "cuda:0" and len(gpu["gpu_ids"]) == 1
    missing = run("no_cuda", True, False)
    assert missing["device"].startswith("raised: this worker holds GPU")


def test_hf_trainer_in_a_port_worker_fed_by_a_dataset_shard(clusters,
                                                            tmp_path):
    """``tests/test_train_huggingface.py``'s real ``transformers.Trainer``
    run, in a port worker: the shard from ``get_dataset_shard`` through
    ``prepare_trainer``, metrics and the HF checkpoint through
    ``RayTrainReportCallback``."""
    from ray_tpu_torch import data as td
    from ray_tpu_torch import train

    def hf_loop(config):
        import os

        import torch
        from transformers import Trainer, TrainingArguments

        import ray_tpu_torch.train as train
        from ray_tpu_torch.train.huggingface import (RayTrainReportCallback,
                                                     prepare_trainer)

        class TinyRegressor(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.w = torch.nn.Linear(4, 1)

            def forward(self, x=None, labels=None, **kw):
                pred = self.w(x).squeeze(-1)
                loss = torch.nn.functional.mse_loss(pred, labels)
                return {"loss": loss, "logits": pred}

        shard = train.get_dataset_shard("train")
        ctx = train.get_context()
        args = TrainingArguments(
            output_dir=os.path.join(ctx.get_storage_path(), "hf_out"),
            max_steps=6,
            per_device_train_batch_size=4, logging_steps=2, save_steps=4,
            save_strategy="steps", report_to=[], use_cpu=True,
            disable_tqdm=True)
        trainer = Trainer(model=TinyRegressor(), args=args,
                          train_dataset=shard,
                          callbacks=[RayTrainReportCallback()])
        prepare_trainer(trainer)
        trainer.train()

    rng = np.random.default_rng(6)
    rows = [{"x": rng.random(4).astype(np.float32),
             "labels": np.float32(i % 2)} for i in range(64)]
    result = train.TorchTrainer(
        hf_loop, datasets={"train": td.from_items(rows)},
        scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(name="hf",
                                   storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert "loss" in result.metrics or "train_loss" in result.metrics
    assert result.checkpoint is not None
    assert os.path.isdir(result.checkpoint.path)
