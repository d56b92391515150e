"""Parity of the PyTorch port's pipeline (``parallel/pipeline.py``) with the
JAX package's, on the CPU: the stacked layout (``stack_layers``,
``unstack_layers``, ``to_pipeline_params``, JAX's pipelined tree carried
across by ``params_from_numpy``), ``spmd_pipeline`` on a one-device mesh
(its stages in lockstep) against sequential application and against JAX's
shard_map on 4 CPU devices, ``pipeline_shardings`` against JAX's specs on
abstract trees, and the configurations the pipelined loss refuses.

The pipelined loss and its gradients against JAX's ``make_pipelined_loss``
run in ``tests/test_torch_parallel.py``: over its gloo group on pp=4,
pp=2 x tp=2 and pp=2 x fsdp=2, and on a one-device pp=4 mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import MeshSpec, make_mesh
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.parallel import training as ttrain

CPU = "cpu"
TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(vocab_size=64, d_model=16, n_layers=4, n_heads=2, n_kv_heads=1,
             d_ff=32, max_seq_len=32)
# 8 devices, as the JAX package's pipeline tests use them.
MESHES = {"pp2_tp2_fsdp2": dict(pp=2, tp=2, fsdp=2),
          "pp4_tp2": dict(pp=4, tp=2), "pp2_fsdp4": dict(pp=2, fsdp=4),
          "pp8": dict(pp=8), "pp2_tp4": dict(pp=2, tp=4)}
# A config whose d_ff (70) tp=4 does not divide, and d_model (36) fsdp=8.
ODD = dict(vocab_size=99, d_model=36, n_layers=8, n_heads=6, n_kv_heads=2,
           d_ff=70, max_seq_len=64)
CONFIGS = {
    "llama3_1b": (jllama.LLAMA3_1B, tllama.LLAMA3_1B),
    "odd": (jllama.LlamaConfig(**ODD, dtype=jnp.float32),
            tllama.LlamaConfig(**ODD, dtype=torch.float32)),
}


def _tcfg(**kw):
    return tllama.LlamaConfig(**dict(SMALL, **kw), dtype=torch.float32)


def test_stack_unstack_roundtrip():
    layers = [{"w": torch.ones(2, 2) * i, "b": torch.zeros(2),
               "experts": {"up": torch.full((3,), float(i))}}
              for i in range(4)]
    stacked = tpipe.stack_layers(layers)
    assert stacked["w"].shape == (4, 2, 2)
    assert stacked["experts"]["up"].shape == (4, 3)
    back = tpipe.unstack_layers(stacked)
    assert len(back) == 4
    for got, want in zip(back, layers):
        for (kg, g), (kw, w) in zip(tsharding.tree_paths(got),
                                    tsharding.tree_paths(want)):
            assert kg == kw and torch.equal(g, w)


def test_jax_pipelined_tree_reaches_the_port_unchanged():
    """JAX's to_pipeline_params tree, as numpy, converts leaf for leaf
    (names, order of stacking, values) to the port's to_pipeline_params of
    the same weights."""
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(np.asarray,
                                   jpipe.to_pipeline_params(jparams))
    got = params_from_numpy(jtree, device=CPU)
    want = tpipe.to_pipeline_params(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device=CPU))
    assert set(got) == set(want) == {"embedding", "norm", "lm_head",
                                     "stacked"}
    got_leaves = dict(tsharding.tree_paths(got))
    want_leaves = dict(tsharding.tree_paths(want))
    assert got_leaves.keys() == want_leaves.keys()
    for key, w in want_leaves.items():
        assert torch.equal(got_leaves[key], w), key
    assert got["stacked"]["wq"].shape == (4, 16, 16)


def _linear_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    return ws, x


def test_lockstep_pipeline_matches_sequential_and_jax(cpu_mesh8):
    """4 stages of 2 layers of tanh(x @ w), 4 microbatches of a row, on a
    one-device mesh: the output is the 8 layers applied in turn, and JAX's
    spmd_pipeline under shard_map on a pp=4 x dp=2 mesh (the port of
    tests/test_pipeline.py's linear stages); the gradient of w against
    sequential application."""
    from jax.sharding import PartitionSpec as P
    from ray_tpu.parallel._compat import shard_map

    ws, x = _linear_inputs()
    mesh = make_mesh(MeshSpec(pp=4), device=CPU)

    def layer_fn(w, h):
        return torch.tanh(h @ w)

    w = torch.from_numpy(ws).requires_grad_()
    out = tpipe.spmd_pipeline(tpipe.make_stage_fn(layer_fn, remat=True), w,
                              torch.from_numpy(x).reshape(4, 1, 16), mesh)
    out = out.reshape(4, 16)
    out.square().sum().backward()

    w_seq = torch.from_numpy(ws).requires_grad_()
    expect = torch.from_numpy(x)
    for i in range(8):
        expect = torch.tanh(expect @ w_seq[i])
    expect.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), expect.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(w.grad.numpy(), w_seq.grad.numpy(), **TOL)

    jmesh = jmake_mesh(JMeshSpec(pp=4, dp=2), devices=cpu_mesh8)
    jstage = jpipe.make_stage_fn(lambda w, h: jnp.tanh(h @ w), remat=False)

    def run(ws_local, xs):
        return jpipe.spmd_pipeline(jstage, ws_local,
                                   xs.reshape(4, 1, 16)).reshape(4, 16)

    want = jax.jit(shard_map(run, mesh=jmesh, in_specs=(P("pp"), P()),
                             out_specs=P(), check_vma=False))(ws, x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)


def test_lockstep_pipeline_runs_every_stage_on_every_tick():
    """M + S - 1 ticks, each stage on each (the bubble's ticks on zeros or
    the last microbatch again), as JAX's one program computes them."""
    calls = []

    def layer_fn(w, h):
        calls.append(float(w))
        return h + w

    mesh = make_mesh(MeshSpec(pp=4), device=CPU)
    ws = torch.arange(4.0)
    out = tpipe.spmd_pipeline(tpipe.make_stage_fn(layer_fn, remat=False), ws,
                              torch.zeros(3, 1, 2), mesh)
    assert len(calls) == (3 + 4 - 1) * 4
    assert calls == [0.0, 1.0, 2.0, 3.0] * 6
    assert torch.equal(out, torch.full((3, 1, 2), 6.0))


def _jax_stacked(jcfg):
    return jax.eval_shape(lambda: jpipe.stack_layers(
        jllama.init_params(jcfg, jax.random.PRNGKey(0))["layers"]))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("config", CONFIGS)
def test_pipeline_shardings_match_jax(cpu_mesh8, config, mesh):
    """Every stacked leaf's spec, on abstract shapes: axis 0 over pp, the
    rest by the tensor-parallel rules, axes dropped where they do not
    divide (the odd config on some mesh)."""
    jcfg, tcfg = CONFIGS[config]
    jmesh = jmake_mesh(JMeshSpec(**MESHES[mesh]), devices=cpu_mesh8)
    jstacked = _jax_stacked(jcfg)
    want = {k: tuple(s.spec) for k, s in
            jpipe.pipeline_shardings(jstacked, jmesh).items()}
    tstacked = tpipe.stack_layers(tllama.init_params(
        tcfg, torch.Generator().manual_seed(0), device="meta")["layers"])
    got = tpipe.pipeline_shardings(
        tstacked, make_mesh(MeshSpec(**MESHES[mesh]), device=CPU))
    assert got == want
    assert all(s[0] == "pp" for s in got.values())


def test_pipelined_specs_split_the_head_and_embedding_by_their_rules():
    mesh = make_mesh(MeshSpec(pp=2, tp=2, fsdp=2), device=CPU)
    tree = tpipe.to_pipeline_params(tllama.init_params(
        _tcfg(), torch.Generator().manual_seed(0), device="meta"))
    specs = tpipe.pipelined_specs(tree, mesh)
    assert specs["embedding"] == ("tp", "fsdp")
    assert specs["lm_head"] == ("fsdp", "tp")
    assert specs["norm"] == ()
    assert specs["stacked"]["wq"] == ("pp", "fsdp", "tp")
    assert specs["stacked"]["attn_norm"] == ("pp",)


def test_pipeline_shardings_raise_where_layers_do_not_divide_pp():
    mesh = make_mesh(MeshSpec(pp=4), device=CPU)
    stacked = tpipe.stack_layers(tllama.init_params(
        _tcfg(n_layers=6), torch.Generator().manual_seed(0),
        device="meta")["layers"])
    with pytest.raises(ValueError, match="not divisible by pp=4"):
        tpipe.pipeline_shardings(stacked, mesh)


@pytest.mark.parametrize("sizes,cfg_kw,match", [
    (dict(pp=4), dict(n_layers=6), "n_layers=6 not divisible by pp=4"),
    (dict(pp=2, tp=4), dict(n_heads=6, n_kv_heads=2), "heads"),
    (dict(pp=2, tp=2), dict(d_ff=33, n_heads=4, n_kv_heads=2),
     "d_ff=33 not divisible by tp=2"),
    (dict(pp=2, sp=2), {}, "no sp axis"),
    (dict(pp=2, ep=2), {}, "no ep axis"),
])
def test_make_pipelined_loss_refuses_what_jax_refuses(sizes, cfg_kw, match):
    """JAX's raises (layers over pp, heads and d_ff over tp), and sp or ep
    with pp, which JAX's pipelined loss does not run."""
    mesh = make_mesh(MeshSpec(**sizes), device=CPU)
    with pytest.raises(ValueError, match=match):
        tpipe.make_pipelined_loss(mesh, _tcfg(**cfg_kw), 2)


def test_pipelined_loss_refuses_a_batch_the_microbatches_do_not_split():
    cfg = _tcfg()
    mesh = make_mesh(MeshSpec(pp=2), device=CPU)
    params = tpipe.to_pipeline_params(tllama.init_params(
        cfg, torch.Generator().manual_seed(0), device=CPU))
    loss = tpipe.make_pipelined_loss(mesh, cfg, 4)
    with pytest.raises(ValueError, match="local batch 6 not divisible into "
                                         "4 microbatches"):
        loss(params, torch.zeros(6, 8, dtype=torch.long))


def test_sharded_loss_fn_sends_a_pp_mesh_to_the_pipelined_loss():
    cfg = _tcfg()
    mesh = make_mesh(MeshSpec(pp=2), device=CPU)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device=CPU)
    with pytest.raises(NotImplementedError, match="make_pipelined_loss"):
        ttrain.sharded_loss_fn(params, torch.zeros(2, 8, dtype=torch.long),
                               cfg, mesh)
