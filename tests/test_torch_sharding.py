"""Parity of the PyTorch port's sharding rules (``parallel/sharding.py``)
with the JAX package's, on the CPU and on abstract shapes: the rule table,
``spec_for``, ``clean_spec``, the tree paths and ``shardings_for_tree`` on
``LLAMA3_1B`` (``meta`` tensors, so no 1B tree is built) and on a small
config whose dims some axes do not divide; ``mixtral_shardings`` and
``expert_shardings`` on a small Mixtral over meshes with an ``ep`` axis;
``VIT_RULES`` on ViT-B/16's tree. The port's spec is a tuple with the
entries of JAX's ``PartitionSpec``; both are compared as tuples.

The shards themselves (``shard_params``, ``gather_params``, the sharded
step against JAX) run in the one gloo group of
``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import trainable
from ray_tpu_torch.parallel import MeshSpec, make_mesh
from ray_tpu_torch.parallel import sharding as tsharding

# 8 devices, as the JAX package's sharding tests use them.
MESHES = {
    "fsdp8": dict(fsdp=8),
    "fsdp2_tp4": dict(fsdp=2, tp=4),
    "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2),
    "tp8": dict(tp=8),
    "sp2_tp4": dict(sp=2, tp=4),
}
# A small config with a dim that some axis of every mesh does not divide:
# d_model 36 (fsdp 8), vocab 99 (tp 2, 4, 8), d_ff 70 (tp 4, 8).
ODD = dict(vocab_size=99, d_model=36, n_layers=2, n_heads=6, n_kv_heads=2,
           d_ff=70, max_seq_len=64)
CONFIGS = {
    "llama3_1b": (jllama.LLAMA3_1B, tllama.LLAMA3_1B),
    "odd": (jllama.LlamaConfig(**ODD, dtype=jnp.float32),
            tllama.LlamaConfig(**ODD, dtype=torch.float32)),
}
PATHS = ["embedding", "lm_head", "norm", "layers/0/wq", "layers/3/wk",
         "layers/1/wv", "layers/2/wo", "layers/0/w_gate", "layers/0/w_up",
         "layers/7/w_down", "layers/0/attn_norm", "layers/0/mlp_norm",
         "layers/0/w_qkv", "blocks/0/scale", "head/bias", "other"]


def _jax_tree(jcfg):
    return jax.eval_shape(lambda: jllama.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))


def _torch_tree(tcfg):
    return tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="meta")


def _jmesh(cpu_mesh8, sizes):
    return jmake_mesh(JMeshSpec(**sizes), devices=cpu_mesh8)


def test_rule_table_matches_jax():
    assert [(p, s) for p, s in tsharding.LLAMA_RULES] == \
        [(p, tuple(s)) for p, s in jsharding.LLAMA_RULES]


@pytest.mark.parametrize("path", PATHS)
def test_spec_for_matches_jax(path):
    assert tsharding.spec_for(path) == tuple(jsharding.spec_for(path))


@pytest.mark.parametrize("spec,dims", [
    (("tp", "fsdp"), (128256, 2048)), (("tp", "fsdp"), (100, 36)),
    (("fsdp", "tp"), (36, 36)), ((("dp", "fsdp"), None), (8, 3)),
    ((("dp", "fsdp"), "tp"), (6, 8)), (("fsdp", "tp", None), (16,)),
    ((None, "tp"), (3, 5)), ((), (4, 4))])
def test_clean_spec_matches_jax(cpu_mesh8, spec, dims):
    """Axes that do not divide their dim are dropped, with a tuple of axes
    taken as their product, dims past the shape as None, and trailing
    Nones trimmed."""
    from jax.sharding import PartitionSpec as P

    sizes = MESHES["dp2_fsdp2_tp2"]
    want = jsharding.clean_spec(P(*spec), dims, _jmesh(cpu_mesh8, sizes))
    got = tsharding.clean_spec(spec, dims,
                               make_mesh(MeshSpec(**sizes), device="cpu"))
    assert got == tuple(want)


@pytest.mark.parametrize("config", CONFIGS)
def test_tree_paths_match_jax(config):
    jcfg, tcfg = CONFIGS[config]
    want = jax.tree_util.tree_leaves(jsharding._tree_paths(_jax_tree(jcfg)))
    got = [p for _, p in tsharding.tree_paths(
        tsharding._tree_paths(_torch_tree(tcfg)))]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("config", CONFIGS)
def test_shardings_for_tree_match_jax(cpu_mesh8, config, mesh):
    """Every leaf's cleaned spec, on abstract shapes: the odd config drops
    an axis from some leaf on every mesh, the 1B one on none."""
    jcfg, tcfg = CONFIGS[config]
    jspecs = jsharding.shardings_for_tree(_jax_tree(jcfg),
                                          _jmesh(cpu_mesh8, MESHES[mesh]))
    want = {p: tuple(s.spec) for p, s in zip(
        jax.tree_util.tree_leaves(jsharding._tree_paths(_jax_tree(jcfg))),
        jax.tree_util.tree_leaves(jspecs))}
    tmesh = make_mesh(MeshSpec(**MESHES[mesh]), device="cpu")
    tree = _torch_tree(tcfg)
    got = dict(tsharding.tree_paths(tsharding.shardings_for_tree(tree,
                                                                 tmesh)))
    assert got == want
    dropped = [p for p, s in got.items() if s != tsharding.spec_for(p)]
    assert bool(dropped) == (config == "odd"), dropped


def test_activation_sharding_matches_jax(cpu_mesh8):
    sizes = MESHES["dp2_fsdp2_tp2"]
    want = jsharding.activation_sharding(_jmesh(cpu_mesh8, sizes)).spec
    got = tsharding.activation_sharding(
        make_mesh(MeshSpec(**sizes), device="cpu"))
    assert got == tuple(want)


def test_optimizer_shardings_give_moments_their_params_spec():
    """After a step, AdamW's two moments carry their parameter's spec and
    its step count is replicated, keyed as the optimizer's state dict:
    JAX's ``optimizer_shardings`` mirrors each moment onto its parameter's
    sharding and replicates the count."""
    cfg = tllama.LlamaConfig(**ODD, dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    mesh = make_mesh(MeshSpec(**MESHES["fsdp2_tp4"]), device="cpu")
    specs = tsharding.shardings_for_tree(params, mesh)
    opt = torch.optim.AdamW(trainable(params), lr=1e-3)
    for t in trainable(params):
        t.grad = torch.ones_like(t)
    opt.step()
    got = tsharding.optimizer_shardings(opt, specs)
    leaf_specs = [s for _, s in tsharding.tree_paths(specs)]
    assert sorted(got) == sorted(opt.state_dict()["state"])
    for i, entry in got.items():
        assert entry == {"step": (), "exp_avg": leaf_specs[i],
                         "exp_avg_sq": leaf_specs[i]}
    assert any(s for s in leaf_specs)
    with pytest.raises(ValueError, match="specs for"):
        tsharding.optimizer_shardings(opt, leaf_specs[:-1])


def test_one_device_mesh_keeps_the_tree_whole():
    """A one-device mesh takes global tensors: shard_params and
    gather_params hand the tree back as it is."""
    cfg = tllama.LlamaConfig(**ODD, dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    mesh = make_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
    specs = tsharding.shardings_for_tree(params, mesh)
    assert tsharding.shard_params(params, mesh, specs) is params
    assert tsharding.gather_params(params, mesh, specs) is params


# MoE meshes over 8 devices, every one with an ep axis.
EP_MESHES = {
    "ep2_tp2_fsdp2": dict(ep=2, tp=2, fsdp=2),
    "ep8": dict(ep=8),
    "ep4_tp2": dict(ep=4, tp=2),
    "dp2_ep4": dict(dp=2, ep=4),
}
# E = 4 experts: ep = 8 divides no expert dim, and d_ff 70 no tp.
MOE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=70, max_seq_len=64, n_experts=4, top_k=2)


def _mixtral_trees():
    from ray_tpu.models import mixtral as jmix
    from ray_tpu_torch.models import mixtral as tmix

    jcfg = jmix.MixtralConfig(**MOE, dtype=jnp.float32)
    tcfg = tmix.MixtralConfig(**MOE, dtype=torch.float32)
    jtree = jax.eval_shape(lambda: jmix.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    ttree = tmix.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="meta")
    return jmix, tmix, jtree, ttree


def _jax_specs(jtree, jspecs):
    return {p: tuple(s.spec) for p, s in zip(
        jax.tree_util.tree_leaves(jsharding._tree_paths(jtree)),
        jax.tree_util.tree_leaves(jspecs))}


@pytest.mark.parametrize("mesh", EP_MESHES)
def test_mixtral_and_expert_shardings_match_jax(cpu_mesh8, mesh):
    """mixtral_shardings (LLAMA_RULES, then expert_shardings for each
    layer's experts) and expert_shardings alone, leaf by leaf, on abstract
    shapes: the experts over ep (where it divides E), d_ff over tp (where
    it divides), d_model over fsdp; the router replicated."""
    from ray_tpu.parallel import moe as jmoe
    from ray_tpu_torch.parallel import moe as tmoe

    jmix, tmix, jtree, ttree = _mixtral_trees()
    jmesh = _jmesh(cpu_mesh8, EP_MESHES[mesh])
    tmesh = make_mesh(MeshSpec(**EP_MESHES[mesh]), device="cpu")
    want = _jax_specs(jtree, jmix.mixtral_shardings(jtree, jmesh))
    got = dict(tsharding.tree_paths(tmix.mixtral_shardings(ttree, tmesh)))
    assert got == want
    assert got["layers/0/router"] == ()
    jexp = jmoe.expert_shardings(jtree["layers"][1]["experts"], jmesh)
    assert tmoe.expert_shardings(ttree["layers"][1]["experts"], tmesh) == \
        {k: tuple(s.spec) for k, s in jexp.items()}


def test_vit_rule_table_matches_jax():
    assert [(p, s) for p, s in tsharding.VIT_RULES] == \
        [(p, tuple(s)) for p, s in jsharding.VIT_RULES]


@pytest.mark.parametrize("mesh", MESHES)
def test_vit_shardings_for_tree_match_jax(cpu_mesh8, mesh):
    """shardings_for_tree under VIT_RULES on ViT-B/16's abstract tree
    (1000 classes, which tp = 8 does not divide)."""
    from ray_tpu.models import vit as jvit
    from ray_tpu_torch.models import vit as tvit

    jtree = jax.eval_shape(lambda: jvit.init_params(jvit.ViTConfig(),
                                                    jax.random.PRNGKey(0)))
    jspecs = jsharding.shardings_for_tree(
        jtree, _jmesh(cpu_mesh8, MESHES[mesh]), jsharding.VIT_RULES)
    ttree = tvit.init_params(tvit.ViTConfig(),
                             torch.Generator().manual_seed(0), device="meta")
    got = dict(tsharding.tree_paths(tsharding.shardings_for_tree(
        ttree, make_mesh(MeshSpec(**MESHES[mesh]), device="cpu"),
        tsharding.VIT_RULES)))
    assert got == _jax_specs(jtree, jspecs)


# tests/test_vit.py's tiny ViT: 5 classes, which tp = 4 and tp = 2 do not
# divide, so clean_spec drops tp from the head's spec and keeps fsdp.
TINY_VIT = dict(image_size=16, patch_size=4, channels=3, num_classes=5,
                d_model=32, n_layers=2, n_heads=4, d_ff=64)


@pytest.mark.parametrize("mesh", ["fsdp2_tp4", "dp2_fsdp2_tp2", "tp8"])
def test_tiny_vit_shardings_match_jax_and_drop_the_heads_tp(cpu_mesh8,
                                                            mesh):
    from ray_tpu.models import vit as jvit
    from ray_tpu_torch.models import vit as tvit

    jtree = jax.eval_shape(lambda: jvit.init_params(
        jvit.ViTConfig(**TINY_VIT, dtype=jnp.float32),
        jax.random.PRNGKey(0)))
    jspecs = jsharding.shardings_for_tree(
        jtree, _jmesh(cpu_mesh8, MESHES[mesh]), jsharding.VIT_RULES)
    ttree = tvit.init_params(tvit.ViTConfig(**TINY_VIT, dtype=torch.float32),
                             torch.Generator().manual_seed(0), device="meta")
    got = dict(tsharding.tree_paths(tsharding.shardings_for_tree(
        ttree, make_mesh(MeshSpec(**MESHES[mesh]), device="cpu"),
        tsharding.VIT_RULES)))
    assert got == _jax_specs(jtree, jspecs)
    assert "tp" not in tsharding.spec_axes(got["head/w"])
    if "fsdp" in MESHES[mesh]:
        assert got["head/w"][0] == "fsdp"
        assert got["patch_embed/w"] == ("fsdp", "tp")
    assert got["norm"] == got["pos_embed"] == got["patch_embed/b"] == ()
