"""Parity of the PyTorch port's MPMD stage math
(``parallel/mpmd_pipeline.py``) with the JAX package's, on the CPU: the
layer split, ``split_llama_params`` / ``merge_stage_params``, chained
``stage_forward`` -> ``stage_loss`` (dense and chunked vocab) with the
gradients of every leaf, and ``stage_param_count`` / ``stage_hbm_budget``
at Llama-3-8B's widths. The stage actors of the JAX module wait for the
port's actors and are not tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mpmd_pipeline as jmpmd
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, trainable
from ray_tpu_torch.parallel import mpmd_pipeline as tmpmd
from ray_tpu_torch.parallel import sharding as tsharding

CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
CFG = dict(vocab_size=96, d_model=64, n_layers=5, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq_len=64)
TOKENS = (2, 32)
CHUNK = 40  # the chunked loss's vocab chunk: 40 + 40 + 16
# the device memory passed to both budgets (a value, not a device's)
HBM_GIB = 80.0


def _inputs():
    jcfg = jllama.LlamaConfig(**CFG, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(4)))
    tokens = np.random.default_rng(3).integers(
        0, CFG["vocab_size"], TOKENS).astype(np.int32)
    return jcfg, tree, tokens


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("n_layers,n_stages",
                         [(16, 4), (7, 3), (32, 5), (4, 4), (5, 2)])
def test_stage_layer_counts_match_jax(n_layers, n_stages):
    got = tmpmd.stage_layer_counts(n_layers, n_stages)
    assert got == jmpmd.stage_layer_counts(n_layers, n_stages)
    assert sum(got) == n_layers


@pytest.mark.parametrize("n_layers,n_stages,match", [
    (3, 4, "cannot fill"), (8, 1, "at least 2 stages")])
def test_stage_layer_counts_raise_as_jax(n_layers, n_stages, match):
    for mod in (tmpmd, jmpmd):
        with pytest.raises(ValueError, match=match):
            mod.stage_layer_counts(n_layers, n_stages)


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_split_then_merge_is_the_tree(n_stages):
    """Each stage holds what JAX's split gives it (the embedding on the
    first, the norm and head on the last, the layers in order), and the
    merge gives back the same leaves."""
    _, tree, _ = _inputs()
    params = params_from_numpy(tree, device=CPU)
    stages = tmpmd.split_llama_params(params, n_stages)
    jstages = jmpmd.split_llama_params(tree, n_stages)
    assert [sorted(s) for s in stages] == [sorted(s) for s in jstages]
    assert [len(s["layers"]) for s in stages] == \
        [len(s["layers"]) for s in jstages]
    for got, want in zip(stages, jstages):
        g, w = _flat(got), _flat(want)
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), w[key])
    merged = tmpmd.merge_stage_params(stages)
    assert _flat(merged).keys() == _flat(params).keys()
    for key, t in _flat(params).items():
        assert _flat(merged)[key] is t


def test_split_refuses_tied_embeddings_and_merge_an_empty_list():
    _, tree, _ = _inputs()
    tied = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="tie_embeddings=False"):
        tmpmd.split_llama_params(params_from_numpy(tied, device=CPU), 2)
    with pytest.raises(ValueError, match="no stage params"):
        tmpmd.merge_stage_params([])


def _chain(mod, stages, tokens, targets, cfg, chunked):
    x = mod.stage_forward(stages[0], tokens, cfg, first=True)
    for stage in stages[1:-1]:
        x = mod.stage_forward(stage, x, cfg, first=False)
    return mod.stage_loss(stages[-1], x, targets, cfg, chunked_vocab=chunked)


@pytest.mark.parametrize("chunked", [0, CHUNK])
@pytest.mark.parametrize("n_stages", [2, 3])
def test_chained_stages_match_jax(n_stages, chunked):
    """The stages chained, first to last, with remat: the loss and the
    gradient of every leaf against JAX's chain (jax.grad through its
    stages), and the loss against loss_fn's of the whole tree."""
    jcfg, tree, tokens = _inputs()
    targets = np.concatenate(
        [tokens[:, 1:], np.full((TOKENS[0], 1), -100, np.int32)], axis=1)

    def jloss(p):
        return _chain(jmpmd, jmpmd.split_llama_params(p, n_stages),
                      jnp.asarray(tokens), jnp.asarray(targets), jcfg,
                      chunked)

    want, want_grads = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    cfg = tllama.LlamaConfig(**CFG, dtype=torch.float32)
    params = params_from_numpy(tree, device=CPU)
    trainable(params)
    loss = _chain(tmpmd, tmpmd.split_llama_params(params, n_stages),
                  torch.from_numpy(tokens), torch.from_numpy(targets), cfg,
                  chunked)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **VALUE_TOL)
    with torch.no_grad():
        plain = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, chunked_vocab=chunked)
    np.testing.assert_allclose(loss.item(), plain.item(), **VALUE_TOL)
    got = {k.replace("/", "."): t.grad.numpy()
           for k, t in tsharding.tree_paths(params)}
    want_grads = {k: np.asarray(v) for k, v in _flat(want_grads).items()}
    assert got.keys() == want_grads.keys()
    for key, w in want_grads.items():
        np.testing.assert_allclose(got[key], w, **GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_stage_counts_and_budgets_match_jax_at_8b(schedule):
    """Llama-3-8B over 4 stages of 16 devices: each stage's parameter
    count and every row of its memory budget equal JAX's, with the same
    device memory passed to both; the counts sum to the model's."""
    jcfg, tcfg = jllama.LLAMA3_8B, tllama.LLAMA3_8B
    kw = dict(devices_per_stage=16, batch_per_chip=1, seq=8192,
              n_microbatches=8, hbm_gib_per_chip=HBM_GIB, schedule=schedule)
    counts = []
    for i in range(4):
        counts.append(tmpmd.stage_param_count(tcfg, 4, i))
        assert counts[-1] == jmpmd.stage_param_count(jcfg, 4, i)
        assert tmpmd.stage_hbm_budget(tcfg, 4, i, **kw) == \
            jmpmd.stage_hbm_budget(jcfg, 4, i, **kw)
    assert sum(counts) == tcfg.param_count()


def test_budget_takes_the_device_memory_from_the_caller():
    with pytest.raises(TypeError, match="hbm_gib_per_chip"):
        tmpmd.stage_hbm_budget(tllama.LLAMA3_8B, 4, 0, devices_per_stage=16,
                               batch_per_chip=1, seq=8192, n_microbatches=8)
