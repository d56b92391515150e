"""Parity of the PyTorch port's Mixtral (``models/mixtral.py``) with the JAX
package's, on the CPU in fp32: ``forward`` (logits and aux), ``loss_fn``
and its gradients with and without remat, greedy decoding through llama's
loop with the MoE as its ``ffn`` hook, the parameter counts, and the
conversion of a bf16 Mixtral tree and a ViT tree (fp32 router and head
kept, bits exact, and back).

Weights come from the JAX ``init_params`` and reach the port through numpy
and ``params_from_numpy``. Both sides compute in fp32 and differ only in
the order of their sums (blockwise flash attention against JAX's dense
oracle, batched expert products against einsums), so logits and losses
are held at rtol 1e-5 and atol 1e-5, gradients at rtol 1e-4 and atol
2e-5, and greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mixtral as jmix
from ray_tpu.models import vit as jvit
from ray_tpu_torch import models as tmodels
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.models.convert import (params_from_numpy, params_to_numpy,
                                          trainable)

CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
SMALL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=64, n_experts=4, top_k=2)
JCFG = jmix.MixtralConfig(**SMALL, dtype=jnp.float32)
TCFG = tmix.MixtralConfig(**SMALL, dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jparams = jmix.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _tokens(shape=(2, 16), seed=0):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], shape).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("name", ["MIXTRAL_8X7B", "MIXTRAL_DEBUG", "small"])
def test_counts_and_tree_match_jax(name):
    """param_count and active_param_count equal JAX's; init_params builds
    JAX's tree (shapes, the fp32 router), and its leaves hold
    param_count values."""
    jcfg, tcfg = ((JCFG, TCFG) if name == "small" else
                  (getattr(jmix, name), getattr(tmodels, name)))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    if name == "MIXTRAL_8X7B":  # the published total and active counts
        assert (tcfg.param_count(), tcfg.active_param_count()) == \
            (46702792704, 12879925248)
        return
    jtree = jax.eval_shape(lambda: jmix.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    ttree = tmix.init_params(tcfg, torch.Generator().manual_seed(0),
                             device=CPU)
    want = {k: tuple(v.shape) for k, v in _flat(jtree).items()}
    got = {k: tuple(v.shape) for k, v in _flat(ttree).items()}
    assert got == want
    assert ttree["layers"][0]["router"].dtype == torch.float32
    assert sum(int(np.prod(s)) for s in got.values()) == tcfg.param_count()


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_and_aux_match_jax(model, remat):
    jparams, tree = model
    tokens = _tokens()
    jlogits, jaux = jmix.forward(jparams, jnp.asarray(tokens), JCFG,
                                 remat=remat)
    tparams = params_from_numpy(tree, device=CPU)
    trainable(tparams)  # so remat's checkpoints run
    logits, aux = tmix.forward(tparams, torch.from_numpy(tokens), TCFG,
                               remat=remat)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **VALUE_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **VALUE_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_jax(model, remat):
    """loss_fn (CE + aux_coef x aux) and every leaf's gradient, experts and
    router included, against jax.value_and_grad."""
    jparams, tree = model
    tokens = _tokens(seed=1)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmix.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, JCFG, remat=remat)))(jparams)
    tparams = params_from_numpy(tree, device=CPU)
    trainable(tparams)
    got = tmix.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)}, TCFG,
                       remat=remat)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **VALUE_TOL)
    want = _flat(grads)
    tgrads = {k: t.grad for k, t in _flat(tparams).items()}
    assert tgrads.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=k)
    assert float(tgrads["layers/0/router"].abs().sum()) > 0


def test_generate_greedy_tokens_match_jax(model):
    """The cached decode loop with the MoE hook: JAX's tokens, and the
    llama loop's default FFN left as it was (a dense model's decode)."""
    jparams, tree = model
    prompt = _tokens((2, 7), seed=2)
    want = jmix.generate_greedy(jparams, jnp.asarray(prompt), JCFG,
                                max_new=10)
    got = tmodels.mixtral_generate_greedy(
        params_from_numpy(tree, device=CPU), torch.from_numpy(prompt), TCFG,
        max_new=10)
    assert got.tolist() == np.asarray(want).tolist()


def test_decode_step_logits_match_jax(model):
    """One cached prefill step through the ffn hook: JAX's logits."""
    jparams, tree = model
    prompt = _tokens((1, 9), seed=3)
    total = 12
    jcache = [(jnp.zeros((1, total, 2, 16)), jnp.zeros((1, total, 2, 16)))
              for _ in range(JCFG.n_layers)]
    from ray_tpu.ops.layers import rope_frequencies as jrope
    jcos, jsin = jrope(16, total, JCFG.rope_theta)
    want, _ = jmix._decode_step(jparams, jnp.asarray(prompt), jcache, 0,
                                JCFG, jcos, jsin)
    tparams = params_from_numpy(tree, device=CPU)
    caches = tmodels.llama.new_caches(TCFG, 1, total, CPU)
    cos, sin = tmodels.llama.rope_frequencies(16, total, TCFG.rope_theta)
    got, _ = tmix._decode_step(tparams, torch.from_numpy(prompt), caches, 0,
                               TCFG, cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE_TOL)


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("family", ["mixtral", "vit"])
def test_bf16_trees_convert_as_they_are_and_back(family):
    """A bf16 Mixtral tree keeps its nested experts dict and its fp32
    router, a bf16 ViT tree its fp32 head; every bf16 leaf's bits are
    exact, and params_to_numpy gives every value back."""
    if family == "mixtral":
        jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
        jtree = jmix.init_params(jcfg, jax.random.PRNGKey(4))
        fp32 = {"layers/0/router", "layers/1/router"}
    else:
        jcfg = jvit.ViTConfig(image_size=32, patch_size=8, num_classes=10,
                              d_model=64, n_layers=2, n_heads=2, d_ff=128)
        jtree = jvit.init_params(jcfg, jax.random.PRNGKey(4))
        fp32 = {"head/w", "head/b"}
    tree = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             device=CPU)
    want, got = _flat(jtree), _flat(tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in fp32:
            assert got[k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
        else:
            assert got[k].dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy().view(np.uint16), _bits(w))
    back = _flat(params_to_numpy(tree))
    for k, w in want.items():
        np.testing.assert_array_equal(back[k],
                                      np.asarray(w).astype(np.float32))
