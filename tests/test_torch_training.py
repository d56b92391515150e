"""Parity of the PyTorch port's training slice with the JAX package, on the
CPU in fp32: the flash backward's plain version, the chunked-vocab loss,
``loss_fn`` and its gradients, and AdamW steps against optax.

Inputs come from numpy with a seed, weights from the JAX ``init_params``
through ``params_from_numpy``. Both sides compute in fp32 and differ only
in the order of their sums (blockwise against dense softmax, fused
against unfused products), so values are held at rtol 1e-5 and
gradients, which pass through more sums, at atol 2e-5 and rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import attention as jattn
from ray_tpu.ops import chunked_xent as jxent
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import (params_from_numpy, params_to_numpy,
                                          trainable)
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import chunked_xent as txent

CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)

JCFG = jllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=64,
                          dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=64,
                          dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small: the suite runs files in
    parallel workers, beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _jparams(seed=0):
    return jllama.init_params(JCFG, jax.random.PRNGKey(seed))


def _tparams(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device=CPU)


def _grads_close(tparams, jgrads):
    """Each leaf's .grad of the port's tree against JAX's gradient tree."""
    tg = jax.tree_util.tree_map(
        lambda t: t.grad.numpy(), tparams, is_leaf=torch.is_tensor)
    paths = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(paths) == len(jax.tree_util.tree_leaves(tg))
    for path, want in paths:
        got = tg
        for key in path:
            got = got[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------ flash backward

ATTN_CASES = [  # (B, L, H, Hkv, D, causal)
    (1, 64, 2, 2, 64, True),
    (1, 64, 2, 2, 64, False),
    (2, 48, 4, 2, 64, True),      # GQA, 2 query heads per kv head
    (1, 77, 4, 1, 64, True),      # GQA and ragged: no block divides 77
    (1, 50, 2, 1, 128, False),    # D = 128, ragged, full
    (1, 40, 4, 2, 128, True),     # D = 128, GQA, causal
]


def _attn_inputs(seed, B, L, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (_randn(rng, B, L, H, D), _randn(rng, B, L, Hkv, D),
            _randn(rng, B, L, Hkv, D), _randn(rng, B, L, H, D))


# The bf16 backward kernels' (query, key) tiles by head dim
# (csrc/flash_tc_bwd.cuh): the dK/dV kernel's 128 keys (64 where its grid
# would be short) with query tiles of 64 or 32 rows, the dQ kernel's 128
# query rows with key tiles of 32 or 64.
BWD_TILES = {"dkdv": {64: (64, 128), 128: (32, 128)},
             "dkdv64": {64: (64, 64), 128: (32, 64)},
             "dq": {64: (128, 32), 128: (128, 64)}}


@pytest.mark.parametrize("tiles", [None, "dkdv", "dkdv64", "dq"])
@pytest.mark.parametrize("B,L,H,Hkv,D,causal", ATTN_CASES)
def test_plain_flash_bwd_matches_jax_grad_of_dense(B, L, H, Hkv, D, causal,
                                                   tiles):
    """In its default tiles and in each bf16 kernel's (query, key) tiles
    (BWD_TILES)."""
    q, k, v, do = _attn_inputs(0, B, L, H, Hkv, D)
    _, vjp = jax.vjp(lambda a, b, c: jattn.dense_attention(
        a, b, c, causal=causal), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tattn.flash_attention_plain(tq, tk, tv, causal=causal,
                                         return_lse=True)
    block = {}
    if tiles:
        block_q, block_k = BWD_TILES[tiles][D]
        block = dict(block_q=block_q, block_k=block_k)
    got = tattn.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo,
                                          causal=causal, **block)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("B,L,H,Hkv,D,causal", ATTN_CASES[::2])
def test_plain_lse_matches_jax_logsumexp(B, L, H, Hkv, D, causal):
    q, k, v, _ = _attn_inputs(1, B, L, H, Hkv, D)
    kk = jnp.repeat(jnp.asarray(k), H // Hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kk) * D ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((L, L), bool)), s, jattn.NEG_INF)
    want = jax.nn.logsumexp(s, axis=-1)
    _, lse = tattn.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal, return_lse=True)
    _close(lse, want, VALUE_TOL)


@pytest.mark.parametrize("B,L,H,Hkv,D,causal", ATTN_CASES)
def test_flash_autograd_matches_autograd_through_dense(B, L, H, Hkv, D,
                                                       causal):
    q, k, v, do = map(torch.from_numpy, _attn_inputs(2, B, L, H, Hkv, D))

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins, causal=causal)
        return (out,) + torch.autograd.grad(out, ins, do)

    for g, w in zip(grads(tattn.flash_attention),
                    grads(tattn.dense_attention)):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   **GRAD_TOL)


# ------------------------------------------------------------ layers

def _layer_ops(mods, x, scale, w, q8, cos, sin, labels):
    """One scalar through rms_norm, apply_rope, mm (plain and Q8) and
    cross_entropy_loss, written once for both packages."""
    layers, quant = mods
    h = layers.rms_norm(x, scale)                              # [2, 6, 32]
    r = layers.apply_rope(h.reshape(2, 6, 2, 16), cos, sin).reshape(2, 6, 32)
    logits = quant.mm(r, w) + quant.mm(h, q8)                  # [2, 6, 40]
    loss, _ = layers.cross_entropy_loss(logits, labels, z_loss=1e-3)
    return loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_ops_carry_gradients(dtype):
    """rms_norm, apply_rope, mm and cross_entropy_loss differentiate like
    JAX's in fp32; in bf16 the port's gradients are within bf16 rounding
    (2**-8 a step, a few steps through four ops: rtol 3e-2, with an
    absolute term at 1e-2 of each gradient's largest element) of its own
    fp32 ones."""
    from ray_tpu.ops import layers as jlayers, quant as jquant
    from ray_tpu_torch.ops import layers as tlayers, quant as tquant

    rng = np.random.default_rng(11)
    x, scale = _randn(rng, 2, 6, 32), _randn(rng, 32) * 0.1
    w, wq = _randn(rng, 32, 40) * 0.2, _randn(rng, 32, 40) * 0.2
    labels = rng.integers(0, 40, size=(2, 6))
    labels[1, 0] = -100
    jq = jquant.quantize_array(jnp.asarray(wq))
    jc, js = jlayers.rope_frequencies(16, 6, 10000.0)
    jg = jax.grad(lambda a, b, c, s: _layer_ops(
        (jlayers, jquant), a, b, c, jquant.Q8(jq.w, s), jc, js,
        jnp.asarray(labels)), argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w), jq.s)

    def port_grads(dt):
        ins = [torch.from_numpy(a).to(dt).requires_grad_()
               for a in (x, scale, w, np.array(jq.s))]
        tc, ts = tlayers.rope_frequencies(16, 6, 10000.0)
        q8 = tquant.Q8(torch.from_numpy(np.array(jq.w)), ins[3])
        _layer_ops((tlayers, tquant), ins[0], ins[1], ins[2], q8, tc, ts,
                   torch.from_numpy(labels)).backward()
        assert all(t.grad.dtype == dt for t in ins)
        return [t.grad.float() for t in ins]

    want = port_grads(torch.float32)
    for g, j in zip(want, jg):
        _close(g, j, GRAD_TOL)
    if dtype == "bfloat16":
        for g, f in zip(port_grads(torch.bfloat16), want):
            np.testing.assert_allclose(
                g.numpy(), f.numpy(), rtol=3e-2,
                atol=1e-2 * float(f.abs().max()))


# ------------------------------------------------------- chunked xent

@pytest.mark.parametrize("V,chunk", [(96, 32), (100, 32), (64, 64)])
def test_chunked_xent_value_and_grads_match_jax(V, chunk):
    rng = np.random.RandomState(0)
    N, D = 24, 16
    hidden = rng.randn(N, D).astype(np.float32)
    head = (rng.randn(D, V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, N)
    labels[3] = labels[17] = -100   # ignored rows
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: jxent.chunked_cross_entropy(h, w, jnp.asarray(labels),
                                                 chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (hidden, head))
    tl = txent.chunked_cross_entropy(th, tw, torch.from_numpy(labels), chunk)
    tl.backward()
    _close(tl, jl, VALUE_TOL)
    _close(th.grad, jgh, GRAD_TOL)
    _close(tw.grad, jgw, GRAD_TOL)


# ------------------------------------------------------------- model

def _tokens(seed, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, 96, size=shape)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("chunked_vocab", [0, 64])
def test_loss_fn_value_and_grads_match_jax(remat, chunked_vocab):
    jparams = _jparams()
    tokens = _tokens(3)
    jl, jg = jax.value_and_grad(lambda p: jllama.loss_fn(
        p, {"tokens": jnp.asarray(tokens, jnp.int32)}, JCFG, remat=remat,
        chunked_vocab=chunked_vocab))(jparams)
    tparams = _tparams(jparams)
    trainable(tparams)
    tl = tllama.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)}, TCFG,
                        remat=remat, chunked_vocab=chunked_vocab)
    tl.backward()
    _close(tl, jl, VALUE_TOL)
    _grads_close(tparams, jg)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_is_differentiable_and_matches_jax_grad(remat):
    """Repair of the serving slice: the full-sequence forward carries
    gradients, and they match jax.grad through the JAX forward."""
    jparams = _jparams(1)
    tokens = _tokens(4)
    weight = _randn(np.random.default_rng(5), 2, 24, 96)

    def jscalar(p):
        logits = jllama.forward(p, jnp.asarray(tokens, jnp.int32), JCFG,
                                remat=remat)
        return jnp.sum(logits * weight)

    jg = jax.grad(jscalar)(jparams)
    tparams = _tparams(jparams)
    trainable(tparams)
    logits = tllama.forward(tparams, torch.from_numpy(tokens), TCFG,
                            remat=remat)
    assert logits.requires_grad
    (logits * torch.from_numpy(weight)).sum().backward()
    _grads_close(tparams, jg)


def test_adamw_steps_match_optax():
    """Three steps of torch AdamW against optax.adamw(3e-4,
    weight_decay=0.1) from the same weights, the same tokens each step.
    Adam divides each gradient by its own root mean square, so a gradient
    difference at the 1e-6 level can move a parameter by a share of the
    learning rate: parameters are held at atol 1e-6 + lr/50."""
    jparams = _jparams(2)
    tokens = _tokens(6)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    opt = optax.adamw(3e-4, weight_decay=0.1)
    state = opt.init(jparams)
    jlosses = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, batch, JCFG))(jparams)
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))

    tparams = _tparams(_jparams(2))
    topt = torch.optim.AdamW(trainable(tparams), lr=3e-4,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
    tlosses = []
    for _ in range(3):
        topt.zero_grad()
        loss = tllama.loss_fn(tparams, {"tokens": torch.from_numpy(tokens)},
                              TCFG)
        loss.backward()
        topt.step()
        tlosses.append(loss.item())

    np.testing.assert_allclose(tlosses, jlosses, **VALUE_TOL)
    assert tlosses[2] < tlosses[0]
    got = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    want = jax.tree_util.tree_leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=1e-6 + 3e-4 / 50)


def test_next_token_targets_and_flops_match_jax():
    tokens = _tokens(7, (3, 9))
    np.testing.assert_array_equal(
        tllama.next_token_targets(torch.from_numpy(tokens)).numpy(),
        np.asarray(jllama.next_token_targets(jnp.asarray(tokens))))
    for jc, tc in ((JCFG, TCFG), (jllama.LLAMA3_1B, tllama.LLAMA3_1B)):
        assert tllama.flops_per_token(tc, 2048) == \
            jllama.flops_per_token(jc, 2048)


def test_trainable_and_params_to_numpy_round_trip():
    jparams = jllama.init_params(
        dataclasses.replace(JCFG, dtype=jnp.bfloat16), jax.random.PRNGKey(8))
    tparams = _tparams(jparams)
    leaves = trainable(tparams)
    assert len(leaves) == len(jax.tree_util.tree_leaves(jparams))
    assert all(t.requires_grad and t.dtype == torch.bfloat16 for t in leaves)
    back = params_to_numpy(tparams)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


def test_cpu_tensors_never_launch_either_kernel(monkeypatch):
    monkeypatch.setattr(tattn, "launches", 0)
    monkeypatch.setattr(tattn, "bwd_launches", 0)
    monkeypatch.setattr(tattn, "_load",
                        lambda name: pytest.fail(f"kernel load {name}"))
    tparams = _tparams(_jparams())
    trainable(tparams)
    for chunked_vocab in (0, 64):
        tllama.loss_fn(tparams, {"tokens": torch.from_numpy(_tokens(9))},
                       TCFG, chunked_vocab=chunked_vocab).backward()
    assert tattn.launches == 0 and tattn.bwd_launches == 0
    assert all(t.grad is not None for t in trainable(tparams))
