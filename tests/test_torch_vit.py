"""Parity of the PyTorch port's ViT (``models/vit.py``) with the JAX
package's, on the CPU in fp32: ``patchify``, ``encode`` and ``forward``,
``loss_fn`` and its gradients, the tanh GELU, the counts and the tree.

The config is ViT-B/16's shape cut small (image 32, patch 8, so 16
patches and a CLS row: 17 tokens, which no attention tile divides; 2
layers; 2 heads of 64, as many kv heads as query heads), weights from the
JAX ``init_params`` through ``params_from_numpy``, images from numpy with
a seed. Both sides compute in fp32 and differ only in the order of their
sums (blockwise flash attention against JAX's dense oracle), so values
are held at rtol 1e-5 and atol 1e-5 and gradients at rtol 1e-4 and atol
2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import vit as jvit
from ray_tpu.ops import attention as jattn
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import params_from_numpy, trainable
from ray_tpu_torch.ops import attention as tattn

CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
SMALL = dict(image_size=32, patch_size=8, num_classes=10, d_model=128,
             n_layers=2, n_heads=2, d_ff=256)
JCFG = jvit.ViTConfig(**SMALL, dtype=jnp.float32)
TCFG = tvit.ViTConfig(**SMALL, dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jparams = jvit.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _batch(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return dict(images=rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
                labels=rng.integers(0, 10, n).astype(np.int32))


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


def test_defaults_counts_and_tree_match_jax():
    """ViT-B/16's defaults (86.5 M parameters), flops_per_image, and the
    tree init_params builds (shapes, the fp32 head)."""
    fields = [f.name for f in dataclasses.fields(jvit.ViTConfig)]
    assert fields == [f.name for f in dataclasses.fields(tvit.ViTConfig)]
    for f in fields[:-1]:
        assert getattr(tvit.ViTConfig(), f) == getattr(jvit.ViTConfig(), f)
    assert tvit.ViTConfig().dtype == torch.bfloat16 and \
        jvit.ViTConfig().dtype == jnp.bfloat16
    assert tvit.ViTConfig().param_count() == jvit.ViTConfig().param_count() \
        == 86465512
    for t, j in ((tvit.ViTConfig(), jvit.ViTConfig()), (TCFG, JCFG)):
        assert tvit.flops_per_image(t) == jvit.flops_per_image(j)
    jtree = jax.eval_shape(lambda: jvit.init_params(JCFG,
                                                    jax.random.PRNGKey(0)))
    ttree = tvit.init_params(tvit.ViTConfig(**SMALL),
                             torch.Generator().manual_seed(0), device=CPU)
    got = {k: tuple(v.shape) for k, v in _flat(ttree).items()}
    assert got == {k: tuple(v.shape) for k, v in _flat(jtree).items()}
    assert ttree["head"]["w"].dtype == torch.float32
    assert ttree["layers"][0]["wq"].dtype == torch.bfloat16
    assert sum(int(np.prod(s)) for s in got.values()) == TCFG.param_count()


def test_patchify_matches_jax_exactly():
    images = _batch()["images"]
    want = jvit.patchify(jnp.asarray(images), JCFG)
    got = tvit.patchify(torch.from_numpy(images), TCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gelu_is_jax_default_tanh_approximation():
    """jax.nn.gelu's default is the tanh form; torch's default is erf, which
    differs by more than the tolerance, so an erf port would fail here."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), want,
        **VALUE_TOL)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_forward_and_encode_match_jax(model, attn):
    """Logits and pooled features through flash_attention (the default) and
    through dense_attention on both sides; both fp32."""
    jparams, tree = model
    images = _batch()["images"]
    jimpl = None if attn == "flash" else jattn.dense_attention
    timpl = None if attn == "flash" else tattn.dense_attention
    tparams = params_from_numpy(tree, device=CPU)
    with torch.no_grad():
        logits = tvit.forward(tparams, torch.from_numpy(images), TCFG, timpl)
        pooled = tvit.encode(tparams, torch.from_numpy(images), TCFG, timpl)
    assert logits.dtype == pooled.dtype == torch.float32
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(jvit.forward(jparams, jnp.asarray(images), JCFG, jimpl)),
        **VALUE_TOL)
    np.testing.assert_allclose(
        pooled.numpy(),
        np.asarray(jvit.encode(jparams, jnp.asarray(images), JCFG, jimpl)),
        **VALUE_TOL)


def test_loss_and_gradients_match_jax(model):
    jparams, tree = model
    batch = _batch(4, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jvit.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG)))(jparams)
    tparams = params_from_numpy(tree, device=CPU)
    trainable(tparams)
    got = tvit.loss_fn(tparams, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, TCFG)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **VALUE_TOL)
    want = _flat(grads)
    tgrads = {k: t.grad for k, t in _flat(tparams).items()}
    assert tgrads.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=k)


def test_one_device_sharded_vit_loss_is_jax_loss_fn(model):
    """On a one-device mesh (no process group) ``sharded_vit_loss_fn`` is
    the whole loss, JAX's; a mesh with ``sp`` or ``pp`` is refused (a ViT
    step splits rows, heads and d_ff only)."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel import training as ttrain

    jparams, tree = model
    batch = _batch(4, seed=2)
    want = jvit.loss_fn(jparams, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, JCFG)
    tparams = params_from_numpy(tree, device=CPU)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ttrain.sharded_vit_loss_fn(
        tparams, tbatch, TCFG, make_mesh(MeshSpec(fsdp=2, tp=2), device=CPU))
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)
    for sizes in (dict(sp=2), dict(pp=2)):
        with pytest.raises(NotImplementedError):
            ttrain.sharded_vit_loss_fn(tparams, tbatch, TCFG, make_mesh(
                MeshSpec(**sizes), device=CPU))
