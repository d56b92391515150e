"""Parity of the PyTorch port's sequence-parallel slice with the JAX
package, on the CPU in fp32: the stats kernel's plain version, the mesh
spec, ring attention (dense and flash block steps) and Ulysses on a
one-device mesh, the bytes their rotations and exchanges move, and, in one
spawn of a 4-process gloo group, the same attentions over a process group,
the collectives, and a small Llama's loss and synced gradients at sp=4 and
dp=2 x sp=2.

Inputs come from numpy with a seed, weights from the JAX ``init_params``
through ``params_from_numpy``; JAX runs its ``shard_map`` versions on 4
virtual CPU devices and its Pallas stats kernel in interpret mode, as
``tests/test_parallel.py`` does. Both sides compute in fp32 and differ
only in the order of their sums (blockwise against whole-block softmax,
another merge order), so values are held at rtol 1e-5 and atol 1e-5 and
gradients, which pass through more sums, at rtol 1e-4 and atol 2e-5.

The same group runs the FSDP/TP slice: the meshes fsdp=4, fsdp=2 x tp=2
and tp=2 x sp=2 (the dryrun's), each with the dense loss and with remat
plus the chunked loss, a small Llama's shards from ``shard_params``, the
loss, every gathered gradient and every gathered parameter after one AdamW
step against JAX's ``loss_fn``, ``jax.grad`` and ``optax.adamw`` under a
mesh of the same shape with ``shardings_for_tree`` applied; Ulysses under
tp=2 x sp=2; ``shard_params`` then ``gather_params`` giving the tree back
bit for bit; and ``dryrun_rank``.

And the expert-parallel slice, on the meshes ep=4, ep=2 x tp=2 and
fsdp=2 x ep=2: ``make_ep_moe_ffn``'s output, aux and gradients against
JAX's on 4 virtual CPU devices, at capacity factor 8.0 (nothing dropped)
and 0.1 (drops, which must be JAX's), and a small Mixtral's loss share,
every gathered gradient and one AdamW step against JAX's
``mixtral.loss_fn(moe_ffn=make_ep_moe_ffn(...))`` under a mesh of the same
shape with ``mixtral_shardings`` applied and ``optax.adamw``.

And the pipeline over the ``pp`` axis, on the meshes pp=4, pp=2 x tp=2
and pp=2 x fsdp=2 and on a one-device pp=4 mesh (its stages in lockstep):
a 4-layer Llama's pipelined tree cut by ``pipelined_specs``, the loss
share of ``make_pipelined_loss``, every gathered gradient and every
gathered parameter after one AdamW step against JAX's
``make_pipelined_loss`` under a mesh of the same shape with
``pipeline_shardings`` applied, the hops and gathers a step, and the
dryrun's pipeline and MoE parts.

And ViT's sharded step on fsdp=2 x tp=2: a small ViT's shards under
``VIT_RULES`` through ``sharded_vit_loss_fn`` (its patch embed and head
gathered over tp), with 10 classes (the head split over tp) and with 5
(tp dropped from the head's spec), the loss, every gathered gradient and
every gathered parameter after one AdamW step against JAX's ``loss_fn``
under a mesh of the same shape with ``VIT_RULES`` applied, and the loss
and gradients against the port's unsplit step.

JAX is imported inside the tests only: the gloo children import this
module again, and they must not load JAX.
"""

import datetime
import importlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import mixtral as tmix
from ray_tpu_torch.models.convert import params_from_numpy, trainable
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import chunked_xent as tchunked
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.parallel import (MeshSpec, collectives, make_mesh,
                                    make_ring_attention,
                                    make_ulysses_attention, shard_batch)
from ray_tpu_torch.parallel import dryrun as tdryrun
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import moe as tmoe
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.parallel import training as ttrain
from ray_tpu_torch.parallel import ulysses as tuly

# The package exports a function named ring_attention, which shadows the
# module on attribute access.
tring = importlib.import_module("ray_tpu_torch.parallel.ring_attention")

CPU = "cpu"
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
SP = 4
WORLD = 4

TCFG = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=64)
LLAMA_TOKENS = (2, 32)          # B, L: 8 positions a shard at sp=4
CHUNK = 40                      # the chunked loss's vocab chunk: 40+40+16
RING_SHAPE = (1, 64, 4, 16)     # B, L, H, D
ULY_SHAPE = (2, 64, 8, 16)
RING_CASES = [(2, True), (2, False), (1, True), (1, False)]  # kvh, causal
ULY_KVH = (4, 2)                # aligned with sp=4, and the fallback
# The FSDP/TP meshes and the sharded step's tokens and AdamW.
SHARDED = {"fsdp4": dict(fsdp=4), "fsdp2tp2": dict(fsdp=2, tp=2),
           "tp2sp2": dict(tp=2, sp=2)}
SHARD_TOKENS = (4, 32)          # B, L: a row a rank at fsdp=4
TRAFFIC_KEYS = ("allreduce", "allreduce_bytes", "allgather",
                "allgather_bytes", "send_recv", "send_recv_bytes",
                "host_staged")
ADAMW = dict(lr=1e-3, weight_decay=0.1)
# The expert-parallel meshes; the EP MoE's inputs (B, L, D, d_ff, E, k);
# its capacity factors: nothing dropped, and drops; a small Mixtral.
EP_MESHES = {"ep4": dict(ep=4), "ep2tp2": dict(ep=2, tp=2),
             "fsdp2ep2": dict(fsdp=2, ep=2)}
MOE_SHAPE = (4, 8, 32, 48, 4, 2)
EP_FACTORS = (8.0, 0.1)
# The experts as the EP MoE takes them: over ep, d_ff over tp.
EP_SPECS = {"w_gate": ("ep", None, "tp"), "w_up": ("ep", None, "tp"),
            "w_down": ("ep", "tp", None)}
MCFG = dict(TCFG, n_experts=4, top_k=2)
# Below this gradient an AdamW step follows the gradient's last digits.
ADAM_SMALL_GRAD = 1e-6
# The pipeline's meshes with their microbatch counts, and its model: 4
# layers (a layer a stage at pp=4), 4/2 heads; tokens [4, 32], so a
# microbatch is a row on every mesh.
PIPE = {"pp4": (dict(pp=4), 4), "pp2tp2": (dict(pp=2, tp=2), 4),
        "pp2fsdp2": (dict(pp=2, fsdp=2), 2)}
PCFG = dict(vocab_size=128, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=64)
PIPE_TOKENS = (4, 32)
PIPE_TRAFFIC = ("send_recv", "send_recv_bytes", "allgather",
                "allgather_bytes", "reducescatter", "reducescatter_bytes")
# ViT's sharded step: a small ViT (image 16, patch 4: 17 tokens; 2/2 heads
# of 32, so tp=2 leaves one a rank) with 10 classes (the head split over
# tp) and with 5 (which tp=2 does not divide: clean_spec drops tp from the
# head's spec), 8 images, on fsdp=2 x tp=2.
VIT_CFG = dict(image_size=16, patch_size=4, d_model=64, n_layers=2,
               n_heads=2, d_ff=128)
VIT_CLASSES = {"vit10": 10, "vit5": 5}
VIT_MESH = dict(fsdp=2, tp=2)
VIT_IMAGES = 8


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


def _attn_inputs(seed, shape, kvh):
    B, L, H, D = shape
    rng = np.random.default_rng(seed)
    return (_randn(rng, B, L, H, D), _randn(rng, B, L, kvh, D),
            _randn(rng, B, L, kvh, D), _randn(rng, B, L, H, D))


def _ring_inputs(kvh, causal):
    return _attn_inputs(10 + 2 * kvh + causal, RING_SHAPE, kvh)


def _uly_inputs(kvh):
    return _attn_inputs(30 + kvh, ULY_SHAPE, kvh)


def _llama_tokens(shape=LLAMA_TOKENS, seed=5):
    return np.random.default_rng(seed).integers(
        0, TCFG["vocab_size"], shape).astype(np.int32)


def _shard_tokens():
    return _llama_tokens(SHARD_TOKENS, 6)


def _pipe_inputs():
    """The pipeline's weights (JAX's ``to_pipeline_params`` tree as numpy)
    and tokens."""
    import jax
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel import to_pipeline_params

    jcfg = jllama.LlamaConfig(**PCFG, dtype=jax.numpy.float32)
    tree = to_pipeline_params(jllama.init_params(jcfg, jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(7).integers(
        0, PCFG["vocab_size"], PIPE_TOKENS).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, tree), tokens


def _flat(tree, prefix=""):
    """A tree of dicts and lists as {"a.0.b": leaf}."""
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


def _jax_vjp(fn, q, k, v, do):
    """JAX's output and (dq, dk, dv) for cotangent ``do``, jitted."""
    import jax
    import jax.numpy as jnp

    def run(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    out, grads = jax.jit(run)(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


_JAX_REFS = {}


def _jax_ring(cpu_mesh8, impl, kvh, causal):
    """JAX's shard_map ring on 4 CPU devices (cached for the module)."""
    key = ("ring", impl, kvh, causal)
    if key not in _JAX_REFS:
        from ray_tpu.parallel import MeshSpec as JMeshSpec
        from ray_tpu.parallel import make_mesh as jmake_mesh
        from ray_tpu.parallel import make_ring_attention as jring

        mesh = jmake_mesh(JMeshSpec(sp=SP), devices=cpu_mesh8[:SP])
        ring = jring(mesh, causal=causal, batch_axes=("dp",),
                     head_axis="tp", block_impl=impl)
        _JAX_REFS[key] = _jax_vjp(ring, *_ring_inputs(kvh, causal))
    return _JAX_REFS[key]


def _jax_ulysses(cpu_mesh8, kvh):
    key = ("ulysses", kvh)
    if key not in _JAX_REFS:
        from ray_tpu.parallel import MeshSpec as JMeshSpec
        from ray_tpu.parallel import make_mesh as jmake_mesh
        from ray_tpu.parallel import make_ulysses_attention as july

        mesh = jmake_mesh(JMeshSpec(sp=SP), devices=cpu_mesh8[:SP])
        uly = july(mesh, causal=True, batch_axes=("dp",))
        _JAX_REFS[key] = _jax_vjp(uly, *_uly_inputs(kvh))
    return _JAX_REFS[key]


def _torch_vjp(fn, q, k, v, do):
    q, k, v = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _assert_vjp_close(got, want, tag):
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL,
                               err_msg=f"{tag} out")
    for name, g, w in zip(("dq", "dk", "dv"), got[1], want[1]):
        assert g.shape == w.shape, (tag, name)
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=f"{tag} {name}")


# ------------------------------------------------------- the stats kernel

STATS_CASES = ["causal", "full", "ragged", "zero"]


def _visible(pattern, B, H, Lq, Lk, rng):
    if pattern == "causal":  # the diagonal block of a causal ring
        row = np.arange(1, Lq + 1)
    elif pattern == "full":
        row = np.full(Lq, Lk)
    elif pattern == "zero":
        row = np.zeros(Lq)
    else:  # per (b, h, row), past Lk too (read as Lk), some rows dark
        return rng.integers(0, Lk + 5, (B, H, Lq)).astype(np.int32)
    return np.broadcast_to(row, (B, H, Lq)).astype(np.int32)


@pytest.mark.parametrize("pattern", STATS_CASES)
def test_plain_stats_matches_jax_interpret_kernel(pattern):
    """Against the Pallas stats kernel in interpret mode, with GQA and
    Lq != Lk. A row that sees no key must carry m == NEG_INF on both
    sides; JAX leaves its o and l undefined there (exp(NEG_INF - NEG_INF)
    = 1 for every masked key), so o and l are compared on the rows that
    see a key, and the port's are 0 on the others."""
    import jax.numpy as jnp
    from ray_tpu.ops import attention as jattn

    B, Lq, Lk, H, Hkv, D = 2, 32, 48, 4, 2, 16
    rng = np.random.default_rng(STATS_CASES.index(pattern))
    q, k, v = (_randn(rng, B, Lq, H, D), _randn(rng, B, Lk, Hkv, D),
               _randn(rng, B, Lk, Hkv, D))
    vis = _visible(pattern, B, H, Lq, Lk, rng)
    jo, jm, jl = jattn.flash_attention_stats(
        *map(jnp.asarray, (q, k, v, vis)), block_q=16, block_k=16,
        interpret=True)
    to, tm, tl = tattn.flash_attention_stats(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(vis))
    assert to.dtype == tm.dtype == tl.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **VALUE_TOL)
    seen = vis > 0
    np.testing.assert_allclose(tl.numpy()[seen], np.asarray(jl)[seen],
                               **VALUE_TOL)
    o_seen = np.moveaxis(to.numpy(), 2, 1)[seen]        # [rows, D]
    np.testing.assert_allclose(o_seen, np.moveaxis(np.asarray(jo), 2, 1)
                               [seen], **VALUE_TOL)
    dark = ~seen
    assert (tm.numpy()[dark] == np.float32(tattn.NEG_INF)).all()
    assert not tl.numpy()[dark].any()
    assert not np.moveaxis(to.numpy(), 2, 1)[dark].any()


def test_stats_normalise_to_dense_attention_and_take_strides():
    """The composable contract (``test_flash_attention_stats_unit``):
    o / l is causal attention, here from a strided q and a stride-0
    visible; the plain version gives the same on contiguous copies."""
    B, L, H, D = 2, 32, 2, 16
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(_randn(rng, B, L, H, 2 * D))
    q = wide[..., :D]                                    # strided head dim
    k, v = (torch.from_numpy(_randn(rng, B, L, H, D)) for _ in range(2))
    vis = torch.arange(1, L + 1, dtype=torch.int32)[None, None] \
        .expand(B, H, L)
    assert vis.stride()[:2] == (0, 0) and q.stride(-2) == 2 * D
    o, m, l = tattn.flash_attention_stats(q, k, v, vis)
    got = o / l.transpose(1, 2)[..., None]
    want = tattn.dense_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **VALUE_TOL)
    again = tattn.flash_attention_stats(q.contiguous(), k, v,
                                        vis.contiguous())
    for a, b in zip((o, m, l), again):
        assert torch.equal(a, b)


def test_cpu_stats_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(tattn, "stats_launches", 0)
    monkeypatch.setattr(tattn, "_load",
                        lambda name: pytest.fail("kernel load"))
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    q, k, v, _ = _ring_inputs(2, True)
    make_ring_attention(mesh, block_impl="flash")(
        *map(torch.from_numpy, (q, k, v)))
    assert tattn.stats_launches == 0


# ------------------------------------------------------------------ mesh

MESH_STRINGS = ["dp=2,tp=4", "sp=4", "fsdp=-1,tp=2", "dp=2,sp=2,ep=2", "",
                "bogus=2", "dp=-1,tp=-1", "dp=3"]


@pytest.mark.parametrize("text", MESH_STRINGS)
def test_mesh_spec_matches_jax(text):
    """Parsing and resolving against 8 devices: the same sizes, or a
    ValueError on both sides."""
    from ray_tpu.parallel import mesh as jmesh

    assert tmesh.AXES == jmesh.AXES
    for n in (None, 8):
        try:
            want = jmesh.mesh_spec_from_string(text, n)
        except ValueError:
            with pytest.raises(ValueError):
                tmesh.mesh_spec_from_string(text, n)
            continue
        got = tmesh.mesh_spec_from_string(text, n)
        assert got.sizes() == want.sizes()
        assert got.n_devices == want.n_devices


def test_one_device_mesh_keeps_the_batch_whole():
    mesh = make_mesh(MeshSpec(dp=2, sp=4), device=CPU)
    assert not mesh.distributed and mesh.shape["sp"] == 4
    assert tmesh.local_batch_size(mesh, 4) == 2
    assert tmesh.data_axes(mesh) == ("dp",)
    x = torch.arange(24).reshape(2, 12)
    assert shard_batch(mesh, x) is x
    with pytest.raises(ValueError, match="process groups"):
        collectives.allreduce(x, mesh, "dp")
    with pytest.raises(ValueError, match="-1"):
        make_mesh(MeshSpec(sp=-1), device=CPU)


# ------------------------------------------- attention on a one-device mesh

@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kvh,causal", RING_CASES)
def test_one_device_ring_matches_jax_shard_map(cpu_mesh8, impl, kvh,
                                               causal):
    """The sp=4 ranks in lockstep on one device against JAX's shard_map
    ring over 4 devices with the same block step: outputs and dq/dk/dv,
    GQA down to one kv head."""
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    ring = make_ring_attention(mesh, causal=causal, block_impl=impl)
    got = _torch_vjp(ring, *_ring_inputs(kvh, causal))
    _assert_vjp_close(got, _jax_ring(cpu_mesh8, impl, kvh, causal),
                      f"{impl} kvh={kvh} causal={causal}")


@pytest.mark.parametrize("kvh", ULY_KVH)
def test_one_device_ulysses_matches_jax_shard_map(cpu_mesh8, kvh):
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    got = _torch_vjp(make_ulysses_attention(mesh, causal=True),
                     *_uly_inputs(kvh))
    _assert_vjp_close(got, _jax_ulysses(cpu_mesh8, kvh), f"kvh={kvh}")


def test_ring_rotations_move_kv_heads_only(monkeypatch):
    """The GQA bandwidth contract, counted at the seam: every K/V shard in
    the forward, and every dK/dV shard in the flash backward, moves at the
    kv-head count (repeat-before-rotate would inflate each by H/Hkv and
    still give the right numbers)."""
    calls = []
    real = tring._ppermute

    def spy(xs, mesh, axis):
        calls.extend((tuple(x.shape), x.numel() * x.element_size())
                     for x in xs)
        return real(xs, mesh, axis)

    monkeypatch.setattr(tring, "_ppermute", spy)
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    B, L, H, D = RING_SHAPE
    kvh = 2
    shard = (B, L // SP, kvh, D)
    for impl in ("dense", "flash"):
        calls.clear()
        got = _torch_vjp(make_ring_attention(mesh, block_impl=impl),
                         *_ring_inputs(kvh, True))
        assert np.isfinite(got[0]).all()
        # forward: k and v, 3 rotations each for SP ranks; the flash
        # backward adds k and v (3 each) and dk and dv (4 each).
        rotations = 2 * (SP - 1) + (2 * (SP - 1) + 2 * SP
                                    if impl == "flash" else 0)
        assert len(calls) == rotations * SP, (impl, len(calls))
        assert all(s == shard and n == np.prod(shard) * 4
                   for s, n in calls), calls


def test_ulysses_exchanges_move_kv_heads_only(monkeypatch):
    """K/V cross the exchange at their true head count when it divides by
    sp: kv bytes are q bytes x Hkv / H."""
    calls = []
    real = tuly._all_to_all

    def spy(xs, mesh, axis, *, split_axis, concat_axis):
        calls.append((split_axis, sum(x.numel() * x.element_size()
                                      for x in xs)))
        return real(xs, mesh, axis, split_axis=split_axis,
                    concat_axis=concat_axis)

    monkeypatch.setattr(tuly, "_all_to_all", spy)
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    kvh = 4
    q, k, v, _ = _uly_inputs(kvh)
    make_ulysses_attention(mesh, causal=False)(
        *map(torch.from_numpy, (q, k, v)))
    fwd = [b for s, b in calls if s == 2]   # q, k, v seq -> heads
    back = [b for s, b in calls if s == 1]  # out heads -> seq
    assert len(fwd) == 3 and len(back) == 1, calls
    H = ULY_SHAPE[2]
    assert fwd[1] == fwd[2] == fwd[0] * kvh // H
    assert back[0] == fwd[0]


def test_ring_segment_ids_raise_and_auto_picks_dense_on_cpu():
    """The ring applies no segment mask, so segment ids raise as in JAX;
    off CUDA ``auto`` is the dense block step, bit for bit."""
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    q, k, v, _ = map(torch.from_numpy, _ring_inputs(2, True))
    with pytest.raises(NotImplementedError, match="segment masking"):
        tring.ring_attention(q, k, v, mesh, causal=True,
                             segment_ids=torch.zeros(1, 64, dtype=torch.long))
    auto = tring.ring_attention(q, k, v, mesh, causal=True)
    assert torch.equal(auto, tring.ring_attention(q, k, v, mesh, causal=True,
                                                  block_impl="dense"))


def test_one_device_sharded_loss_is_loss_fn():
    """On a one-device mesh the share is the whole loss: with remat and the
    chunked loss, sharded_loss_fn's loss and gradients are loss_fn's."""
    import jax
    from ray_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig(**TCFG, dtype=jax.numpy.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(1)))
    cfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    tokens = torch.from_numpy(_llama_tokens())
    results = []
    for sharded in (True, False):
        params = params_from_numpy(tree, device=CPU)
        leaves = trainable(params)
        ring = make_ring_attention(mesh, block_impl="flash")
        if sharded:
            loss = ttrain.sharded_loss_fn(params, tokens, cfg, mesh,
                                          attn_impl=ring, remat=True,
                                          chunked_vocab=CHUNK)
        else:
            loss = tllama.loss_fn(params, {"tokens": tokens}, cfg,
                                  remat=True, chunked_vocab=CHUNK,
                                  attn_impl=ring)
        loss.backward()
        results.append((loss.item(), [t.grad for t in leaves]))
    (got, got_g), (want, want_g) = results
    assert got == want
    assert all(torch.equal(g, w) for g, w in zip(got_g, want_g))


def test_one_device_pipelined_loss_matches_jax_and_loss_fn(cpu_mesh8):
    """pp=4 on a one-device mesh, the stages in lockstep, M=4 with remat:
    the loss and every gradient against JAX's make_pipelined_loss on 4
    devices, and against loss_fn on the unstacked tree."""
    pparams, tokens = _pipe_inputs()
    want_loss, want_grads, _ = _jax_pipelined_step(cpu_mesh8, pparams,
                                                   tokens, *PIPE["pp4"])
    cfg = tllama.LlamaConfig(**PCFG, dtype=torch.float32)
    mesh = make_mesh(MeshSpec(pp=4), device=CPU)
    results = []
    for pipelined in (True, False):
        params = params_from_numpy(pparams, device=CPU)
        trainable(params)
        if pipelined:
            loss = tpipe.make_pipelined_loss(mesh, cfg, 4)(
                params, torch.from_numpy(tokens))
        else:  # the same leaves, unstacked into views
            tree = {k: v for k, v in params.items() if k != "stacked"}
            tree["layers"] = tpipe.unstack_layers(params["stacked"])
            loss = tllama.loss_fn(tree, {"tokens": torch.from_numpy(tokens)},
                                  cfg)
        loss.backward()
        results.append((loss.item(), {
            k.replace("/", "."): t.grad.numpy()
            for k, t in tsharding.tree_paths(params)}))
    (got, got_g), (plain, plain_g) = results
    np.testing.assert_allclose(got, want_loss, **VALUE_TOL)
    np.testing.assert_allclose(got, plain, **VALUE_TOL)
    assert got_g.keys() == want_grads.keys() == plain_g.keys()
    for key, w in want_grads.items():
        np.testing.assert_allclose(got_g[key], w, **GRAD_TOL, err_msg=key)
        np.testing.assert_allclose(got_g[key], plain_g[key], **GRAD_TOL,
                                   err_msg=key)


def test_llama_attn_impl_and_seq_offset_match_jax():
    """``attn_impl`` replaces the attention as JAX's does (the ring gives
    the flash path's logits), and a shard run at ``seq_offset`` gives the
    rows the whole sequence gives when its attention sees only itself."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig(**TCFG, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device=CPU)
    tokens = _llama_tokens()
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
    with torch.no_grad():
        got = tllama.forward(tparams, torch.from_numpy(tokens), tcfg,
                             attn_impl=make_ring_attention(mesh))
        np.testing.assert_allclose(got.numpy(), want, **VALUE_TOL)
        # The last 8 positions alone, attending only among themselves,
        # at their global positions: JAX's forward of the same tokens
        # with an attention that sees only the last 8 keys.
        tail = tllama.forward(tparams, torch.from_numpy(tokens[:, -8:]),
                              tcfg, seq_offset=24)

    def tail_attention(q, k, v, causal=True):
        L, rep = q.shape[1], q.shape[2] // k.shape[2]
        cols = jnp.arange(L)[None, :]
        mask = (jnp.arange(L)[:, None] >= cols) & (cols >= L - 8)
        k, v = (jnp.repeat(t, rep, axis=2) for t in (k, v))
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
        s = jnp.where(mask, s, -1e30)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)

    want_tail = np.asarray(jllama.forward(jparams, jnp.asarray(tokens),
                                          jcfg, attn_impl=tail_attention))
    np.testing.assert_allclose(tail.numpy(), want_tail[:, -8:], **VALUE_TOL)


# ------------------------------------------------- a 4-process gloo group

def _child(rank, store, out_dir, inputs):
    """One rank of the gloo group: every per-rank case, results to
    ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    # a rank that waits on a hop no other rank makes fails the group
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = {}
        mesh = make_mesh(MeshSpec(sp=SP), device=CPU)
        assert mesh.coords["sp"] == rank and mesh.distributed
        for (kvh, causal), arrays in inputs["ring"].items():
            for impl in ("dense", "flash"):
                fn = make_ring_attention(mesh, causal=causal,
                                         block_impl=impl)
                _shard_vjp(res, f"ring_{impl}_{kvh}_{causal}", fn, mesh,
                           arrays)
        for kvh, arrays in inputs["ulysses"].items():
            _shard_vjp(res, f"ulysses_{kvh}", make_ulysses_attention(mesh),
                       mesh, arrays)
        _collectives(res, mesh, rank)
        mesh22 = make_mesh(MeshSpec(dp=2, sp=2), device=CPU)
        res["coords22"] = np.array([mesh22.coords["dp"],
                                    mesh22.coords["sp"]])
        total = collectives.allreduce(torch.tensor([rank + 1.0]), mesh22,
                                      ("dp", "sp"))
        res["allreduce22"] = total.numpy()
        for name, m in (("sp4", mesh), ("dp2sp2", mesh22)):
            _llama(res, name, m, inputs)
            _llama(res, f"{name}_remat_chunked", m, inputs, remat=True,
                   chunked_vocab=CHUNK)
        for name, sizes in SHARDED.items():
            m = make_mesh(MeshSpec(**sizes), device=CPU)
            _roundtrip(res, name, m, inputs["params"])
            ring = make_ring_attention(m, block_impl="flash")
            _sharded_step(res, name, m, inputs, ring)
            _sharded_step(res, f"{name}_remat_chunked", m, inputs, ring,
                          remat=True, chunked_vocab=CHUNK)
        _sharded_step(res, "tp2sp2_ulysses", m, inputs,
                      make_ulysses_attention(m))
        _vocab_losses(res, m, inputs["vocab"])
        for name, sizes in EP_MESHES.items():
            ep_mesh = make_mesh(MeshSpec(**sizes), device=CPU)
            for cf in EP_FACTORS:
                _ep_ffn(res, f"{name}_cf{cf}", ep_mesh, inputs["moe"], cf)
            _sharded_step(res, f"{name}_mixtral", ep_mesh, inputs, None,
                          model="mixtral", remat=True,
                          forward=tmix.sharded_forward)
        for name, (sizes, n_micro) in PIPE.items():
            pmesh = make_mesh(MeshSpec(**sizes), device=CPU)
            _roundtrip(res, name, pmesh, inputs["pparams"],
                       tpipe.pipelined_specs)
            _sharded_step(res, f"{name}_pipeline", pmesh, inputs, None,
                          model="pipeline", microbatches=n_micro)
        vmesh = make_mesh(MeshSpec(**VIT_MESH), device=CPU)
        for name in VIT_CLASSES:
            _vit_step(res, name, vmesh, inputs["vit"][name])
        for part, loss in tdryrun.dryrun_rank(WORLD, device=CPU).items():
            res[f"dryrun_{part}_loss"] = np.array(loss)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _shard_vjp(res, tag, fn, mesh, arrays):
    q, k, v, do = (shard_batch(mesh, torch.from_numpy(a)) for a in arrays)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    res[f"{tag}_out"] = out.detach().numpy()
    for name, g in zip(("dq", "dk", "dv"), grads):
        res[f"{tag}_{name}"] = g.numpy()


def _collectives(res, mesh, rank):
    x = torch.arange(4.0) * (rank + 1)
    for op in ("sum", "mean", "max", "min"):
        res[f"allreduce_{op}"] = collectives.allreduce(x, mesh, "sp",
                                                       op).numpy()
    res["allgather"] = collectives.allgather(x, mesh, "sp").numpy()
    res["allgather_stacked"] = collectives.allgather(
        x, mesh, "sp", tiled=False, gather_axis=1).numpy()
    res["reducescatter"] = collectives.reducescatter(
        torch.arange(8.0) * (rank + 1), mesh, "sp").numpy()
    res["broadcast"] = collectives.broadcast(x, mesh, "sp", root=2).numpy()
    z = torch.arange(12.0).reshape(4, 3) + 100 * rank
    res["alltoall"] = collectives.alltoall(z, mesh, "sp", split_axis=0,
                                           concat_axis=1).numpy()
    res["permute"] = collectives.permute(x, mesh, "sp", 1).numpy()
    res["send_recv"] = collectives.send_recv(x, mesh, "sp",
                                             [(0, 2), (1, 3)]).numpy()
    res["index_size"] = np.array([collectives.axis_index(mesh, "sp"),
                                  collectives.axis_size(mesh, "sp")])
    assert torch.equal(x, torch.arange(4.0) * (rank + 1))  # left as it was
    counted = make_mesh(MeshSpec(sp=SP), device=CPU, backend="gloo")
    assert counted.backend == "gloo" and not counted.host_staged
    collectives.allreduce(x, counted, "sp")
    collectives.allgather(x[:2], counted, "sp")
    collectives.permute(x[:3], counted, "sp")
    res["traffic"] = np.array([counted.traffic[k] for k in TRAFFIC_KEYS])


def _llama(res, name, mesh, inputs, **loss_kw):
    cfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
    params = params_from_numpy(inputs["params"], device=CPU)
    leaves = trainable(params)
    share = ttrain.sharded_loss_fn(
        params, torch.from_numpy(inputs["tokens"]), cfg, mesh,
        attn_impl=make_ring_attention(mesh, block_impl="flash"), **loss_kw)
    share.backward()
    ttrain.allreduce_grads(leaves, mesh)
    res[f"{name}_loss"] = collectives.allreduce(
        share.detach(), mesh, ttrain.SPLIT_AXES).numpy()
    for key, leaf in _flat(params).items():
        res[f"{name}_grad.{key}"] = leaf.grad.numpy()


def _roundtrip(res, name, mesh, tree,
               specs_for=tsharding.shardings_for_tree):
    """shard_params then gather_params under ``specs_for(params, mesh)``:
    every leaf back bit for bit, each shard its contiguous block."""
    params = params_from_numpy(tree, device=CPU)
    specs = specs_for(params, mesh)
    shards = tsharding.shard_params(params, mesh, specs)
    back = tsharding.gather_params(shards, mesh, specs)
    for key, leaf in tsharding.tree_paths(back):
        res[f"{name}_roundtrip.{key}"] = leaf.numpy()
    res[f"{name}_shard_elems"] = np.array(
        sum(t.numel() for _, t in tsharding.tree_paths(shards)))


def _sharded_step(res, name, mesh, inputs, attn, model="llama",
                  microbatches=None, **loss_kw):
    """A small Llama's (or, with ``model="mixtral"``, a small Mixtral's)
    shards through sharded_loss_fn, or with ``model="pipeline"`` the
    pipelined Llama's through make_pipelined_loss in ``microbatches``, the
    gradients completed by allreduce_grads, one AdamW step on the shards;
    the global loss, gradients and updated parameters gathered, whether
    each AdamW moment has its shard's shape and its parameter's spec, and
    for the pipeline the mesh's traffic of the loss and its backward."""
    tokens = torch.from_numpy(inputs["shard_tokens"])
    if model == "mixtral":
        cfg = tmix.MixtralConfig(**MCFG, dtype=torch.float32)
        params = params_from_numpy(inputs["mparams"], device=CPU)
        specs = tmix.mixtral_shardings(params, mesh)
    elif model == "pipeline":
        cfg = tllama.LlamaConfig(**PCFG, dtype=torch.float32)
        params = params_from_numpy(inputs["pparams"], device=CPU)
        specs = tpipe.pipelined_specs(params, mesh)
        tokens = torch.from_numpy(inputs["pipe_tokens"])
    else:
        cfg = tllama.LlamaConfig(**TCFG, dtype=torch.float32)
        params = params_from_numpy(inputs["params"], device=CPU)
        specs = tsharding.shardings_for_tree(params, mesh)
    shards = tsharding.shard_params(params, mesh, specs)
    leaves = trainable(shards)
    opt = torch.optim.AdamW(leaves, betas=(0.9, 0.999), eps=1e-8, **ADAMW)
    mesh.traffic.clear()
    if model == "pipeline":
        share = tpipe.make_pipelined_loss(mesh, cfg, microbatches)(
            shards, tokens, specs)
    else:
        share = ttrain.sharded_loss_fn(shards, tokens, cfg, mesh,
                                       attn_impl=attn, specs=specs, **loss_kw)
    share.backward()
    if model == "pipeline":
        res[f"{name}_traffic"] = np.array(
            [mesh.traffic[k] for k in PIPE_TRAFFIC])
    ttrain.allreduce_grads(shards, mesh, specs)
    res[f"{name}_loss"] = collectives.allreduce(
        share.detach(), mesh, ttrain.SPLIT_AXES).numpy()
    res[f"{name}_grad_norm"] = ttrain.global_grad_norm(
        shards, mesh, specs).numpy()
    grads = tsharding.gather_params(
        tsharding._map(lambda _, t: t.grad, shards), mesh, specs)
    opt.step()
    after = tsharding.gather_params(shards, mesh, specs)
    for key, leaf in tsharding.tree_paths(grads):
        res[f"{name}_grad.{key}"] = leaf.numpy()
    for key, leaf in tsharding.tree_paths(after):
        res[f"{name}_param.{key}"] = leaf.detach().numpy()
    moment_specs = tsharding.optimizer_shardings(opt, specs)
    leaf_specs = [sp for _, sp in tsharding.tree_paths(specs)]
    res[f"{name}_moments_ok"] = np.array(all(
        moment_specs[i]["exp_avg"] == moment_specs[i]["exp_avg_sq"]
        == leaf_specs[i] and opt.state[p]["exp_avg"].shape == p.shape
        for i, p in enumerate(leaves)))


def _vit_cfg(classes, dtype):
    from ray_tpu_torch.models import vit as tvit

    return tvit.ViTConfig(**VIT_CFG, num_classes=classes, dtype=dtype)


def _vit_step(res, name, mesh, arrays):
    """A small ViT's shards under VIT_RULES through sharded_vit_loss_fn,
    the gradients completed by allreduce_grads, one AdamW step on the
    shards; the global loss, gradients and updated parameters gathered."""
    from ray_tpu_torch.models import vit as tvit

    cfg = _vit_cfg(arrays["classes"], torch.float32)
    params = params_from_numpy(arrays["params"], device=CPU)
    batch = {"images": torch.from_numpy(arrays["images"]),
             "labels": torch.from_numpy(arrays["labels"])}
    specs = tsharding.shardings_for_tree(params, mesh, tsharding.VIT_RULES)
    shards = tsharding.shard_params(params, mesh, specs)
    leaves = trainable(shards)
    opt = torch.optim.AdamW(leaves, betas=(0.9, 0.999), eps=1e-8, **ADAMW)
    share = ttrain.sharded_vit_loss_fn(shards, batch, cfg, mesh,
                                       specs=specs)
    share.backward()
    ttrain.allreduce_grads(shards, mesh, specs)
    res[f"{name}_loss"] = collectives.allreduce(
        share.detach(), mesh, ttrain.SPLIT_AXES).numpy()
    res[f"{name}_grad_norm"] = ttrain.global_grad_norm(
        shards, mesh, specs).numpy()
    res[f"{name}_head_spec"] = np.array(str(specs["head"]["w"]))
    grads = tsharding.gather_params(
        tsharding._map(lambda _, t: t.grad, shards), mesh, specs)
    opt.step()
    after = tsharding.gather_params(shards, mesh, specs)
    for key, leaf in tsharding.tree_paths(grads):
        res[f"{name}_grad.{key}"] = leaf.numpy()
    for key, leaf in tsharding.tree_paths(after):
        res[f"{name}_param.{key}"] = leaf.detach().numpy()
    assert tvit.WHOLE_LEAVES == ("patch_embed/w", "head/w")


def _vit_inputs():
    """Each ViT case's weights from JAX's init_params and a batch of
    images and labels from a numpy seed."""
    import jax
    from ray_tpu.models import vit as jvit

    out = {}
    for i, (name, classes) in enumerate(VIT_CLASSES.items()):
        jcfg = jvit.ViTConfig(**VIT_CFG, num_classes=classes,
                              dtype=jax.numpy.float32)
        rng = np.random.default_rng(30 + i)
        out[name] = {
            "classes": classes,
            "params": jax.tree_util.tree_map(
                np.asarray, jvit.init_params(jcfg, jax.random.PRNGKey(3))),
            "images": _randn(rng, VIT_IMAGES, 16, 16, 3),
            "labels": rng.integers(0, classes, VIT_IMAGES).astype(np.int64)}
    return out


def _moe_inputs():
    """The EP MoE's x, output cotangent, router and experts."""
    B, L, D, F, E, _ = MOE_SHAPE
    rng = np.random.default_rng(9)
    return dict(x=_randn(rng, B, L, D), cot=_randn(rng, B, L, D),
                router=_randn(rng, D, E) * 0.5,
                w_gate=_randn(rng, E, D, F) * D ** -0.5,
                w_up=_randn(rng, E, D, F) * D ** -0.5,
                w_down=_randn(rng, E, F, D) * F ** -0.5)


def _ep_ffn(res, tag, mesh, arrays, cf):
    """make_ep_moe_ffn on this rank's rows and experts: sum(out * cot) +
    aux backward; the rows and x's gradient gathered over the batch axes,
    the aux shares summed over them, the router's and experts' gradients
    completed by allreduce_grads and gathered."""
    rows = (tmesh.BATCH_AXES,)
    x = shard_batch(mesh, torch.from_numpy(arrays["x"])).clone() \
        .requires_grad_()
    cot = shard_batch(mesh, torch.from_numpy(arrays["cot"]))
    specs = {"router": (), "experts": EP_SPECS}
    tree = {"router": torch.from_numpy(arrays["router"]),
            "experts": {k: torch.from_numpy(arrays[k]) for k in EP_SPECS}}
    tree = tsharding.shard_params(tree, mesh, specs)
    trainable(tree)
    fn = tmoe.make_ep_moe_ffn(mesh, k=MOE_SHAPE[5], capacity_factor=cf)
    out, aux = fn(x, tree["router"], tree["experts"])
    ((out * cot).sum() + aux).backward()
    ttrain.allreduce_grads(tree, mesh, specs)
    res[f"{tag}_out"] = tsharding._gather(out.detach(), rows, mesh).numpy()
    res[f"{tag}_dx"] = tsharding._gather(x.grad, rows, mesh).numpy()
    res[f"{tag}_aux"] = collectives.allreduce(
        aux.detach(), mesh, ttrain.SPLIT_AXES).numpy()
    grads = tsharding.gather_params(
        tsharding._map(lambda _, t: t.grad, tree), mesh, specs)
    for key, leaf in tsharding.tree_paths(grads):
        res[f"{tag}_grad.{key}"] = leaf.numpy()


def _vocab_inputs():
    """Logits, hidden states, a head and labels (some ignored, one at each
    end of the vocab) for the vocab-split losses."""
    rng = np.random.default_rng(8)
    V, N, D = TCFG["vocab_size"], 12, 16
    labels = rng.integers(0, V, N)
    labels[:2], labels[2], labels[3] = -100, 0, V - 1
    return dict(logits=_randn(rng, N, V) * 3, hidden=_randn(rng, N, D),
                head=_randn(rng, D, V) * 0.5, labels=labels)


def _vocab_losses(res, mesh, arrays):
    """Both losses on this rank's half of the vocab over tp = 2: the dense
    one with z-loss (loss, count, and the gradient of this rank's logits)
    and the chunked one (loss, d_hidden summed over tp as the model's f
    sums it, and this rank's columns of d_head)."""
    V = TCFG["vocab_size"] // 2
    vocab = tsharding.VocabShard(mesh, "tp", mesh.coords["tp"] * V,
                                 TCFG["vocab_size"])
    cols = slice(vocab.start, vocab.start + V)
    labels = torch.from_numpy(arrays["labels"])
    logits = torch.from_numpy(arrays["logits"][:, cols]).requires_grad_()
    loss, n = tlayers.cross_entropy_loss(logits, labels, z_loss=1e-3,
                                         vocab=vocab)
    loss.backward()
    res["vocab_dense"] = np.array([loss.item(), n.item()])
    res["vocab_dense_dlogits"] = logits.grad.numpy()
    hidden = torch.from_numpy(arrays["hidden"]).requires_grad_()
    head = torch.from_numpy(arrays["head"][:, cols].copy()).requires_grad_()
    loss = tchunked.chunked_cross_entropy(
        collectives.allreduce_bwd(hidden, mesh, "tp"), head, labels, CHUNK,
        vocab=vocab)
    loss.backward()
    res["vocab_chunked"] = np.array(loss.item())
    res["vocab_chunked_dhidden"] = hidden.grad.numpy()
    res["vocab_chunked_dhead"] = head.grad.numpy()


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Spawn the group once; each rank's results as a dict."""
    import jax
    from ray_tpu.models import llama as jllama
    from ray_tpu.models import mixtral as jmix

    jcfg = jllama.LlamaConfig(**TCFG, dtype=jax.numpy.float32)
    mcfg = jmix.MixtralConfig(**MCFG, dtype=jax.numpy.float32)
    inputs = {
        "ring": {case: _ring_inputs(*case) for case in RING_CASES[:2]},
        "ulysses": {kvh: _uly_inputs(kvh) for kvh in ULY_KVH},
        "params": jax.tree_util.tree_map(
            np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(1))),
        "tokens": _llama_tokens(),
        "shard_tokens": _shard_tokens(),
        "vocab": _vocab_inputs(),
        "moe": _moe_inputs(),
        "mparams": jax.tree_util.tree_map(
            np.asarray, jmix.init_params(mcfg, jax.random.PRNGKey(2))),
    }
    inputs["pparams"], inputs["pipe_tokens"] = _pipe_inputs()
    inputs["vit"] = _vit_inputs()
    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_child, args=(str(tmp / "store"), str(tmp), inputs),
             nprocs=WORLD, join=True)
    results = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as f:
            results.append(dict(f))
    return inputs, results


def _joined(results, key):
    """The ranks' shards of an sp=4 result, joined along the sequence."""
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kvh,causal", RING_CASES[:2])
def test_gloo_ring_matches_jax_shard_map(gloo_results, cpu_mesh8, impl, kvh,
                                         causal):
    _, results = gloo_results
    tag = f"ring_{impl}_{kvh}_{causal}"
    got = (_joined(results, f"{tag}_out"),
           [_joined(results, f"{tag}_{g}") for g in ("dq", "dk", "dv")])
    _assert_vjp_close(got, _jax_ring(cpu_mesh8, impl, kvh, causal), tag)


@pytest.mark.parametrize("kvh", ULY_KVH)
def test_gloo_ulysses_matches_jax_shard_map(gloo_results, cpu_mesh8, kvh):
    _, results = gloo_results
    tag = f"ulysses_{kvh}"
    got = (_joined(results, f"{tag}_out"),
           [_joined(results, f"{tag}_{g}") for g in ("dq", "dk", "dv")])
    _assert_vjp_close(got, _jax_ulysses(cpu_mesh8, kvh), tag)


def test_gloo_collectives(gloo_results):
    """Each collective against its JAX meaning, per rank."""
    _, results = gloo_results
    xs = [np.arange(4.0) * (r + 1) for r in range(WORLD)]
    zs = [np.arange(12.0).reshape(4, 3) + 100 * r for r in range(WORLD)]
    want = {
        "allreduce_sum": sum(xs), "allreduce_mean": sum(xs) / WORLD,
        "allreduce_max": xs[-1], "allreduce_min": xs[0],
        "allgather": np.concatenate(xs), "allgather_stacked":
            np.stack(xs, axis=1),
    }
    for r, res in enumerate(results):
        for key, w in want.items():
            np.testing.assert_array_equal(res[key], w, err_msg=key)
        np.testing.assert_array_equal(
            res["reducescatter"], (np.arange(8.0) * 10)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["broadcast"], xs[2])
        np.testing.assert_array_equal(
            res["alltoall"], np.concatenate([z[r:r + 1] for z in zs], 1))
        np.testing.assert_array_equal(res["permute"], xs[(r - 1) % WORLD])
        np.testing.assert_array_equal(
            res["send_recv"], xs[r - 2] if r >= 2 else np.zeros(4))
        np.testing.assert_array_equal(res["index_size"], [r, WORLD])
        # a mesh's traffic: calls and bytes of this rank's input (fp32),
        # none staged through the host on the CPU
        np.testing.assert_array_equal(res["traffic"],
                                      [1, 16, 1, 8, 1, 12, 0])
        # dp=2 x sp=2: JAX's axis order puts rank r at (r // 2, r % 2)
        np.testing.assert_array_equal(res["coords22"], [r // 2, r % 2])
        np.testing.assert_array_equal(res["allreduce22"], [10.0])


@pytest.mark.parametrize("name,spec", [
    ("sp4", dict(sp=4)), ("dp2sp2", dict(dp=2, sp=2)),
    ("sp4_remat_chunked", dict(sp=4)),
    ("dp2sp2_remat_chunked", dict(dp=2, sp=2))])
def test_gloo_llama_loss_and_synced_grads_match_jax(gloo_results, cpu_mesh8,
                                                    name, spec):
    """A small Llama over the group, the ring (flash block step) as its
    attention: every rank's global loss and every summed gradient against
    JAX's ``loss_fn`` and ``jax.grad`` with ``make_ring_attention`` on a
    mesh of the same shape; ``*_remat_chunked`` with remat and the
    chunked-vocab loss on both sides."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import make_mesh as jmake_mesh
    from ray_tpu.parallel import make_ring_attention as jring

    inputs, results = gloo_results
    jcfg = jllama.LlamaConfig(**TCFG, dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=cpu_mesh8[:WORLD])
    ring = jring(mesh, causal=True, block_impl="dense")

    def attn_impl(q, k, v, causal=True, **kw):
        return ring(q, k, v)

    jparams = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    chunked = CHUNK if name.endswith("_remat_chunked") else 0
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jllama.loss_fn(
        p, {"tokens": jnp.asarray(inputs["tokens"])}, jcfg,
        attn_impl=attn_impl, remat=True, chunked_vocab=chunked)))(jparams)
    want = {k: np.asarray(v) for k, v in _flat(grads).items()}
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{name}_loss"], float(loss),
                                   **VALUE_TOL, err_msg=f"rank {r}")
        got = {k[len(f"{name}_grad."):]: v for k, v in res.items()
               if k.startswith(f"{name}_grad.")}
        assert got.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, **GRAD_TOL,
                                       err_msg=f"rank {r} {key}")


def _jax_sharded_step(cpu_mesh8, inputs, spec, attn, chunked):
    """JAX's loss, gradients and parameters after one optax.adamw step,
    under a mesh of ``spec``'s shape with shardings_for_tree applied and
    the batch placed by batch_sharding; ``attn`` is "ring" (dense block
    step) or "ulysses"."""
    key = ("sharded", tuple(sorted(spec.items())), attn, chunked)
    if key in _JAX_REFS:
        return _JAX_REFS[key]
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import apply_shardings, batch_sharding
    from ray_tpu.parallel import make_mesh as jmake_mesh
    from ray_tpu.parallel import make_ring_attention as jring
    from ray_tpu.parallel import make_ulysses_attention as july
    from ray_tpu.parallel import shardings_for_tree

    jcfg = jllama.LlamaConfig(**TCFG, dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=cpu_mesh8[:WORLD])
    fn = (jring(mesh, causal=True, block_impl="dense") if attn == "ring"
          else july(mesh, causal=True))

    def attn_impl(q, k, v, causal=True, **kw):
        return fn(q, k, v)

    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    params = apply_shardings(params, shardings_for_tree(params, mesh))
    tokens = jax.device_put(jnp.asarray(inputs["shard_tokens"]),
                            batch_sharding(mesh))
    opt = optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"])

    @jax.jit
    def step(params, tokens):
        loss, grads = jax.value_and_grad(lambda p: jllama.loss_fn(
            p, {"tokens": tokens}, jcfg, attn_impl=attn_impl, remat=True,
            chunked_vocab=chunked))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, after = step(params, tokens)
    _JAX_REFS[key] = (float(loss),
                      {k: np.asarray(v) for k, v in _flat(grads).items()},
                      {k: np.asarray(v) for k, v in _flat(after).items()})
    return _JAX_REFS[key]


def _jax_mixtral_step(cpu_mesh8, inputs, spec):
    """JAX's loss, gradients and parameters after one optax.adamw step of
    the small Mixtral through make_ep_moe_ffn (the config's capacity
    factor) under a mesh of ``spec``'s shape, mixtral_shardings applied
    and the batch placed by batch_sharding, remat on."""
    key = ("mixtral", tuple(sorted(spec.items())))
    if key in _JAX_REFS:
        return _JAX_REFS[key]
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import mixtral as jmix
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import apply_shardings, batch_sharding
    from ray_tpu.parallel import make_ep_moe_ffn as jep
    from ray_tpu.parallel import make_mesh as jmake_mesh

    jcfg = jmix.MixtralConfig(**MCFG, dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=cpu_mesh8[:WORLD])
    moe_ffn = jep(mesh, k=jcfg.top_k, capacity_factor=jcfg.capacity_factor)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["mparams"])
    params = apply_shardings(params, jmix.mixtral_shardings(params, mesh))
    tokens = jax.device_put(jnp.asarray(inputs["shard_tokens"]),
                            batch_sharding(mesh))
    opt = optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"])

    @jax.jit
    def step(params, tokens):
        loss, grads = jax.value_and_grad(lambda p: jmix.loss_fn(
            p, {"tokens": tokens}, jcfg, remat=True, moe_ffn=moe_ffn))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, after = step(params, tokens)
    _JAX_REFS[key] = (float(loss),
                      {k: np.asarray(v) for k, v in _flat(grads).items()},
                      {k: np.asarray(v) for k, v in _flat(after).items()})
    return _JAX_REFS[key]


def _jax_pipelined_step(cpu_mesh8, pparams, tokens, spec, microbatches):
    """JAX's make_pipelined_loss (remat, flash_attention) under a mesh of
    ``spec``'s shape, its tree placed by pipeline_shardings and
    shardings_for_tree as JAX's tests place it: the loss, the gradients
    and the parameters after one optax.adamw step."""
    key = ("pipeline", tuple(sorted(spec.items())), microbatches)
    if key in _JAX_REFS:
        return _JAX_REFS[key]
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import make_mesh as jmake_mesh
    from ray_tpu.parallel import (make_pipelined_loss, pipeline_shardings,
                                  shardings_for_tree)

    jcfg = jllama.LlamaConfig(**PCFG, dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**spec), devices=cpu_mesh8[:WORLD])
    params = jax.tree_util.tree_map(jnp.asarray, pparams)
    sh = {k: shardings_for_tree(v, mesh) for k, v in params.items()
          if k != "stacked"}
    sh["stacked"] = pipeline_shardings(params["stacked"], mesh)
    params = jax.tree_util.tree_map(jax.device_put, params, sh)
    loss_fn = make_pipelined_loss(mesh, jcfg, microbatches)
    opt = optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"])

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(lambda p: loss_fn(
            p, {"tokens": jnp.asarray(tokens)}))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, after = step(params)
    _JAX_REFS[key] = (float(loss),
                      {k: np.asarray(v) for k, v in _flat(grads).items()},
                      {k: np.asarray(v) for k, v in _flat(after).items()})
    return _JAX_REFS[key]


def _rank_tree(res, prefix):
    """A rank's flat leaves saved under ``prefix`` (``/``-joined paths), in
    ``_flat``'s ``.``-joined keys."""
    return {k[len(prefix):].replace("/", "."): v for k, v in res.items()
            if k.startswith(prefix)}


SHARDED_CASES = [(name, variant) for name in SHARDED
                 for variant in ("", "_remat_chunked")] + \
    [("tp2sp2", "_ulysses")] + [(name, "_mixtral") for name in EP_MESHES] + \
    [(name, "_pipeline") for name in PIPE]


@pytest.mark.parametrize("name,variant", SHARDED_CASES)
def test_gloo_sharded_step_matches_jax(gloo_results, cpu_mesh8, name,
                                       variant):
    """FSDP/TP: a small Llama's shards on each mesh, the ring (flash block
    step) or Ulysses as its attention, dense or with remat and the chunked
    loss; EP (``_mixtral``): a small Mixtral's shards on each
    expert-parallel mesh, its MoE through make_ep_moe_ffn, remat on; and
    PP (``_pipeline``): the 4-layer Llama's pipelined shards on each pp
    mesh through make_pipelined_loss (remat, flash_attention): every
    rank's global loss, every gathered gradient and every gathered
    parameter after one AdamW step against JAX's under a mesh of the same
    shape; the global gradient norm from the shards is the norm of JAX's
    gradients; AdamW's moments carry their shard's shape and their
    parameter's spec."""
    inputs, results = gloo_results
    tag = name + variant
    start = {"_mixtral": inputs["mparams"],
             "_pipeline": inputs["pparams"]}.get(variant)
    if variant == "_mixtral":
        want_loss, want_grads, want_params = _jax_mixtral_step(
            cpu_mesh8, inputs, EP_MESHES[name])
    elif variant == "_pipeline":
        want_loss, want_grads, want_params = _jax_pipelined_step(
            cpu_mesh8, inputs["pparams"], inputs["pipe_tokens"], *PIPE[name])
    else:
        want_loss, want_grads, want_params = _jax_sharded_step(
            cpu_mesh8, inputs, SHARDED[name],
            "ulysses" if variant == "_ulysses" else "ring",
            CHUNK if variant == "_remat_chunked" else 0)
    want_norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                            for g in want_grads.values()))
    if start is not None:
        start = {k: np.asarray(v) for k, v in _flat(start).items()}
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{tag}_loss"], want_loss,
                                   **VALUE_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res[f"{tag}_grad_norm"], want_norm,
                                   **VALUE_TOL, err_msg=f"rank {r}")
        assert res[f"{tag}_moments_ok"], f"rank {r}"
        for what, want, tol in (("grad", want_grads, GRAD_TOL),
                                ("param", want_params, VALUE_TOL)):
            got = _rank_tree(res, f"{tag}_{what}.")
            assert got.keys() == want.keys()
            if what == "grad":
                grads = got
            for key, w in want.items():
                if what == "param" and start is not None:
                    _hold_adamw_step(got[key], w, want_grads[key],
                                     start[key], grads[key],
                                     f"rank {r} {key}")
                    continue
                np.testing.assert_allclose(got[key], w, **tol,
                                           err_msg=f"rank {r} {what} {key}")


def _jax_vit_step(cpu_mesh8, arrays):
    """JAX's ViT loss, gradients and parameters after one optax.adamw step
    under a mesh of VIT_MESH's shape with VIT_RULES applied and the batch
    placed by batch_sharding."""
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import apply_shardings, batch_sharding
    from ray_tpu.parallel import make_mesh as jmake_mesh
    from ray_tpu.parallel.sharding import VIT_RULES, shardings_for_tree

    jcfg = jvit.ViTConfig(**VIT_CFG, num_classes=arrays["classes"],
                          dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**VIT_MESH), devices=cpu_mesh8[:WORLD])
    params = jax.tree_util.tree_map(jnp.asarray, arrays["params"])
    params = apply_shardings(params,
                             shardings_for_tree(params, mesh, VIT_RULES))
    rows = batch_sharding(mesh)
    batch = {"images": jax.device_put(jnp.asarray(arrays["images"]), rows),
             "labels": jax.device_put(jnp.asarray(arrays["labels"]),
                                      jax.sharding.NamedSharding(
                                          mesh, jax.sharding.PartitionSpec(
                                              rows.spec[0])))}
    opt = optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"])

    @jax.jit
    def step(params, batch):
        loss, grads = jax.value_and_grad(lambda p: jvit.loss_fn(
            p, batch, jcfg))(params)
        updates, _ = opt.update(grads, opt.init(params), params)
        return loss, grads, optax.apply_updates(params, updates)

    loss, grads, after = step(params, batch)
    return (float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()},
            {k: np.asarray(v) for k, v in _flat(after).items()})


@pytest.mark.parametrize("name", VIT_CLASSES)
def test_gloo_vit_step_matches_jax_and_the_unsplit_step(gloo_results,
                                                        cpu_mesh8, name):
    """ViT's sharded step on fsdp=2 x tp=2: every rank's global loss,
    every gathered gradient and every gathered parameter after one AdamW
    step (``_hold_adamw_step``) against JAX's under a mesh of the same
    shape; the loss, the
    gradients and their norm against the port's unsplit step; the head's
    spec keeps tp where the classes split over it and drops it where
    they do not."""
    from ray_tpu_torch.models import vit as tvit

    inputs, results = gloo_results
    arrays = inputs["vit"][name]
    want_loss, want_grads, want_params = _jax_vit_step(cpu_mesh8, arrays)
    cfg = _vit_cfg(arrays["classes"], torch.float32)
    params = params_from_numpy(arrays["params"], device=CPU)
    leaves = trainable(params)
    whole = tvit.loss_fn(params, {
        "images": torch.from_numpy(arrays["images"]),
        "labels": torch.from_numpy(arrays["labels"])}, cfg)
    whole.backward()
    unsplit = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert len(unsplit) == len(leaves)
    unsplit_norm = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                               for g in unsplit.values()))
    head = "('fsdp', 'tp')" if arrays["classes"] % 2 == 0 else "('fsdp',)"
    start = {k: np.asarray(v) for k, v in _flat(arrays["params"]).items()}
    for r, res in enumerate(results):
        assert str(res[f"{name}_head_spec"]) == head
        for want in (want_loss, float(whole.detach())):
            np.testing.assert_allclose(res[f"{name}_loss"], want,
                                       **VALUE_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res[f"{name}_grad_norm"], unsplit_norm,
                                   **VALUE_TOL, err_msg=f"rank {r}")
        grads = _rank_tree(res, f"{name}_grad.")
        after = _rank_tree(res, f"{name}_param.")
        assert grads.keys() == want_grads.keys() == unsplit.keys()
        for key in want_grads:
            for want in (want_grads[key], unsplit[key]):
                np.testing.assert_allclose(grads[key], want, **GRAD_TOL,
                                           err_msg=f"rank {r} grad {key}")
            _hold_adamw_step(after[key], want_params[key], want_grads[key],
                             start[key], grads[key], f"rank {r} {key}")


def _hold_adamw_step(got, want, grad, start, port_grad, what):
    """One AdamW step's parameters, elementwise: at VALUE_TOL to JAX's where
    JAX's gradient is at least ADAM_SMALL_GRAD, and everywhere at VALUE_TOL
    to the step from the port's own gathered gradient g (already held to
    JAX's at GRAD_TOL), start * (1 - lr wd) - lr g / (|g| + eps). Adam's
    first step moves an element by lr * g / (|g| + eps): for |g| near
    eps = 1e-8 that follows g's last digits, which GRAD_TOL leaves free
    (the small Mixtral's expert gradients reach 1e-9), so below
    ADAM_SMALL_GRAD only the port's own step can be held."""
    big = np.abs(grad) >= ADAM_SMALL_GRAD
    np.testing.assert_allclose(got[big], want[big], **VALUE_TOL,
                               err_msg=what)
    g = port_grad.astype(np.float64)
    step = start * (1 - ADAMW["lr"] * ADAMW["weight_decay"]) \
        - ADAMW["lr"] * g / (np.abs(g) + 1e-8)
    np.testing.assert_allclose(got, step, **VALUE_TOL, err_msg=what)


@pytest.mark.parametrize("name", SHARDED)
def test_gloo_shard_then_gather_is_exact(gloo_results, name):
    """gather_params inverts shard_params bit for bit, and the ranks'
    shards together hold each element once per rank that shares it: the
    whole tree over fsdp x tp, and once per sp rank as well."""
    inputs, results = gloo_results
    want = {k: np.asarray(v) for k, v in _flat(inputs["params"]).items()}
    total = sum(w.size for w in want.values())
    norms = sum(w.size for k, w in want.items() if k.endswith("norm"))
    sizes = SHARDED[name]
    split = sizes.get("fsdp", 1) * sizes.get("tp", 1)
    for r, res in enumerate(results):
        got = _rank_tree(res, f"{name}_roundtrip.")
        assert got.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w,
                                          err_msg=f"rank {r} {key}")
        assert res[f"{name}_shard_elems"] == (total - norms) // split + norms


def test_gloo_dryrun_rank_matches_loss_fn(gloo_results):
    """``dryrun_rank`` in the group (tp=2 x sp=2 through the ring, remat,
    one AdamW step) gives, on every rank, the loss of ``loss_fn`` on the
    same weights and tokens on one device."""
    _, results = gloo_results
    spec = tdryrun.dryrun_spec(WORLD)
    assert (spec.tp, spec.sp, spec.fsdp) == (2, 2, 1)
    params, tokens = tdryrun.dryrun_inputs(spec, CPU)
    with torch.no_grad():
        want = tllama.loss_fn(params, {"tokens": tokens}, tdryrun.DRYRUN_CFG)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["dryrun_sharded_loss"], want.item(),
                                   **VALUE_TOL, err_msg=f"rank {r}")


def test_gloo_dryrun_pipeline_part_matches_loss_fn(gloo_results):
    """The dryrun's pipeline part (pp=2 x tp=2, two microbatches, remat,
    one AdamW step) gives, on every rank, loss_fn's loss of the same
    weights, unstacked, and tokens on one device."""
    _, results = gloo_results
    spec = tdryrun.pipeline_spec(WORLD)
    assert (spec.pp, spec.tp, spec.dp) == (2, 2, 1)
    params, tokens = tdryrun.pipeline_inputs(spec, CPU)
    params["layers"] = tpipe.unstack_layers(params.pop("stacked"))
    with torch.no_grad():
        want = tllama.loss_fn(params, {"tokens": tokens}, tdryrun.DRYRUN_CFG)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["dryrun_pipeline_loss"], want.item(),
                                   **VALUE_TOL, err_msg=f"rank {r}")


def test_gloo_dryrun_moe_part_matches_the_dense_moe(gloo_results):
    """The dryrun's MoE part (ep=2 x tp=2, make_ep_moe_ffn at capacity
    factor 4.0, which drops nothing) gives, on every rank, the dense MoE's
    loss on one device: the CE of the whole batch plus aux_coef times the
    mean over the two token shards of each shard's aux."""
    _, results = gloo_results
    spec = tdryrun.moe_spec(WORLD)
    assert (spec.ep, spec.tp, spec.dp) == (2, 2, 1)
    cfg = tdryrun.moe_cfg()
    params, tokens = tdryrun.moe_inputs(spec, CPU)
    ce, count, aux = 0.0, 0.0, 0.0
    with torch.no_grad():
        for rows in tokens.chunk(spec.ep):
            logits, a = tmix.forward(params, rows, cfg)
            mean, n = tlayers.cross_entropy_loss(
                logits, tllama.next_token_targets(rows))
            ce, count, aux = ce + mean * n, count + n, aux + a
    want = ce / count + cfg.aux_coef * aux / spec.ep
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["dryrun_moe_loss"], want.item(),
                                   **VALUE_TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", PIPE)
def test_gloo_pipeline_shard_then_gather_is_exact(gloo_results, name):
    """Under pipelined_specs gather_params inverts shard_params bit for
    bit, and each rank holds each leaf's block: the stacked layers cut
    over pp (and fsdp and tp where their rules split them), the embedding
    and head over fsdp and tp."""
    inputs, results = gloo_results
    want = {k: np.asarray(v) for k, v in _flat(inputs["pparams"]).items()}
    sizes, _ = PIPE[name]
    specs = tpipe.pipelined_specs(params_from_numpy(inputs["pparams"], CPU),
                                  make_mesh(MeshSpec(**sizes), device=CPU))
    split = {k.replace("/", "."): int(np.prod([sizes.get(a, 1) for a in
                                               tsharding.spec_axes(sp)]))
             for k, sp in tsharding.tree_paths(specs)}
    for r, res in enumerate(results):
        got = _rank_tree(res, f"{name}_roundtrip.")
        assert got.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w,
                                          err_msg=f"rank {r} {key}")
        assert res[f"{name}_shard_elems"] == sum(
            w.size // split[k] for k, w in want.items())


@pytest.mark.parametrize("name", PIPE)
def test_gloo_pipeline_hops_and_gathers_once_a_step(gloo_results, name):
    """A rank's traffic in the pipelined loss and its backward: M + S - 1
    hops of a microbatch's activations forward and M + S - 2 back (the
    last tick's hop is never used), and each FSDP-split leaf gathered once
    and reduce-scattered once, whatever the count of ticks."""
    inputs, results = gloo_results
    sizes, M = PIPE[name]
    S = sizes["pp"]
    B, L = PIPE_TOKENS
    rows = B // sizes.get("fsdp", 1) // M
    hop = rows * L * PCFG["d_model"] * 4
    specs = tpipe.pipelined_specs(params_from_numpy(inputs["pparams"], CPU),
                                  make_mesh(MeshSpec(**sizes), device=CPU))
    flat = {k.replace("/", "."): sp for k, sp in tsharding.tree_paths(specs)}
    gathered = [k for k, sp in flat.items()
                if "fsdp" in tsharding.spec_axes(sp) and sizes.get("fsdp")]
    shard_bytes = sum(
        np.asarray(v).size * 4 // int(np.prod(
            [sizes.get(a, 1) for a in tsharding.spec_axes(flat[k])]))
        for k, v in _flat(inputs["pparams"]).items() if k in gathered)
    hops = 2 * (M + S) - 3
    want = [hops, hops * hop, len(gathered), shard_bytes, len(gathered),
            shard_bytes * sizes.get("fsdp", 1)]
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[f"{name}_pipeline_traffic"], want,
                                      err_msg=f"rank {r}: {PIPE_TRAFFIC}")


def test_gloo_vocab_split_losses_match_jax(gloo_results):
    """The losses on a vocab split over tp = 2, each rank holding half the
    columns: the dense loss with z-loss and its count, and the chunked
    loss (chunks of 40 over a 48-column half), against JAX's on the whole
    vocab; each rank's gradients are its columns of JAX's, and d_hidden,
    summed over tp, JAX's whole."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.ops import chunked_xent as jchunked
    from ray_tpu.ops import layers as jlayers

    inputs, results = gloo_results
    a = {k: jnp.asarray(v) for k, v in inputs["vocab"].items()}
    (loss, n), dlogits = jax.value_and_grad(
        lambda x: jlayers.cross_entropy_loss(x, a["labels"], z_loss=1e-3),
        has_aux=True)(a["logits"])
    closs, (dh, dw) = jax.value_and_grad(
        lambda h, w: jchunked.chunked_cross_entropy(h, w, a["labels"], CHUNK),
        argnums=(0, 1))(a["hidden"], a["head"])
    V = TCFG["vocab_size"] // 2
    for r, res in enumerate(results):
        cols = slice((r % 2) * V, (r % 2 + 1) * V)  # tp is the minor axis
        np.testing.assert_allclose(res["vocab_dense"], [float(loss), float(n)],
                                   **VALUE_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["vocab_dense_dlogits"],
                                   np.asarray(dlogits)[:, cols], **GRAD_TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["vocab_chunked"], float(closs),
                                   **VALUE_TOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["vocab_chunked_dhidden"],
                                   np.asarray(dh), **GRAD_TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(res["vocab_chunked_dhead"],
                                   np.asarray(dw)[:, cols], **GRAD_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("cf", EP_FACTORS)
@pytest.mark.parametrize("name", EP_MESHES)
def test_gloo_ep_moe_ffn_matches_jax(gloo_results, cpu_mesh8, name, cf):
    """make_ep_moe_ffn over the group against JAX's on a mesh of the same
    shape: the output rows, the aux (the ranks' shares summed over the
    batch axes is JAX's mean over the token shards), and the gradients of
    sum(out * cot) + aux for x, the router and every expert. At capacity
    factor 0.1 a rank sends at most 2 of its tokens to an expert: the drops must
    be JAX's, or the rows differ by whole tokens."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel import MeshSpec as JMeshSpec
    from ray_tpu.parallel import make_ep_moe_ffn as jep
    from ray_tpu.parallel import make_mesh as jmake_mesh

    inputs, results = gloo_results
    a = {k: jnp.asarray(v) for k, v in inputs["moe"].items()}
    mesh = jmake_mesh(JMeshSpec(**EP_MESHES[name]), devices=cpu_mesh8[:WORLD])
    fn = jep(mesh, k=MOE_SHAPE[5], capacity_factor=cf)

    def loss(x, router, experts):
        out, aux = fn(x, router, experts)
        return (out * a["cot"]).sum() + aux, (out, aux)

    (_, (out, aux)), (dx, drouter, dexperts) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            a["x"], a["router"], {k: a[k] for k in EP_SPECS})
    if cf < 1:  # some tokens are dropped: their rows are zero
        assert (np.abs(np.asarray(out)).sum(-1) == 0).any()
    tag = f"{name}_cf{cf}"
    want = {"out": out, "dx": dx, "aux": aux, "grad.router": drouter,
            **{f"grad.experts/{k}": v for k, v in dexperts.items()}}
    for r, res in enumerate(results):
        for key, w in want.items():
            tol = VALUE_TOL if key in ("out", "aux") else GRAD_TOL
            np.testing.assert_allclose(res[f"{tag}_{key}"], np.asarray(w),
                                       **tol, err_msg=f"rank {r} {key}")
