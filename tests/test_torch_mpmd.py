"""Parity of the PyTorch port's MPMD pipeline
(``parallel/mpmd_pipeline.py``) with the JAX package's, on the CPU.

The stage math: the layer split, ``split_llama_params`` /
``merge_stage_params``, chained ``stage_forward`` -> ``stage_loss``
(dense and chunked vocab) with the gradients of every leaf,
``stage_param_count`` / ``stage_hbm_budget`` at Llama-3-8B's widths,
``build_stage_step`` against JAX's and ``stage_submesh``'s specs.

The actor pipeline, on one module-scoped port cluster (a
``cluster_utils.Cluster``, so the drain test can add a node and drain
it): ``MPMDPipeline`` at 2 and 3 stages, 1F1B and GPipe, fp32 and bf16
transport, on the dryrun's small model, held to JAX's single-program
chain (``loss_fn``'s math, with the hop's bf16 round trip where the
transport is bf16) and to the same ``optax.adamw`` steps run in-process:
losses within 1e-5, parameters after two steps within 1e-4, every saved
forward consumed. Also the merged checkpoint read back at 4, 2 and 1
stages, ``PipelineMemberLost`` on a killed stage in push time and the
re-form at generation + 1, a boundary fault surfacing typed with a clean
retry, a drain stopping the schedule at a microbatch boundary, and the
dryrun's MPMD part.
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


# ------------------------------------------------------ build_stage_step


def _stage_inputs(n_stages=3):
    """The small model's stage trees (numpy), a batch and the activation
    and cotangent a stage step takes, from seeds."""
    jcfg, tree, tokens = _inputs()
    rng = np.random.default_rng(9)
    act = rng.standard_normal((*TOKENS, CFG["d_model"])).astype(np.float32)
    g_out = (rng.standard_normal(act.shape) * 1e-2).astype(np.float32)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((TOKENS[0], 1), -100, np.int32)], axis=1)
    return jcfg, jmpmd.split_llama_params(tree, n_stages), tokens, act, \
        g_out, targets


@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_build_stage_step_matches_jax(stage_idx):
    """Each stage kind's plain step (forward, full backward, one AdamW
    step with weight decay 0.1) against JAX's ``build_stage_step``: the
    outputs at VALUE_TOL, the parameters after the step elementwise where
    JAX's gradient is at least ADAM_SMALL_GRAD (below it Adam's first step
    follows the gradient's last digits)."""
    import optax

    jcfg, jstages, tokens, act, g_out, targets = _stage_inputs()
    jopt, jstep, kind = jmpmd.build_stage_step(jcfg, stage_idx, 3, lr=1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, jstages[stage_idx])
    first = {"first": jnp.asarray(tokens), "mid": jnp.asarray(act),
             "last": jnp.asarray(act)}[kind]
    second = jnp.asarray(targets if kind == "last" else g_out)
    jout = jstep(jp, jopt.init(jp), first, second)
    # JAX's gradient of the stage, for the small-gradient mask
    if kind == "last":
        grads = jax.grad(lambda p: jmpmd.stage_loss(
            p, first, second, jcfg))(jp)
    else:
        grads = jax.grad(lambda p: jnp.sum(jmpmd.stage_forward(
            p, first, jcfg, first=kind == "first") * second))(jp)

    cfg = tllama.LlamaConfig(**CFG, dtype=torch.float32)
    make_opt, step_fn, tkind = tmpmd.build_stage_step(cfg, stage_idx, 3,
                                                      lr=1e-3)
    assert tkind == kind
    params = params_from_numpy(jstages[stage_idx], device=CPU)
    opt = make_opt(params)
    tfirst = torch.from_numpy(np.asarray(first))
    tsecond = torch.from_numpy(np.asarray(second))
    out = step_fn(params, opt, tfirst, tsecond)
    if kind == "first":
        np.testing.assert_allclose(out.numpy(), np.asarray(jout[2]),
                                   **VALUE_TOL)
    else:
        for g, w in zip(out, jout[2:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       **VALUE_TOL)
    want = {k: np.asarray(v) for k, v in _flat(jout[0]).items()}
    big = {k: np.abs(np.asarray(v)) >= ADAM_SMALL_GRAD
           for k, v in _flat(grads).items()}
    got = {k.replace("/", "."): t.detach().numpy()
           for k, t in tsharding.tree_paths(params)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k][big[k]], w[big[k]], **VALUE_TOL,
                                   err_msg=k)
        assert all(t.grad is None for t in opt.leaves)
    assert optax  # the reference's optimizer is optax.adamw


ADAM_SMALL_GRAD = 1e-6


def test_stage_submesh_matches_jax(cpu_mesh8):
    """A stage's fsdp-only mesh: the spec of every leaf of every stage of
    a 3-way split, as JAX's ``stage_submesh`` over 4 devices gives it."""
    from ray_tpu.parallel import sharding as jsharding

    _, jstages, *_ = _stage_inputs()
    jmesh = jsharding.stage_submesh(4, cpu_mesh8[:4])
    tmesh = tsharding.stage_submesh(4, device=CPU)
    assert tmesh.shape == {a: n for a, n in jmesh.shape.items()} | {
        a: 1 for a in tmesh.shape if a not in jmesh.shape}
    for jstage in jstages:
        jspecs = jsharding.shardings_for_tree(jstage, jmesh)
        want = {p: tuple(s.spec) for p, s in zip(
            jax.tree_util.tree_leaves(jsharding._tree_paths(jstage)),
            jax.tree_util.tree_leaves(jspecs))}
        stage = params_from_numpy(jstage, device=CPU)
        got = dict(tsharding.tree_paths(
            tsharding.shardings_for_tree(stage, tmesh)))
        assert got == want


# ------------------------------------------------------- the actor pipeline

MPMD = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=32)
LR = 1e-3
PIPE_TOL = 1e-5   # the mean microbatch loss against JAX's
PARAM_TOL = 1e-4  # every parameter after two AdamW steps


@pytest.fixture(scope="module")
def port_cluster():
    """One port cluster (a head of 8 CPUs and one GPU, a resource only:
    this host has no card) for the actor tests; removed
    with its arenas and session directory at the end. An arena is named
    by a hash of its session (and a node's suffix, ``cluster_utils``'
    isolated stores), and a node killed at shutdown leaves its own."""
    import hashlib
    import os
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtm", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    c = session = None
    try:
        c = Cluster(connect=True, head_node_args={"num_cpus": 8,
                                                  "num_gpus": 1})
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield c
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        names = [session] + [f"{session}-n{n.node_id[:8]}"
                             for n in (c.worker_nodes if c else [])]
        try:
            if c is not None:
                c.shutdown()
        finally:
            for name in names if session else []:
                tag = hashlib.sha1(name.encode()).hexdigest()[:16]
                try:
                    os.unlink(f"/dev/shm/rtpt_{tag}")
                except OSError:
                    pass
            shutil.rmtree(root, ignore_errors=True)


def _mpmd_model():
    """The dryrun's MPMD model (fp32, untied) from JAX's init, as numpy,
    and both configs."""
    jcfg = jllama.LlamaConfig(**MPMD, dtype=jnp.float32,
                              tie_embeddings=False)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.LlamaConfig(**MPMD, dtype=torch.float32,
                              tie_embeddings=False)
    return jcfg, tcfg, tree


def _batch(i, rows=8):
    return np.random.RandomState(i).randint(
        0, MPMD["vocab_size"], (rows, 16)).astype(np.int32)


@jax.custom_vjp
def _bf16_hop(x):
    return x.astype(jnp.bfloat16).astype(x.dtype)


def _bf16_hop_fwd(x):
    return _bf16_hop(x), None


def _bf16_hop_bwd(_, g):
    return (g.astype(jnp.bfloat16).astype(g.dtype),)


_bf16_hop.defvjp(_bf16_hop_fwd, _bf16_hop_bwd)


def _jax_chain_loss(p, tokens, cfg, n_stages, transport):
    """JAX's single program through the stage split: ``loss_fn``'s math,
    with the hop's bf16 round trip on each activation (and on its
    cotangent) where the transport is bf16."""
    hop = _bf16_hop if transport == "bfloat16" else (lambda x: x)
    stages = jmpmd.split_llama_params(p, n_stages)
    targets = jllama.next_token_targets(tokens)
    x = jmpmd.stage_forward(stages[0], tokens, cfg, first=True)
    for s in stages[1:-1]:
        x = jmpmd.stage_forward(s, hop(x), cfg, first=False)
    return jmpmd.stage_loss(stages[-1], hop(x), targets, cfg)


_jax_chain_value_and_grad = jax.jit(jax.value_and_grad(_jax_chain_loss),
                                    static_argnums=(2, 3, 4))


def _jax_trajectory(jcfg, tree, n_stages, transport, steps=2):
    import optax

    p = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = optax.adamw(LR)
    state = opt.init(p)
    losses, grads = [], []
    for i in range(steps):
        loss, g = _jax_chain_value_and_grad(
            p, jnp.asarray(_batch(i)), jcfg, n_stages, transport)
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
        losses.append(float(loss))
        grads.append(g)
    return losses, p, grads


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


#: bf16's relative spacing: a hop that rounds a cotangent element to the
#: neighbouring bf16 value moves a gradient element by up to about this
#: share of its leaf's largest gradient.
BF16_SPACING = 2.0 ** -7
#: optax.adamw's weight decay, which the stage actors take too.
WD = 1e-4
#: The most that AdamW's |m̂| / (√v̂ + eps) can be in its first two steps at
#: optax's betas: 1 in the first, 1.0014 in the second (Cauchy-Schwarz
#: over the weights that m̂ and v̂ give the two gradients).
ADAM_STEP = 1.0015
#: The least share of each leaf that a bf16 hop's run holds to PARAM_TOL.
HELD_SHARE = 0.9


def _hold_params(got_tree, want_tree, grads=None):
    """Every parameter within PARAM_TOL of JAX's. With ``grads`` (JAX's
    gradients of the steps, for a bf16 hop): the elements whose gradient
    stays at least BF16_SPACING of its leaf's largest in every step (or is
    exactly zero) within PARAM_TOL; at least HELD_SHARE of each leaf within
    PARAM_TOL; and every element within the distance that two AdamW runs
    of as many steps from the same start can part by at all, whatever
    their gradients. Port and JAX carry activations that differ in their
    last fp32 bits; now and then the hop rounds such a pair to
    neighbouring bf16 values, and an element whose gradient is smaller
    than that step takes an Adam update that follows the rounding.
    Returns the share of each leaf within PARAM_TOL."""
    got = {k: np.asarray(v) for k, v in _flat(got_tree).items()}
    want = {k: np.asarray(v) for k, v in _flat(want_tree).items()}
    assert got.keys() == want.keys()
    steps = len(grads or ())
    shares = {}
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        held = np.ones(w.shape, bool)
        for g in grads or ():
            g = np.abs(np.asarray(_flat(g)[k]))
            # an exact zero (an embedding row no token reads) is zero in
            # both, whatever the rounding
            held &= (g == 0) | (g >= BF16_SPACING * g.max())
        worst = float(np.max(diff[held], initial=0.0))
        assert worst < PARAM_TOL, (k, worst)
        shares[k] = float(np.mean(diff < PARAM_TOL))
        if steps:
            assert shares[k] >= HELD_SHARE, (k, shares[k])
            # each run moves an element by at most LR * (ADAM_STEP + WD *
            # |p|) a step, and |p| stays within 1 of JAX's final value
            bound = 2 * steps * LR * (ADAM_STEP + WD * (np.abs(w) + 1.0))
            assert np.all(diff <= bound), (k, float(np.max(diff - bound)))
    return shares


@pytest.mark.parametrize("device,n_stages,n_gpus,given,want", [
    ("cuda", 2, 1, None, [{"num_gpus": 0.5}] * 2),
    ("cuda", 3, 1, None, [{"num_gpus": 1 / 3}] * 3),
    ("cuda", 3, 2, None, [{"num_gpus": 0.5}] * 3),
    ("cuda", 2, 4, None, [{"num_gpus": 1.0}] * 2),
    ("cuda", 2, 1, [{"num_gpus": 1}, {"resources": {"s1": 1}}],
     [{"num_gpus": 1}, {"resources": {"s1": 1}, "num_gpus": 0.5}]),
    ("cpu", 2, 1, None, [{}, {}]),
    ("cpu", 2, 0, [{"resources": {"s1": 1}}, {}],
     [{"resources": {"s1": 1}}, {}])])
def test_stage_placement(device, n_stages, n_gpus, given, want):
    """On CUDA a stage that names no ``num_gpus`` holds a card, or an
    equal share of one where the cards are fewer than the stages; on the
    CPU the options stay as given."""
    got = tmpmd.stage_placement(torch.device(device), n_stages, n_gpus,
                                given)
    assert got == want
    assert given is None or got is not given


@pytest.mark.parametrize("device,n_gpus,given,match", [
    ("cuda", 0, None, "the cluster has no GPU"),
    ("cuda", 1, [{"num_gpus": 0}, {}], "holds no GPU"),
    ("cpu", 1, [{"num_gpus": 0.5}, {}], "holds a GPU")])
def test_stage_placement_refuses(device, n_gpus, given, match):
    """A CUDA pipeline on a cluster with no card, a stage without a GPU on
    CUDA and one with a GPU on the CPU raise: no stage runs on the CPU
    in the card's place."""
    with pytest.raises((RuntimeError, ValueError), match=match):
        tmpmd.stage_placement(torch.device(device), 2, n_gpus, given)


@pytest.mark.parametrize("n_stages,schedule,transport", [
    (2, "1f1b", None), (3, "1f1b", None), (2, "gpipe", None),
    (3, "gpipe", "bfloat16"), (2, "1f1b", "bfloat16")])
def test_pipeline_matches_jax_loss_and_adamw(port_cluster, n_stages,
                                             schedule, transport):
    """Two AdamW steps through the stage actors (4 microbatches of 2 rows)
    against JAX's single program and optax.adamw in-process: each step's
    loss within 1e-5, every parameter after both steps within 1e-4 (a
    bf16 hop's run as ``_hold_params`` says), no saved forward left, and
    1F1B holding at most ``n_stages`` of them."""
    jcfg, tcfg, tree = _mpmd_model()
    want_losses, want_params, grads = _jax_trajectory(jcfg, tree, n_stages,
                                                      transport)
    pipe = tmpmd.MPMDPipeline(tcfg, params_from_numpy(tree, device=CPU),
                              n_stages=n_stages, n_microbatches=4, lr=LR,
                              schedule=schedule, transport_dtype=transport,
                              device=CPU)
    try:
        losses, at = [], []
        for i in range(2):
            at.append(_numpy_tree(tmpmd.merge_stage_params(
                pipe.get_params())))
            losses.append(pipe.step(_batch(i)))
            assert pipe.live_vjp_counts() == [0] * n_stages
        peaks = pipe.peak_vjp_counts()
        merged = tmpmd.merge_stage_params(pipe.get_params())
        stats = pipe.last_step_stats
    finally:
        pipe.teardown()
    # each step's loss against JAX's on the parameters that step started
    # from (a bf16 hop rounds a value that differs in its last fp32 bit
    # to another bf16 value now and then, so the trajectories part by
    # more than a step's arithmetic), then the trajectory
    for i, (got, p) in enumerate(zip(losses, at)):
        want = float(_jax_chain_value_and_grad(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(_batch(i)),
            jcfg, n_stages, transport)[0])
        assert abs(got - want) < PIPE_TOL, (i, got, want)
    assert abs(losses[0] - want_losses[0]) < PIPE_TOL
    shares = _hold_params(
        {k: v.numpy() for k, v in _flat(merged).items()},
        {k: np.asarray(v) for k, v in _flat(want_params).items()},
        grads if transport else None)
    print(f"elements held to {PARAM_TOL} by leaf: least share "
          f"{min(shares.values())}, {shares}")
    if schedule == "1f1b":
        assert max(peaks) <= n_stages, peaks
    assert len(stats["stage_busy_s"]) == n_stages
    assert 0.0 <= stats["bubble_fraction"] < 1.0
    assert stats["completed_microbatches"] == 4


def test_grad_norms_match_jax(port_cluster):
    """``grad_check_step``'s loss and each stage's gradient norm (of the
    mean over microbatches) against JAX's gradient split by stage."""
    jcfg, tcfg, tree = _mpmd_model()
    tokens = _batch(0)
    loss, grads = _jax_chain_value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        jcfg, 3, None)
    want = [float(np.sqrt(sum(float(np.sum(np.asarray(g) ** 2))
                              for g in jax.tree_util.tree_leaves(s))))
            for s in jmpmd.split_llama_params(grads, 3)]
    pipe = tmpmd.MPMDPipeline(tcfg, params_from_numpy(tree, device=CPU),
                              n_stages=3, n_microbatches=8, device=CPU)
    try:
        got_loss = pipe.grad_check_step(tokens)
        norms = pipe.grad_norms()
        vjps = pipe.live_vjp_counts()
    finally:
        pipe.teardown()
    assert abs(got_loss - float(loss)) < PIPE_TOL
    np.testing.assert_allclose(norms, want, rtol=1e-4)
    assert vjps == [0, 0, 0]


def test_default_pipeline_holds_the_card_and_never_the_cpu(port_cluster,
                                                           monkeypatch):
    """With no ``device`` the stages run on CUDA. On this host, which has
    no CUDA, the pipeline raises before it starts a stage; told that the
    driver has CUDA, it gives each stage half of the cluster's one card
    (a resource here), and each stage, finding no CUDA in its process,
    dies naming card "0" rather than train on the CPU: the pipeline's
    formation fails with it."""
    from ray_tpu_torch import ActorDiedError

    _, tcfg, tree = _mpmd_model()
    params = params_from_numpy(tree, device=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tmpmd.MPMDPipeline(tcfg, params, n_stages=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ActorDiedError,
                       match=r"holds GPU \['0'\] .* finds no CUDA"):
        tmpmd.MPMDPipeline(tcfg, params, n_stages=2, n_microbatches=2)


def test_checkpoint_compat_pp4_to_pp2_and_single_mesh(port_cluster,
                                                      tmp_path):
    """A pp=4 merged checkpoint loads as a pp=2 pipeline (with the chunked
    loss on its last stage) and as the single program's tree, and the
    three agree with each other and with JAX's loss on the same batch."""
    jcfg, tcfg, tree = _mpmd_model()
    tokens = _batch(1, rows=4)
    want = float(jllama.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens)}, jcfg,
                                remat=True))
    pipe = tmpmd.MPMDPipeline(tcfg, params_from_numpy(tree, device=CPU),
                              n_stages=4, n_microbatches=2,
                              checkpoint_dir=str(tmp_path / "ckpt"),
                              device=CPU)
    try:
        loss4 = pipe.grad_check_step(tokens)
        ckpt = pipe.save_checkpoint()
    finally:
        pipe.teardown()
    pipe2 = tmpmd.MPMDPipeline.from_checkpoint(ckpt, tcfg, n_stages=2,
                                               n_microbatches=2,
                                               chunked_vocab=64, device=CPU)
    try:
        loss2 = pipe2.grad_check_step(tokens)
    finally:
        pipe2.teardown()
    from ray_tpu_torch.train.checkpoint import load_pytree

    merged = load_pytree(ckpt, device=CPU)
    with torch.no_grad():
        loss1 = float(tllama.loss_fn(merged, {"tokens": torch.from_numpy(
            tokens).long()}, tcfg, remat=True))
    for got in (loss4, loss2, loss1):
        assert abs(got - want) < 1e-4, (loss4, loss2, loss1, want)
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(merged)[k].numpy(), v)


def test_member_lost_detected_by_gang_push(port_cluster, tmp_path):
    """A stage process killed mid-step surfaces as a typed,
    generation-stamped ``PipelineMemberLost`` through the gang push in
    seconds, never the compiled chain's 300 s result timeout; the re-form
    under the same gang name from the merged checkpoint lands at
    generation + 1 and trains."""
    import os
    import signal
    import threading
    import time

    import ray_tpu_torch

    _, tcfg, tree = _mpmd_model()
    tokens = _batch(1, rows=8)
    pipe = tmpmd.MPMDPipeline(tcfg, params_from_numpy(tree, device=CPU),
                              n_stages=2, n_microbatches=4,
                              simulate_compute_s=0.1, gang_name="pushgang",
                              checkpoint_dir=str(tmp_path / "ckpt"),
                              device=CPU)
    pipe2 = None
    try:
        gen1 = pipe.generation
        assert gen1 >= 1
        assert np.isfinite(pipe.step(tokens))
        ckpt = pipe.save_checkpoint()
        pid = ray_tpu_torch.get(pipe.stages[1].probe.remote(),
                                timeout=30)["pid"]
        assert ray_tpu_torch.get(pipe.stages[1].pid.remote(),
                                 timeout=30) == pid
        threading.Timer(0.25, lambda: os.kill(pid, signal.SIGKILL)).start()
        t0 = time.monotonic()
        with pytest.raises(tmpmd.PipelineMemberLost) as ei:
            pipe.step(tokens)
        detect_s = time.monotonic() - t0
        assert 1 in ei.value.lost_stages and ei.value.lost_ranks == \
            ei.value.lost_stages
        assert ei.value.generation == gen1
        assert ei.value.checkpoint_path == ckpt
        assert detect_s < 30, detect_s
        pipe.teardown()
        pipe2 = tmpmd.MPMDPipeline.from_checkpoint(
            ckpt, tcfg, n_stages=2, n_microbatches=2, gang_name="pushgang",
            device=CPU)
        assert pipe2.generation == gen1 + 1
        assert np.isfinite(pipe2.step(tokens[:4]))
    finally:
        for p in (pipe, pipe2):
            if p is not None:
                p.teardown()


def test_boundary_fault_surfaces_typed_and_the_retry_is_clean(port_cluster):
    """Stage 0's second boundary send (microbatch 1's forward hop) drops:
    the step fails with the typed transport error (a ``ConnectionError``)
    and the retry's update is one clean AdamW step, JAX's, within 1e-4:
    the failed step's completed microbatch does not leak into it."""
    jcfg, tcfg, tree = _mpmd_model()
    want_losses, want_params, _ = _jax_trajectory(jcfg, tree, 2, None,
                                                  steps=1)
    pipe = tmpmd.MPMDPipeline(
        tcfg, params_from_numpy(tree, device=CPU), n_stages=2,
        n_microbatches=2, lr=LR,
        stage_env={"RAY_TPU_TORCH_FAILPOINTS":
                   "mpmd.boundary.send.s0=hit2:drop",
                   "RAY_TPU_TORCH_FAILPOINT_SEED": "15"}, device=CPU)
    try:
        with pytest.raises(ConnectionError, match="boundary send drop"):
            pipe.step(_batch(0))
        retry = pipe.step(_batch(0))
        vjps = pipe.live_vjp_counts()
        merged = tmpmd.merge_stage_params(pipe.get_params())
    finally:
        pipe.teardown()
    assert abs(retry - want_losses[0]) < PIPE_TOL
    assert vjps == [0, 0]
    _hold_params({k: v.numpy() for k, v in _flat(merged).items()},
                 {k: np.asarray(v) for k, v in _flat(want_params).items()})


def test_dryrun_mpmd_part_matches_jax(port_cluster):
    """The dryrun's MPMD part (3 stages, 8 microbatches, 1F1B, and the
    sleep-bound schedule) on the running cluster: its single-program loss
    is JAX's ``loss_fn`` on the same weights."""
    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.parallel import dryrun

    out = dryrun.dryrun_mpmd_pipeline(device=CPU)
    cfg, params, tokens = dryrun.mpmd_inputs()
    jcfg = jllama.LlamaConfig(**dryrun.MPMD_DIMS, dtype=jnp.float32,
                              tie_embeddings=False)
    want = float(jllama.loss_fn(
        jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params)),
        {"tokens": jnp.asarray(tokens.numpy())}, jcfg, remat=True))
    assert abs(out["ref_loss"] - want) < PIPE_TOL
    assert abs(out["loss"] - want) < 1e-4
    assert out["sim_bubble_fraction"] < 0.4
    # every part of the reference's dryrun runs: nothing is listed as not
    # run any more
    assert not hasattr(dryrun, "NOT_RUN")


def test_drain_mid_1f1b_checkpoints_at_a_boundary_and_reshapes(
        port_cluster, tmp_path):
    """A node hosting stage 1 drains mid-step: the step stops admitting
    at a microbatch boundary, applies the partial gradient, checkpoints
    the merged params and raises ``PipelineDrainSignal``; the pipeline
    re-formed from that checkpoint lands off the draining node and
    trains. (Last in the file: the drained node stays drained.)"""
    import os
    import threading

    import ray_tpu_torch
    from ray_tpu_torch.util import state as state_api

    port_cluster.add_node(num_cpus=2, resources={"s1": 2})
    assert port_cluster.wait_for_nodes(2, timeout=120)
    _, tcfg, tree = _mpmd_model()
    tokens = _batch(2, rows=12)
    pipe = pipe2 = None
    try:
        pipe = tmpmd.MPMDPipeline(
            tcfg, params_from_numpy(tree, device=CPU), n_stages=2,
            n_microbatches=6, simulate_compute_s=0.15,
            checkpoint_dir=str(tmp_path / "ckpt"),
            stage_options=[{}, {"resources": {"s1": 1}}], device=CPU)
        actors = {a["actor_id"]: a.get("node_id")
                  for a in state_api.list_actors()}
        doomed = actors[pipe.stages[1]._id.hex()]
        assert doomed is not None
        assert np.isfinite(pipe.step(tokens))
        threading.Timer(0.4, lambda: ray_tpu_torch.drain_node(
            doomed, reason="preemption notice", deadline_s=60.0)).start()
        with pytest.raises(tmpmd.PipelineDrainSignal) as ei:
            pipe.step(tokens)
        sig = ei.value
        assert 0 < sig.completed_microbatches < 6, sig
        assert 1 in sig.draining_stages
        assert os.path.exists(os.path.join(sig.checkpoint_path,
                                           "meta.json"))
        pipe.teardown()
        pipe2 = tmpmd.MPMDPipeline.from_checkpoint(
            sig.checkpoint_path, tcfg, n_stages=2, n_microbatches=2,
            drain_aware=False, device=CPU)
        assert np.isfinite(pipe2.step(tokens[:4]))
        actors = {a["actor_id"]: a.get("node_id")
                  for a in state_api.list_actors()}
        assert all(actors[s._id.hex()] != doomed for s in pipe2.stages)
    finally:
        for p in (pipe, pipe2):
            if p is not None:
                p.teardown()
