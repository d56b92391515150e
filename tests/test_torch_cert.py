"""Parity of the PyTorch port's 8B certificate machinery with the JAX
package's, on the CPU.

``stage_abstract_params`` against JAX's ``eval_shape`` tree at
Llama-3-8B; ``lower_stage_step``'s bytes a rank against XLA's memory
analysis of JAX's ``lower_stage_step`` on an 8-device stage submesh (the
reference test's small model), and at Llama-3-8B over pp = 4 x fsdp = 16
against a hand sum from ``stage_param_count``; ``build_stage_step`` in
bf16, two steps, against JAX's ``optax.adamw(mu_dtype=float32)``; the
one-stage memory budget against the reference's committed fsdp = 64
record; the dryrun's multi-host part (two launcher processes meeting at
a TCP address), and the whole dryrun's lines.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mpmd_pipeline as jmpmd
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import dryrun as tdryrun
from ray_tpu_torch.parallel import mpmd_pipeline as tmpmd
from ray_tpu_torch.parallel import sharding as tsharding

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
HBM_GIB = 80.0  # the device memory passed to both budgets (a value)
# The reference test's model (tests/test_mpmd_pipeline.py,
# test_lower_stage_step_compiles_on_stage_submesh).
LOWER_CFG = dict(vocab_size=512, d_model=64, n_layers=3, n_heads=4,
                 n_kv_heads=2, d_ff=128, max_seq_len=64,
                 tie_embeddings=False)
LOWER_DEVICES, LOWER_BATCH, LOWER_SEQ, LOWER_CHUNK = 8, 8, 32, 256
# XLA's CPU memory analysis counts the result tuple's table of buffer
# pointers in the output size: 8 bytes a result leaf.
XLA_TUPLE_ENTRY_BYTES = 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def test_stage_abstract_params_match_jax_at_8b():
    """Every stage of Llama-3-8B over 4: the same paths, shapes and dtypes
    as JAX's ``eval_shape`` tree, every leaf a ``meta`` tensor."""
    got = tmpmd.stage_abstract_params(tllama.LLAMA3_8B, 4)
    want = jmpmd.stage_abstract_params(jllama.LLAMA3_8B, 4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = _flat(g), _flat(w)
        assert g.keys() == w.keys()
        for path, leaf in g.items():
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == tuple(w[path].shape), path
            assert str(leaf.dtype) == f"torch.{w[path].dtype}", path


@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_lower_stage_step_bytes_match_xla(stage_idx):
    """Each stage kind of the reference test's model on an 8-way stage
    submesh, batch 8 of 32 tokens, chunked vocab 256: the argument bytes a
    device equal XLA's memory analysis of JAX's lowering, and the output
    bytes equal it less the result tuple's pointer table (8 bytes a
    result leaf, which XLA's CPU backend counts)."""
    from ray_tpu.parallel.sharding import stage_submesh as jsubmesh

    jcfg = jllama.LlamaConfig(**LOWER_CFG, dtype=jnp.float32)
    lowered = jmpmd.lower_stage_step(
        jcfg, stage_idx, 3, jsubmesh(LOWER_DEVICES), batch=LOWER_BATCH,
        seq=LOWER_SEQ, chunked_vocab=LOWER_CHUNK)
    want = lowered.compile().memory_analysis()
    n_results = len(jax.tree_util.tree_leaves(lowered.out_info))

    tcfg = tllama.LlamaConfig(**LOWER_CFG, dtype=torch.float32)
    mesh = tsharding.stage_submesh(LOWER_DEVICES, device=CPU)
    low = tmpmd.lower_stage_step(tcfg, stage_idx, 3, mesh,
                                 batch=LOWER_BATCH, seq=LOWER_SEQ,
                                 chunked_vocab=LOWER_CHUNK)
    got = low
    assert low.kind == ("first", "mid", "last")[stage_idx]
    assert all(t.device.type == "meta" for t in low.outputs)
    assert got.argument_size_in_bytes == want.argument_size_in_bytes
    assert got.output_size_in_bytes == \
        want.output_size_in_bytes - XLA_TUPLE_ENTRY_BYTES * n_results


@pytest.mark.parametrize("stage_idx", [0, 1, 2, 3])
def test_lower_stage_step_at_8b_is_the_hand_sum(stage_idx):
    """Llama-3-8B, pp = 4 x fsdp = 16, one row a rank at seq 8192: a
    rank's argument bytes are the stage's parameters split 16 ways but
    for the norms (whole on every rank), as bf16, fp32 mu and bf16 nu,
    the int32 count, and the rank's row of the inputs."""
    cfg, fsdp, seq = tllama.LLAMA3_8B, 16, 8192
    mesh = tsharding.stage_submesh(fsdp, device="meta")
    low = tmpmd.lower_stage_step(cfg, stage_idx, 4, mesh, batch=fsdp,
                                 seq=seq, chunked_vocab=16384)
    n = tmpmd.stage_param_count(cfg, 4, stage_idx)
    norms = cfg.d_model * (2 * tmpmd.stage_layer_counts(
        cfg.n_layers, 4)[stage_idx] + (stage_idx == 3))
    elems = (n - norms) // fsdp + norms
    act, ints = seq * cfg.d_model * 2, seq * 4
    inputs = {0: ints + act, 1: 2 * act, 2: 2 * act, 3: act + ints}
    want = (2 + 4 + 2) * elems + 4 + inputs[stage_idx]
    got = low
    assert got.argument_size_in_bytes == want
    assert got.by_class["in_adam_mu"] == 4 * elems
    assert got.by_class["in_adam_nu"] == got.by_class["in_params"] \
        == 2 * elems


def test_one_stage_budget_is_the_fsdp64_record():
    """``stage_hbm_budget`` with one stage (Llama-3-8B as one fsdp = 64
    program, the dryrun's 8b_fsdp64 line) has every row of the
    reference's committed budget (``benchmarks/certify_8b.py``'s
    ``budget_table``) to the byte, plus the first stage's embedding rows,
    which that table leaves out; and no boundary row."""
    with open(REPO / "records/hbm_budget_8b_fsdp64.json") as f:
        rec = json.load(f)["hbm_budget"]["bytes_per_chip"]
    got = tmpmd.stage_hbm_budget(
        tllama.LLAMA3_8B, 1, 0, devices_per_stage=64, batch_per_chip=1,
        seq=8192, n_microbatches=1, hbm_gib_per_chip=HBM_GIB)
    rows = dict(got["bytes_per_chip"])
    assert rows.pop("live_mb_state_bf16_x_depth") == \
        rec.pop("remat_boundaries_bf16")
    assert rows.pop("embed_rows_bf16") == 8192 * 4096 * 2
    assert rows == rec
    assert got["depth_1f1b"] == got["live_mb_bound"] == 1
    assert tmpmd.stage_param_count(tllama.LLAMA3_8B, 1, 0) == \
        tllama.LLAMA3_8B.param_count()


# -------------------------------------------------- bf16 build_stage_step

STEP_CFG = dict(vocab_size=96, d_model=64, n_layers=5, n_heads=4,
                n_kv_heads=2, d_ff=128, max_seq_len=64)
STEP_TOKENS = (2, 32)
STEP_LR = 1e-3
# Held after two steps from the same bf16 weights. The forward's outputs:
# bf16 on both sides with products rounded in other places, each element
# within A * max|want| + R * |want|. A parameter, where JAX's gradient is
# at least STEP_BIG_GRAD of its leaf's largest in both steps (below it
# the bf16 gradients' rounding can turn Adam's step): within lr / 4 plus
# one bf16 ulp of the value a step. Each step moves it by about lr, and
# JAX's compiled step and the port's eager one round their bf16
# intermediates in different places, so a step whose update lies near
# half an ulp of the value may round to the neighbouring bf16 value. A
# missing update (2 lr) or step 2's bias correction taken at step 1's
# (1.34 lr where it is lr) fails it. Each moment within its share of the
# leaf's largest moment: mu is fp32 of bf16 gradients that differ by
# their rounding, nu is bf16.
STEP_OUT_RULE = (2e-2, 2e-2)
STEP_BIG_GRAD = 2.0 ** -5
STEP_PARAM_ATOL = STEP_LR / 4
STEP_MU_SHARE, STEP_NU_SHARE = 3e-2, 4e-2


def _bf16_ulp(x):
    """The spacing of bf16 values at each element of ``x`` (8 bits of
    mantissa, its lowest normal exponent for zero)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(x)) - 7)


def _hold(got, want, atol, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@functools.lru_cache(maxsize=None)
def _bf16_tree():
    jcfg = jllama.LlamaConfig(**STEP_CFG, dtype=jnp.bfloat16)
    return jcfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jax.jit(lambda k: jllama.init_params(jcfg, k))(
            jax.random.PRNGKey(4)))


@pytest.mark.parametrize("stage_idx", [0, 1, 2])
def test_bf16_stage_step_keeps_optax_moments(stage_idx):
    """Each stage kind in bf16, two steps of ``build_stage_step`` against
    JAX's (``optax.adamw(lr, weight_decay=0.1, mu_dtype=float32)``): the
    first moment fp32 and the second bf16 on both sides, the count 2, and
    the outputs, parameters (where JAX's gradient is not small) and
    moments within the bf16 rules above."""
    jcfg, tree = _bf16_tree()
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, STEP_CFG["vocab_size"],
                          STEP_TOKENS).astype(np.int32)
    act = rng.standard_normal(
        (*STEP_TOKENS, STEP_CFG["d_model"])).astype(np.float32)
    g_out = (rng.standard_normal(act.shape) * 1e-2).astype(np.float32)
    targets = np.concatenate(
        [tokens[:, 1:], np.full((STEP_TOKENS[0], 1), -100, np.int32)], 1)
    stage = jmpmd.split_llama_params(tree, 3)[stage_idx]

    jopt, jstep, kind = jmpmd.build_stage_step(jcfg, stage_idx, 3,
                                               lr=STEP_LR)
    jstep = jax.jit(jstep)
    first = tokens if kind == "first" else act
    second = targets if kind == "last" else g_out

    def jarg(a):
        return jnp.asarray(a) if a.dtype == np.int32 else \
            jnp.asarray(a, jnp.bfloat16)

    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                stage)
    state = jopt.init(jp)
    want_outs, grads = [], []
    for _ in range(2):
        # JAX's gradient of the stage at this step, for the small-gradient
        # mask
        a, b = jarg(first), jarg(second)
        if kind == "last":
            grads.append(jax.grad(lambda p: jmpmd.stage_loss(
                p, a, b, jcfg))(jp))
        else:
            grads.append(jax.grad(lambda p: jnp.sum(jmpmd.stage_forward(
                p, a, jcfg, first=kind == "first") * b))(jp))
        res = jstep(jp, state, a, b)
        jp, state = res[0], res[1]
        want_outs.append(res[2:])

    tcfg = tllama.LlamaConfig(**STEP_CFG, dtype=torch.bfloat16)
    make_opt, step_fn, tkind = tmpmd.build_stage_step(tcfg, stage_idx, 3,
                                                      lr=STEP_LR)
    assert tkind == kind
    params = params_from_numpy(stage, device=CPU, dtype=torch.bfloat16)
    opt = make_opt(params)

    def targ(a):
        t = torch.from_numpy(a.copy())
        return t if a.dtype == np.int32 else t.to(torch.bfloat16)

    got_outs = []
    for _ in range(2):
        out = step_fn(params, opt, targ(first), targ(second))
        got_outs.append(out if isinstance(out, tuple) else (out,))

    for step, (got, want) in enumerate(zip(got_outs, want_outs)):
        for i, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w, np.float32)
            a, r = STEP_OUT_RULE
            _hold(g.float().numpy(), w, a * float(np.abs(w).max()), r,
                  f"step {step + 1} output {i}")
    adam = state[0]  # optax.adamw's chain: ScaleByAdamState first
    assert int(adam.count) == int(opt.count) == 2
    paths = [p for p, _ in tsharding.tree_paths(params)]
    jmu, jnu, jparams = _flat(adam.mu), _flat(adam.nu), _flat(jp)
    jgrads = [_flat(g) for g in grads]
    assert set(paths) == set(jmu) == set(jparams)
    for path, p, mu, nu in zip(paths, opt.leaves, opt.mu, opt.nu):
        assert jmu[path].dtype == jnp.float32 and mu.dtype == torch.float32
        assert jnu[path].dtype == jnp.bfloat16 and nu.dtype == torch.bfloat16
        assert p.dtype == torch.bfloat16 and p.grad is None
        want = np.asarray(jparams[path], np.float32)
        big = np.ones(want.shape, bool)
        for g in jgrads:
            g = np.abs(np.asarray(g[path], np.float32))
            big &= g >= STEP_BIG_GRAD * g.max()
        assert big.any(), path
        _hold(p.detach().float().numpy()[big], want[big],
              STEP_PARAM_ATOL + 2 * _bf16_ulp(want[big]), 0.0,
              f"{path} after two steps")
        for got, want, share, what in (
                (mu, jmu[path], STEP_MU_SHARE, "mu"),
                (nu, jnu[path], STEP_NU_SHARE, "nu")):
            want = np.asarray(want, np.float32)
            _hold(got.float().numpy(), want,
                  share * float(np.abs(want).max()), 0.0, f"{path} {what}")


def test_dryrun_multihost_meets_across_two_launchers(capfd):
    """Two launcher processes of two ranks each meet at a TCP address and
    compute mean((x @ I)^2) across them: 2.5, with ``RDZV_OK`` from both
    launchers, ranks 0-1 and 2-3."""
    out = tdryrun.dryrun_multihost(4, device=CPU)
    printed = capfd.readouterr().out
    assert out["loss"] == tdryrun.MULTIHOST_LOSS == 2.5
    assert out["lines"] == [
        "RDZV_OK launcher=0 ranks=[0, 1] world=4 loss=2.5",
        "RDZV_OK launcher=1 ranks=[2, 3] world=4 loss=2.5"]
    assert "dryrun multihost: 2-launcher torch.distributed rendezvous" \
        in printed


def test_dryrun_runs_every_part_with_the_8b_lines(capfd, monkeypatch):
    """``dryrun_multichip(2)`` on the CPU runs the sharded step, the
    multi-host part (2.5 across two launchers) and the MPMD part (stubbed
    here: ``test_torch_mpmd.py`` runs it on its cluster and holds it to
    JAX), then both 8B lines, each naming the card it was reckoned for and
    carrying ``stage_hbm_budget``'s numbers; no line says a part was not
    run or not ported."""
    mpmd = []
    monkeypatch.setattr(tdryrun, "dryrun_mpmd_pipeline",
                        lambda device: mpmd.append(device) or {"loss": 1.0})
    losses = tdryrun.dryrun_multichip(2, device=CPU,
                                      hbm_gib_per_chip=HBM_GIB)
    out = capfd.readouterr().out
    assert set(losses) == {"sharded", "multihost", "mpmd"}
    assert losses["multihost"] == tdryrun.MULTIHOST_LOSS
    assert mpmd == [torch.device(CPU)]
    assert "not ported" not in out and "not run" not in out
    assert out.count("RDZV_OK") == 2
    card = f"a card of {HBM_GIB:.2f} GiB"
    cfg = tllama.LLAMA3_8B
    one = tmpmd.stage_hbm_budget(
        cfg, 1, 0, devices_per_stage=64, batch_per_chip=1, seq=8192,
        n_microbatches=1, hbm_gib_per_chip=HBM_GIB)
    line = next(ln for ln in out.splitlines() if ln.startswith("8b_fsdp64"))
    assert card in line
    assert f"{one['total_gib_per_chip']} GiB a card at batch 1" in line
    assert f"fits={one['fits']}" in line
    stages = [tmpmd.stage_hbm_budget(
        cfg, 4, i, devices_per_stage=16, batch_per_chip=1, seq=8192,
        n_microbatches=8, hbm_gib_per_chip=HBM_GIB) for i in range(4)]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("8b_pp4_fsdp16"))
    assert card in line
    assert str([b["total_gib_per_chip"] for b in stages]) in line
    assert str([b["worst_case_gib_per_chip"] for b in stages]) in line
    assert str([b["depth_1f1b"] for b in stages]) in line
    assert "bubble fractions not reported" in line


def test_dryrun_off_cuda_needs_the_card_memory():
    with pytest.raises(ValueError, match="hbm_gib_per_chip"):
        tdryrun.dryrun_multichip(2, device=CPU)
