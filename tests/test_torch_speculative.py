"""Parity of the PyTorch port's speculative decoding
(ray_tpu_torch.models.speculative) with the JAX package's, on the CPU in
fp32.

The target is the JAX speculative tests' model (vocab 96, d_model 64, 2
layers, 4/2 heads, d_ff 128) and the weak draft theirs (d_model 32, 1
layer); weights come from the JAX ``init_params`` through
``params_from_numpy``. Tokens must equal JAX's ``generate_speculative``'s
and the port's ``generate_greedy``'s exactly, and the round stats
(rounds, drafted, accepted) JAX's. The port reads the device once a round
and once at the end (JAX: once a generation), so its ``host_fetches`` is
rounds + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import speculative as jspec
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import speculative as tspec
from ray_tpu_torch.models.convert import params_from_numpy

CPU = "cpu"
TARGET = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, max_seq_len=128)
DRAFT = dict(vocab_size=96, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
             d_ff=64, max_seq_len=128)
STAT_KEYS = ("rounds", "drafted", "accepted", "acceptance_rate",
             "target_forwards", "tokens_per_target_forward")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small: the suite runs files in
    parallel workers, beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(fields, seed):
    jcfg = jllama.LlamaConfig(**fields, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**fields, dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return (jparams, jcfg), (params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device=CPU), tcfg)


@pytest.fixture(scope="module")
def models():
    """{"target", "weak", "anti"}: each a ((jax params, cfg), (port
    params, cfg)) pair. "anti" negates the target's head, so its greedy
    choice is the target's least likely token."""
    out = {"target": _pair(TARGET, 0), "weak": _pair(DRAFT, 1)}
    (jt, jcfg), (tt, tcfg) = out["target"]
    out["anti"] = ((dict(jt, lm_head=-jt["lm_head"]), jcfg),
                   (dict(tt, lm_head=-tt["lm_head"]), tcfg))
    return out


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 96, (1, n))


def _both(models, draft, prompt, max_new, k):
    """JAX's and the port's (tokens, stats) for the target and ``draft``
    (a key of ``models`` or a pair)."""
    (jt, jcfg), (tt, tcfg) = models["target"]
    (jd, jdcfg), (td, tdcfg) = models[draft] if isinstance(draft, str) \
        else draft
    jtok, jstats = jspec.generate_speculative(
        jt, jd, jnp.asarray(prompt, jnp.int32), jcfg, jdcfg,
        max_new=max_new, k=k)
    ttok, tstats = tspec.generate_speculative(
        tt, td, torch.from_numpy(prompt), tcfg, tdcfg, max_new=max_new, k=k)
    want = tllama.generate_greedy(tt, torch.from_numpy(prompt), tcfg,
                                  max_new=max_new)
    assert ttok.tolist() == np.asarray(jtok).tolist() == want.tolist()
    assert {s: tstats[s] for s in STAT_KEYS} == \
        {s: jstats[s] for s in STAT_KEYS}
    assert tstats["host_fetches"] == tstats["rounds"] + 1
    return ttok, tstats


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("draft", ["weak", "target", "truncated"])
def test_tokens_and_round_stats_match_jax(models, draft, k):
    """An unrelated random draft, the target itself (every draft
    accepted) and the target's first layer (a real draft)."""
    if draft == "truncated":
        (jt, jcfg), (tt, tcfg) = models["target"]
        draft = (jspec.truncated_draft(jt, jcfg, 1),
                 tspec.truncated_draft(tt, tcfg, 1))
    _, stats = _both(models, draft, _prompt(k, 6), 20, k)
    assert stats["drafted"] == stats["rounds"] * k
    if draft == "target":
        assert stats["acceptance_rate"] == 1.0
        assert stats["rounds"] <= -(-19 // (k + 1)) + 1


def test_zero_accept_schedule(models):
    """Every round rejects at the first draft: one token a round."""
    _, stats = _both(models, "anti", _prompt(12, 6), 12, 4)
    assert stats["accepted"] == 0 and stats["acceptance_rate"] == 0.0
    assert stats["rounds"] == 11


def test_truncated_draft_is_the_same_layers_as_jax(models):
    (jt, jcfg), (tt, tcfg) = models["target"]
    jd, jdcfg = jspec.truncated_draft(jt, jcfg, 1)
    td, tdcfg = tspec.truncated_draft(tt, tcfg, 1)
    assert tdcfg.n_layers == jdcfg.n_layers == 1
    assert tdcfg == tllama.LlamaConfig(**dict(TARGET, n_layers=1),
                                       dtype=torch.float32)
    assert td["layers"][0] is tt["layers"][0]       # shared, not copied
    assert td["lm_head"] is tt["lm_head"]
    assert len(td["layers"]) == len(jd["layers"]) == 1
    for name, w in jd["layers"][0].items():
        np.testing.assert_array_equal(td["layers"][0][name].numpy(),
                                      np.asarray(w))
    for n in (0, 2, -1):
        with pytest.raises(ValueError, match="draft needs 1..1 layers"):
            tspec.truncated_draft(tt, tcfg, n)


def test_batch_one_guard(models):
    _, (tt, tcfg) = models["target"]
    _, (td, tdcfg) = models["weak"]
    with pytest.raises(ValueError, match="batch-1"):
        tspec.generate_speculative(tt, td, torch.zeros(2, 4, dtype=torch.long),
                                   tcfg, tdcfg)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("max_new", [1, 16])
def test_every_read_goes_through_device_fetch(models, monkeypatch, k,
                                              max_new):
    """The port's counterpart of JAX's transfer-guard test: the reads are
    counted through the ``_device_fetch`` seam, one a round and one for
    the tokens, and the tokens stay the target's greedy decode."""
    _, (tt, tcfg) = models["target"]
    _, (td, tdcfg) = models["weak"]
    prompt = torch.from_numpy(_prompt(11, 5))
    calls = []
    real = tspec._device_fetch
    monkeypatch.setattr(tspec, "_device_fetch",
                        lambda t: (calls.append(t.shape), real(t))[1])
    out, stats = tspec.generate_speculative(tt, td, prompt, tcfg, tdcfg,
                                            max_new=max_new, k=k)
    assert len(calls) == stats["host_fetches"] == stats["rounds"] + 1
    assert calls[-1] == (max_new,) and all(c == () for c in calls[:-1])
    assert out.tolist() == tllama.generate_greedy(
        tt, prompt, tcfg, max_new=max_new).tolist()
