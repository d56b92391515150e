"""Parity of the PyTorch port's serving slice (ray_tpu_torch.models and
.serve) with the JAX package, on the CPU.

Weights come from the JAX ``init_params`` and reach the port through
numpy and ``params_from_numpy``. Logits are held at atol = rtol = 1e-4:
both sides are fp32, and the port's prefill runs the blockwise flash
path where JAX runs a masked einsum, so sums are taken in another order
through two layers. Greedy tokens must be identical.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import engine as jengine
from ray_tpu.models import llama as jllama
from ray_tpu.ops import quant as jquant
from ray_tpu_torch.models import engine as tengine
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import paged as tpaged
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import layers as tlayers
from ray_tpu_torch.ops.quant import Q8
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.util import events

CPU = "cpu"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

JCFG = jllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=torch.float32)



@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small: the suite runs files in
    parallel workers, beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def to_numpy(tree):
    """A JAX parameter tree as numpy, each Q8 leaf as a (w, s) pair."""
    if isinstance(tree, jquant.Q8):
        return (np.asarray(tree.w), np.asarray(tree.s))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(to_numpy(jparams), device=CPU)


def _jref(jparams, prompt, n):
    return jllama.generate_greedy(
        jparams, jnp.asarray(prompt, jnp.int32)[None, :], JCFG,
        max_new=n)[0].tolist()


# ---------------------------------------------------------- conversion

def test_bf16_and_q8_conversion_is_bit_exact():
    cfg = dataclasses.replace(jllama.LLAMA_DEBUG, dtype=jnp.bfloat16)
    jparams = jquant.quantize_params(
        jllama.init_params(cfg, jax.random.PRNGKey(3)))
    tparams = params_from_numpy(to_numpy(jparams), device=CPU)
    emb = tparams["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jparams["embedding"]).view(np.uint16))
    wq = tparams["layers"][1]["wq"]
    assert isinstance(wq, Q8) and wq.w.dtype == torch.int8
    np.testing.assert_array_equal(wq.w.numpy(),
                                  np.asarray(jparams["layers"][1]["wq"].w))
    np.testing.assert_array_equal(
        wq.s.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jparams["layers"][1]["wq"].s).view(np.uint16))
    assert set(tparams["layers"][0]) == set(jparams["layers"][0])


def test_init_params_builds_the_jax_tree():
    g = torch.Generator().manual_seed(0)
    tparams = tllama.init_params(TCFG, g, device=CPU)
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams,
                                  is_leaf=torch.is_tensor) == shapes
    assert float(tparams["norm"].abs().sum()) == 0.0
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        tparams, is_leaf=torch.is_tensor))
    assert n == TCFG.param_count()


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("quantized", [False, True])
def test_forward_logits_match_jax(model, quantized):
    jparams, _ = model
    if quantized:
        jparams = jquant.quantize_params(jparams)
    tparams = params_from_numpy(to_numpy(jparams), device=CPU)
    tokens = np.random.default_rng(0).integers(0, 96, size=(2, 24))
    want = jllama.forward(jparams, jnp.asarray(tokens, jnp.int32), JCFG)
    got = tllama.forward(tparams, torch.from_numpy(tokens), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_generate_greedy_tokens_match_jax(model):
    jparams, tparams = model
    prompt = np.random.default_rng(1).integers(0, 96, size=(2, 7))
    want = jllama.generate_greedy(jparams, jnp.asarray(prompt, jnp.int32),
                                  JCFG, max_new=12)
    got = tllama.generate_greedy(tparams, torch.from_numpy(prompt), TCFG,
                                 max_new=12)
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_sample_is_seeded_and_in_range(model):
    _, tparams = model
    prompt = torch.tensor([[1, 2, 3]])
    runs = [tllama.generate_sample(tparams, prompt, TCFG,
                                   torch.Generator().manual_seed(s),
                                   max_new=8, temperature=0.9)
            for s in (5, 5, 6)]
    assert runs[0].tolist() == runs[1].tolist()
    assert runs[0].shape == (1, 8)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < 96


def test_prefill_matches_jax_prefill_one(model):
    jparams, tparams = model
    total, pad, n_valid = 48, 16, 11
    prompt = np.zeros(pad, np.int64)
    prompt[:n_valid] = np.random.default_rng(2).integers(1, 96, n_valid)
    jcos, jsin = jllama.rope_frequencies(JCFG.head_dim, total)
    jlogits, jcaches = jengine._prefill_one(
        jparams, jnp.asarray(prompt, jnp.int32), n_valid, total, JCFG, jcos,
        jsin, pad)
    tcos, tsin = tlayers.rope_frequencies(TCFG.head_dim, total)
    caches = tllama.new_caches(TCFG, 1, total, CPU)
    tlogits, tcaches = tengine._prefill_one(
        tparams, torch.from_numpy(prompt), n_valid, caches, TCFG, tcos, tsin)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    for (tk, tv), (jk, jv) in zip(tcaches, jcaches):
        np.testing.assert_allclose(tk[0, :n_valid].numpy(),
                                   np.asarray(jk)[:n_valid], **LOGIT_TOL)
        np.testing.assert_allclose(tv[0, :n_valid].numpy(),
                                   np.asarray(jv)[:n_valid], **LOGIT_TOL)


# --------------------------------------------------------------- engine

PROMPTS = {
    "a": ([1, 2, 3, 4], 12),
    "b": ([7, 8], 5),            # finishes early, frees its slot
    "c": (list(range(10, 30)), 9),  # a 20-token prompt: the 64 bucket
    "d": ([20, 21], 7),          # admitted once a slot frees
}


def test_engine_tokens_match_jax_engine(model):
    jparams, tparams = model
    jeng = jengine.GenerationEngine(jparams, JCFG, max_slots=3, max_len=96)
    teng = tengine.GenerationEngine(tparams, TCFG, max_slots=3, max_len=96,
                                    device=CPU)
    for rid, (p, n) in PROMPTS.items():
        jeng.submit(rid, p, max_new_tokens=n)
        teng.submit(rid, p, max_new_tokens=n)
    want, got = jeng.run_to_completion(), teng.run_to_completion()
    assert got == want
    assert teng.prefills == len(PROMPTS)
    for rid, (p, n) in PROMPTS.items():
        assert got[rid] == _jref(jparams, p, n), rid


def test_engine_eos_capacity_and_seeded_sampling(model):
    jparams, tparams = model
    ref = _jref(jparams, [5, 6, 7], 20)
    eng = tengine.GenerationEngine(tparams, TCFG, max_slots=2, max_len=64,
                                   device=CPU)
    eng.submit("x", [5, 6, 7], max_new_tokens=20, eos_id=ref[4])
    assert eng.run_to_completion()["x"] == ref[:5]
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit("big", list(range(40)), max_new_tokens=30)

    def sampled(seed):
        e = tengine.GenerationEngine(tparams, TCFG, max_slots=2, max_len=64,
                                     device=CPU)
        e.submit("s", [1, 2, 3], max_new_tokens=10, temperature=0.8,
                 top_k=10, seed=seed)
        e.submit("g", [1, 2, 3], max_new_tokens=10)
        return e.run_to_completion()

    first, again, other = sampled(42), sampled(42), sampled(7)
    assert first["g"] == _jref(jparams, [1, 2, 3], 10)
    assert first["s"] == again["s"] and first["s"] != other["s"]
    assert len(first["s"]) == 10


def test_engine_prompt_past_the_last_bucket_takes_max_len(model):
    """A 70-token prompt under max_len 96: the 256 bucket cannot hold it,
    so it prefills at max_len and still matches JAX's greedy decode."""
    jparams, tparams = model
    prompt = list(np.random.default_rng(6).integers(1, 96, 70))
    eng = tengine.GenerationEngine(tparams, TCFG, max_slots=2, max_len=96,
                                   device=CPU)
    eng.submit("long", prompt, max_new_tokens=8)
    assert eng.run_to_completion()["long"] == _jref(jparams, prompt, 8)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.7, 5, 1.0), (1.0, 0, 0.6), (0.5, 8, 0.9), (1.3, 3, 0.5),
])
def test_pick_token_masks_match_jax(temp, top_k, top_p):
    """JAX's ``_pick_token`` samples exactly the tokens the port's mask
    keeps: each kept token has probability > 2e-3 under the mask, so 4096
    draws reach all of them."""
    logits = np.random.default_rng(4).standard_normal(64).astype(
        np.float32) * 3
    scaled, keep = tengine._keep_mask(
        torch.from_numpy(logits)[None], torch.tensor([temp]),
        torch.tensor([top_k]), torch.tensor([top_p]))
    probs = torch.softmax(torch.where(keep, scaled, -1e30), -1)[0]
    kept = set(torch.nonzero(keep[0]).flatten().tolist())
    assert float(probs[sorted(kept)].min()) > 2e-3
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    draws = jax.vmap(lambda k: jengine._pick_token(
        jnp.asarray(logits), jnp.float32(temp), jnp.int32(top_k),
        jnp.float32(top_p), k))(keys)
    assert set(np.asarray(draws).tolist()) == kept
    gens = [torch.Generator().manual_seed(0)]
    assert int(tengine._pick_token(torch.from_numpy(logits)[None], [0.0],
                                   [top_k], [top_p], gens)[0]) == \
        int(jengine._pick_token(jnp.asarray(logits), jnp.float32(0.0),
                                jnp.int32(top_k), jnp.float32(top_p),
                                keys[0]))
    tok = int(tengine._pick_token(torch.from_numpy(logits)[None], [temp],
                                  [top_k], [top_p], gens)[0])
    assert tok in kept


# --------------------------------------------------------------- server

def _server(tparams, **kw):
    return tllm.LLMServer(lambda: (tparams, TCFG), max_slots=3, max_len=96,
                          device=CPU, **kw)


def test_server_unary_streaming_and_concurrent(model):
    jparams, tparams = model
    srv = _server(tparams)
    events.reset()

    async def run():
        unary = await srv({"prompt": [1, 2, 3], "max_new_tokens": 10})
        reqs = {"a": ([4, 5, 6, 7], 8), "b": ([9], 12), "c": ([11, 12], 5)}
        outs = await asyncio.gather(*[
            srv({"prompt": p, "max_new_tokens": n})
            for p, n in reqs.values()])
        stream = await srv({"prompt": [20, 21, 22], "max_new_tokens": 6,
                            "stream": True})
        streamed = [t async for t in stream]
        return unary, dict(zip(reqs, outs)), reqs, streamed

    unary, outs, reqs, streamed = asyncio.run(run())
    assert unary == {"tokens": _jref(jparams, [1, 2, 3], 10),
                     "num_tokens": 10}
    for rid, (p, n) in reqs.items():
        assert outs[rid]["tokens"] == _jref(jparams, p, n), rid
    assert streamed == _jref(jparams, [20, 21, 22], 6)
    rows, dropped = events.drain()
    names = [r[1] for r in rows]
    assert names.count("serve.req.queue") == 5
    assert names.count("serve.req.first_token") == 5
    assert names.count("serve.req.tokens_done") == 4
    assert not dropped
    stats = srv._admin({"_admin": "stats"})
    assert (stats["weights_version"], stats["active_requests"],
            stats["spec_requests"]) == (1, 0, 0)


def test_server_rejected_submit_leaks_no_queue(model):
    _, tparams = model
    srv = _server(tparams)

    async def run():
        with pytest.raises(ValueError, match="exceeds engine max_len"):
            await srv({"prompt": list(range(60)), "max_new_tokens": 60})
        return await srv({"prompt": [3, 4], "max_new_tokens": 3})

    assert asyncio.run(run())["num_tokens"] == 3
    assert srv._queues == {}


def test_server_failed_step_raises_in_every_request(model):
    jparams, tparams = model
    srv = _server(tparams)

    def broken_step():
        raise RuntimeError("flash_fwd failed to launch")

    async def run():
        srv.engine.step = broken_step
        stream = await srv({"prompt": [20, 21], "max_new_tokens": 4,
                            "stream": True})

        async def drain():
            return [t async for t in stream]

        res = await asyncio.wait_for(asyncio.gather(
            srv({"prompt": [1, 2, 3], "max_new_tokens": 5}),
            srv({"prompt": [4], "max_new_tokens": 5}),
            drain(), return_exceptions=True), timeout=30)
        del srv.engine.step  # the engine's own step again
        after = await asyncio.wait_for(
            srv({"prompt": [1, 2, 3], "max_new_tokens": 5}), timeout=30)
        return res, after

    res, after = asyncio.run(run())
    assert len(res) == 3
    for r in res:
        assert isinstance(r, RuntimeError) and "launch" in str(r), r
    assert srv._queues == {} and not srv.engine.has_work()
    assert after["tokens"] == _jref(jparams, [1, 2, 3], 5)


def test_server_reconfigure_swaps_weights(model):
    _, tparams = model
    srv = _server(tparams)
    jnew = jllama.init_params(JCFG, jax.random.PRNGKey(9))
    srv.reconfigure({"weights": params_from_numpy(to_numpy(jnew),
                                                  device=CPU)})
    got = asyncio.run(srv({"prompt": [1, 2, 3], "max_new_tokens": 6}))
    assert got["tokens"] == jllama.generate_greedy(
        jnew, jnp.asarray([[1, 2, 3]], jnp.int32), JCFG, max_new=6)[0].tolist()
    assert srv._admin({"_admin": "stats"})["weights_version"] == 2


def test_server_refuses_an_unknown_kv_cache(model):
    """The dense and paged caches are the only ones; the Serve app and the
    refresh over the object plane are tested in test_torch_serve.py."""
    _, tparams = model
    with pytest.raises(ValueError, match="kv_cache"):
        _server(tparams, kv_cache="ring")


def _draft(p, c):
    from ray_tpu_torch.models.speculative import truncated_draft

    return truncated_draft(p, c, 1)


SERVE_REQS = {"a": ([4, 5, 6, 7], 8), "b": ([9], 12), "c": ([11, 12], 5),
              "d": (list(range(30, 43)), 6)}


async def _serve_mix(srv, speculative=False):
    """A unary request, four concurrent ones and a streamed one."""
    extra = {"speculative": True} if speculative else {}
    unary = await srv({"prompt": [1, 2, 3], "max_new_tokens": 10, **extra})
    outs = await asyncio.gather(*[
        srv({"prompt": p, "max_new_tokens": n, **extra})
        for p, n in SERVE_REQS.values()])
    if speculative:
        return unary, dict(zip(SERVE_REQS, outs)), None
    stream = await srv({"prompt": [20, 21, 22], "max_new_tokens": 6,
                        "stream": True})
    return unary, dict(zip(SERVE_REQS, outs)), [t async for t in stream]


@pytest.fixture(scope="module")
def dense_served(model):
    _, tparams = model
    return asyncio.run(_serve_mix(_server(tparams)))


@pytest.mark.parametrize("kw", [
    dict(kv_cache="paged", num_pages=24, page_size=8),
    dict(kv_cache="paged", num_pages=8, page_size=4,
         enable_prefix_cache=True),
], ids=["paged", "paged_prefix_preempting"])
def test_paged_server_matches_dense_server(model, dense_served, kw):
    """Unary, concurrent and streamed requests through a PagedEngine give
    the dense server's tokens. The second pool is small enough to preempt
    in flight, and the preempted request's resume hits its own prompt
    pages in the prefix cache."""
    jparams, tparams = model
    srv = _server(tparams, **kw)
    assert isinstance(srv.engine, tpaged.PagedEngine)
    unary, outs, streamed = asyncio.run(_serve_mix(srv))
    d_unary, d_outs, d_streamed = dense_served
    assert unary == d_unary == {"tokens": _jref(jparams, [1, 2, 3], 10),
                                "num_tokens": 10}
    assert outs == d_outs and streamed == d_streamed
    assert srv.engine.prefills >= 6 and not srv.engine.has_work()
    small = kw["num_pages"] == 8
    assert (srv.engine.preemptions > 0) == small
    assert (srv.engine.prefix_hits > 0) == small


def test_speculative_server_matches_dense_server(model, dense_served):
    """{"speculative": true} requests, one alone and four at once, give the
    dense server's tokens with the round stats; a request the caches
    cannot hold and a server without a draft raise ValueError."""
    _, tparams = model
    srv = _server(tparams, draft_factory=_draft, draft_k=3)
    unary, outs, _ = asyncio.run(_serve_mix(srv, speculative=True))
    d_unary, d_outs, _ = dense_served
    assert unary["tokens"] == d_unary["tokens"]
    assert {r: o["tokens"] for r, o in outs.items()} == \
        {r: o["tokens"] for r, o in d_outs.items()}
    stats = [unary["speculative_stats"]] + \
        [o["speculative_stats"] for o in outs.values()]
    assert all(s["host_fetches"] == s["rounds"] + 1 for s in stats)
    adm = srv._admin({"_admin": "stats"})
    assert adm["spec_requests"] == 5 and adm["spec_inflight"] == 0
    assert 1 <= adm["spec_inflight_peak"] <= adm["spec_admission_bound"] == 3
    assert adm["spec_rounds"] == sum(s["rounds"] for s in stats)
    assert adm["spec_drafted"] == 3 * adm["spec_rounds"]
    assert adm["spec_accepted"] == sum(s["accepted"] for s in stats)
    k1 = asyncio.run(srv({"prompt": [1, 2, 3], "max_new_tokens": 10,
                          "speculative": True, "k": 1}))
    assert k1["tokens"] == d_unary["tokens"]
    assert k1["speculative_stats"]["drafted"] == \
        k1["speculative_stats"]["rounds"]
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        asyncio.run(srv({"prompt": list(range(81)), "max_new_tokens": 12,
                         "speculative": True}))
    with pytest.raises(ValueError, match="no draft_factory"):
        asyncio.run(_server(tparams)({"prompt": [1], "speculative": True}))


def test_admin_stats_keys_match_the_reference(model):
    from ray_tpu.serve import llm as jllm

    jparams, tparams = model
    jsrv = jllm.LLMServer(lambda: (jparams, JCFG), max_slots=3, max_len=96)
    want = jsrv._admin({"_admin": "stats"})
    for kw in ({}, {"kv_cache": "paged", "draft_factory": _draft}):
        got = _server(tparams, **kw)._admin({"_admin": "stats"})
        assert got == want


def test_reconfigure_invalidates_the_prefix_cache(model):
    """After a weight swap a prompt with a cached prefix cannot hit pages
    computed with the old weights, and the draft follows the new weights."""
    _, tparams = model
    srv = _server(tparams, kv_cache="paged", num_pages=24, page_size=4,
                  enable_prefix_cache=True, draft_factory=_draft)
    prompt = list(range(40, 52)) + [7]   # 3 full pages
    asyncio.run(srv({"prompt": prompt, "max_new_tokens": 4}))
    assert srv.engine._prefix and srv.engine.prefix_misses == 1
    jnew = jllama.init_params(JCFG, jax.random.PRNGKey(9))
    srv.reconfigure({"weights": params_from_numpy(to_numpy(jnew),
                                                  device=CPU)})
    assert not srv.engine._prefix
    got = asyncio.run(srv({"prompt": prompt, "max_new_tokens": 6}))
    want = jllama.generate_greedy(jnew, jnp.asarray([prompt], jnp.int32),
                                  JCFG, max_new=6)[0].tolist()
    assert got["tokens"] == want
    assert srv.engine.prefix_hits == 0 and srv.engine.prefix_misses == 2
    spec = asyncio.run(srv({"prompt": prompt, "max_new_tokens": 6,
                            "speculative": True}))
    assert spec["tokens"] == want
    assert srv._spec[0] is srv.engine.params
    assert srv._admin({"_admin": "stats"})["weights_version"] == 2


def test_paged_server_failed_step_frees_every_page(model):
    """A failed step on the paged server raises in every waiting request
    and returns every page its slots held; the next request is served."""
    jparams, tparams = model
    srv = _server(tparams, kv_cache="paged", num_pages=24, page_size=8)
    eng = srv.engine

    def broken_step():
        eng._admit()  # pages are taken, then the step fails
        raise RuntimeError("flash_fwd failed to launch")

    async def run():
        eng.step = broken_step
        res = await asyncio.wait_for(asyncio.gather(
            srv({"prompt": list(range(1, 12)), "max_new_tokens": 5}),
            srv({"prompt": [4], "max_new_tokens": 5}),
            return_exceptions=True), timeout=30)
        del eng.step
        return res, await asyncio.wait_for(
            srv({"prompt": [1, 2, 3], "max_new_tokens": 5}), timeout=30)

    res, after = asyncio.run(run())
    assert all(isinstance(r, RuntimeError) for r in res), res
    assert after["tokens"] == _jref(jparams, [1, 2, 3], 5)
    idle = [e[0] for e in eng._prefix.values() if e[1] == 0]
    assert sorted(eng.free_pages + idle) == list(range(1, 24))
    assert srv._queues == {} and not eng.has_work()
