"""Parity of the PyTorch port's paged KV engine (ray_tpu_torch.models.paged)
with the JAX package's, on the CPU in fp32.

The model is the JAX paged tests' (vocab 96, d_model 64, 2 layers, 4/2
heads, d_ff 128); weights come from the JAX ``init_params`` through
``params_from_numpy``. Greedy tokens must be identical to JAX's
``PagedEngine`` and to the port's ``generate_greedy``; the page
bookkeeping (free-page lists in order, prefix hits and misses) must equal
JAX's, step for step. int8 values of ``_quant_kv`` are held exactly and
their scales at 1e-6 relative: both divide the same fp32 amax by 127.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import paged as jpaged
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import paged as tpaged
from ray_tpu_torch.models.convert import params_from_numpy

CPU = "cpu"
JCFG = jllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=jnp.float32)
TCFG = tllama.LlamaConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=128,
                          dtype=torch.float32)

# test_paged_matches_greedy's requests: "b" finishes early and frees its
# slot, "d" is admitted once one frees.
REQS = {"a": ([1, 2, 3, 4], 12), "b": ([7, 8], 5),
        "c": ([10, 11, 12, 13, 14, 15], 9), "d": ([20, 21], 7)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small: the suite runs files in
    parallel workers, beside timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jparams = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device=CPU)


_GREEDY = {}


def _greedy(tparams, prompt, n):
    """The port's generate_greedy, cached per (prompt, n)."""
    key = (tuple(prompt), n)
    if key not in _GREEDY:
        _GREEDY[key] = tllama.generate_greedy(
            tparams, torch.tensor([prompt]), TCFG, max_new=n)[0].tolist()
    return _GREEDY[key]


def _all_pages_back(eng):
    """Every page but the scratch page 0 is free or held by an idle
    prefix entry: as in JAX, full prompt pages are registered even with
    the prefix cache off, and stay resident until ``_reclaim`` evicts
    them."""
    idle = [e[0] for e in eng._prefix.values() if e[1] == 0]
    assert all(e[1] == 0 for e in eng._prefix.values())
    assert sorted(eng.free_pages + idle) == list(range(1, eng.num_pages))


def _engines(model, **kw):
    jparams, tparams = model
    return (jpaged.PagedEngine(jparams, JCFG, **kw),
            tpaged.PagedEngine(tparams, TCFG, device=CPU, **kw))


def _run_both(jeng, teng, reqs, **submit_kw):
    """Submit ``reqs`` to both engines and step them side by side: each
    step's events, free-page list and prefix counters must agree."""
    for rid, (p, n) in reqs.items():
        jeng.submit(rid, p, max_new_tokens=n, **submit_kw)
        teng.submit(rid, p, max_new_tokens=n, **submit_kw)
    out, acc = {}, {}
    while jeng.has_work() or teng.has_work():
        jev, tev = jeng.step(), teng.step()
        assert tev == jev
        assert teng.free_pages == jeng.free_pages
        assert (teng.prefix_hits, teng.prefix_misses) == \
            (jeng.prefix_hits, jeng.prefix_misses)
        for rid, tok in tev:
            if tok is None:
                out[rid] = acc.pop(rid, [])
            else:
                acc.setdefault(rid, []).append(tok)
    return out


# ------------------------------------------------------------ _quant_kv

@pytest.mark.parametrize("shape", [(4, 2, 16), (3, 8, 2, 16)])
def test_quant_kv_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    vec = (rng.standard_normal(shape) * 3).astype(np.float32)
    rows = vec.reshape(-1, shape[-1])     # a view: head vectors as rows
    rows[1] = 0.0                         # a zero vector: scale 1
    # a vector whose amax is 127: scale 1, so x.5 values round half to even
    rows[2] = np.linspace(-127, 127, shape[-1])
    rows[2, :3] = [2.5, -3.5, 0.5]
    jq, js = jpaged._quant_kv(jnp.asarray(vec))
    tq, ts = tpaged._quant_kv(torch.from_numpy(vec))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    tq, ts = tq.reshape(-1, shape[-1]), ts.reshape(-1)
    assert float(ts[1]) == 1.0 and not tq[1].any()
    assert float(ts[2]) == 1.0 and tq[2, :3].tolist() == [2, -4, 0]


# ---------------------------------------------------------------- tokens

@pytest.mark.parametrize("kw", [
    dict(max_slots=3, num_pages=24, page_size=8, max_len=64),
    dict(max_slots=2, num_pages=16, page_size=4, max_len=32),
    dict(max_slots=8, num_pages=11, page_size=4, max_len=32),
], ids=["pages8", "pages4", "shared_pool"])
def test_paged_tokens_match_jax_and_greedy(model, kw):
    """Greedy tokens equal JAX's PagedEngine's and the port's
    generate_greedy, and every page comes back (page 0 stays reserved)."""
    _, tparams = model
    jeng, teng = _engines(model, **kw)
    got = _run_both(jeng, teng, REQS)
    for rid, (p, n) in REQS.items():
        assert got[rid] == _greedy(tparams, p, n), rid
    _all_pages_back(teng)
    assert teng.prefills == len(REQS) and teng.preemptions == 0


def test_pages_allocated_on_demand(model):
    _, tparams = model
    eng = tpaged.PagedEngine(tparams, TCFG, max_slots=2, num_pages=16,
                             page_size=4, max_len=32, device=CPU)
    eng.submit("x", [1, 2, 3], max_new_tokens=10)
    held = []
    while eng.has_work():
        eng.step()
        held += [len(s.pages) for s in eng.slots if s is not None]
    # 3 prompt positions and 9 decode writes (the last token is never fed
    # back): 1 page at admission, 3 at most
    assert held[0] == 1 and max(held) == 3
    _all_pages_back(eng)


def test_preemption_by_recompute_matches_jax(model):
    """A pool of 5 usable pages for three requests that need 13 at their
    peak: requests are preempted in flight, requeued with prompt + emitted
    tokens, and still give JAX's and generate_greedy's tokens."""
    _, tparams = model
    jeng, teng = _engines(model, max_slots=3, num_pages=6, page_size=4,
                          max_len=32)
    got = _run_both(jeng, teng, REQS)
    assert teng.preemptions > 0
    for rid, (p, n) in REQS.items():
        assert got[rid] == _greedy(tparams, p, n), rid
    _all_pages_back(teng)


def test_submit_rejects_what_cannot_fit(model):
    _, tparams = model
    eng = tpaged.PagedEngine(tparams, TCFG, max_slots=2, num_pages=4,
                             page_size=4, max_len=32, device=CPU)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit("big", list(range(20)), max_new_tokens=12)
    with pytest.raises(ValueError, match="pages than the pool"):
        eng.submit("wide", list(range(10)), max_new_tokens=8)
    with pytest.raises(ValueError, match="kv_dtype"):
        tpaged.PagedEngine(tparams, TCFG, kv_dtype="fp4", device=CPU)


# ---------------------------------------------------------- prefix cache

def test_prefix_cache_hits_and_parity(model):
    _, tparams = model
    jeng, teng = _engines(model, max_slots=2, num_pages=32, page_size=4,
                          max_len=64, enable_prefix_cache=True)
    prefix = list(range(1, 13))  # 12 tokens = 3 full pages
    got_a = _run_both(jeng, teng, {"a": (prefix + [20], 6)})["a"]
    assert (teng.prefix_hits, teng.prefix_misses) == (0, 1)
    got_b = _run_both(jeng, teng, {"b": (prefix + [30, 31], 6)})["b"]
    assert (teng.prefix_hits, teng.prefix_misses) == (1, 1)
    assert teng.prefills == 2
    assert got_a == _greedy(tparams, prefix + [20], 6)
    assert got_b == _greedy(tparams, prefix + [30, 31], 6)


def test_prefix_cache_eviction_under_pressure(model):
    """Distinct prefixes into 7 usable pages: least recently used idle
    prefix pages are evicted to keep admitting, as in JAX."""
    _, tparams = model
    jeng, teng = _engines(model, max_slots=1, num_pages=8, page_size=4,
                          max_len=32, enable_prefix_cache=True)
    for i in range(4):
        p = [40 + i] * 8 + [3]  # 2 full pages each
        assert _run_both(jeng, teng, {f"p{i}": (p, 3)})[f"p{i}"] == \
            _greedy(tparams, p, 3), i
    assert len(teng._prefix) < 8
    assert list(teng._prefix) == list(jeng._prefix)
    assert teng._prefix_lru == jeng._prefix_lru


def test_shared_pages_not_freed_while_borrowed(model):
    _, tparams = model
    jeng, teng = _engines(model, max_slots=2, num_pages=32, page_size=4,
                          max_len=64, enable_prefix_cache=True)
    prefix = list(range(50, 58))  # 2 full pages
    for rid, tok, n in (("x", 1, 12), ("y", 2, 3)):
        jeng.submit(rid, prefix + [tok], max_new_tokens=n)
        teng.submit(rid, prefix + [tok], max_new_tokens=n)
    shared = None
    got, acc = {}, {}
    while teng.has_work():
        jev, events = jeng.step(), teng.step()
        assert events == jev
        assert teng.free_pages == jeng.free_pages
        for rid, tok in events:
            if tok is None:
                got[rid] = acc.pop(rid)
            else:
                acc.setdefault(rid, []).append(tok)
        live = [s for s in teng.slots if s is not None]
        if len(live) == 2:  # y borrows x's prefix pages
            assert live[0].pages[:2] == live[1].pages[:2]
            shared = live[0].pages[:2]
        if shared and "y" in got and "x" not in got:
            # y finished; x still holds the pages, which stay out of the pool
            assert not set(shared) & set(teng.free_pages)
    assert teng.prefix_hits == 1
    assert got["x"] == _greedy(tparams, prefix + [1], 12)
    assert got["y"] == _greedy(tparams, prefix + [2], 3)
    assert all(e[1] == 0 for e in teng._prefix.values())


def test_invalidate_prefix_cache(model):
    """After invalidation no prompt hits; idle pages return to the pool at
    once, pages a running slot borrows only when it drains."""
    jeng, teng = _engines(model, max_slots=2, num_pages=32, page_size=4,
                          max_len=64, enable_prefix_cache=True)
    prefix = list(range(60, 68))
    _run_both(jeng, teng, {"a": (prefix + [1], 4)})
    for eng in (jeng, teng):
        eng.submit("b", prefix + [2], max_new_tokens=6)
        eng.step()                        # b admitted, borrowing 2 pages
        eng.invalidate_prefix_cache()
    assert teng.free_pages == jeng.free_pages
    assert list(teng._prefix) == list(jeng._prefix)
    assert all(k[0] == "__stale__" for k in teng._prefix)
    got = _run_both(jeng, teng, {"c": (prefix + [3], 4)})
    assert teng.prefix_hits == 1 and teng.prefix_misses == 2
    assert got["c"] == _greedy(model[1], prefix + [3], 4)


# ----------------------------------------------------------------- int8

def test_int8_kv_matches_jax(model):
    """int8 KV: tokens equal JAX's int8 engine's, agree with the model
    dtype's at >= 0.6 (the JAX package's rule), and the pools are int8."""
    _, tparams = model
    jeng, teng = _engines(model, max_slots=2, num_pages=24, page_size=4,
                          max_len=64, kv_dtype="int8")
    got = _run_both(jeng, teng, {"q": ([5, 6, 7, 8], 10)})["q"]
    ref = _greedy(tparams, [5, 6, 7, 8], 10)
    assert len(got) == 10
    assert sum(a == b for a, b in zip(got, ref)) / 10 >= 0.6, (got, ref)
    assert teng.pools_k[0].dtype == torch.int8
    assert teng.scales_k[0].shape == (24, 4, TCFG.n_kv_heads)


def test_int8_kv_with_prefix_cache(model):
    """The cached-prefix path over int8 pages reproduces the cold run."""
    jeng, teng = _engines(model, max_slots=2, num_pages=32, page_size=4,
                          max_len=64, kv_dtype="int8",
                          enable_prefix_cache=True)
    prefix = list(range(60, 68))
    got_a = _run_both(jeng, teng, {"a": (prefix + [1], 6)})["a"]
    got_b = _run_both(jeng, teng, {"b": (prefix + [1], 6)})["b"]
    assert got_a == got_b and teng.prefix_hits == 1


# -------------------------------------------------------------- sampling

def _sampled(tparams, num_pages, seed):
    eng = tpaged.PagedEngine(tparams, TCFG, max_slots=3,
                             num_pages=num_pages, page_size=4, max_len=32,
                             device=CPU)
    for rid, (p, n) in REQS.items():
        eng.submit(rid, p, max_new_tokens=n, temperature=0.8, top_k=12,
                   seed=seed)
    return eng.run_to_completion(), eng.preemptions


def test_seeded_sampling_resumes_across_preemption(model):
    """Seeded sampling is reproducible, and a request preempted by
    recompute resumes its generator's stream: the tokens equal those of a
    pool large enough to never preempt."""
    _, tparams = model
    roomy, n_roomy = _sampled(tparams, 32, 11)
    again, _ = _sampled(tparams, 32, 11)
    other, _ = _sampled(tparams, 32, 12)
    tight, n_tight = _sampled(tparams, 6, 11)
    assert n_roomy == 0 and n_tight > 0
    assert roomy == again and roomy != other
    assert tight == roomy
    assert {rid: len(t) for rid, t in tight.items()} == \
        {rid: n for rid, (_, n) in REQS.items()}


def test_paged_engine_defaults_to_cuda(model, monkeypatch):
    """Like every entry point of the port, the engine runs on CUDA unless
    the caller names the CPU, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpaged.PagedEngine(model[1], TCFG)
    eng = tpaged.PagedEngine(model[1], TCFG, device=CPU)
    assert eng.pools_k[0].device.type == "cpu"
    assert eng._scratch[0][0].shape == (1, eng.max_len, 2, 16)
