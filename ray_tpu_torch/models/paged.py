"""Paged KV cache: on-demand page allocation for the generation engine.

Port of ``ray_tpu/models/paged.py``. K/V live in per-layer pools
``[num_pages, page_size, Hkv, D]`` shared by every sequence, and each
sequence holds a page table, so a request holds only the pages its length
needs and returns them when it finishes. A decode step writes each slot's
new K/V with one indexed store per layer at its (page, offset) and reads
by gathering ``pool[tables]`` into each slot's ``[P * page, Hkv, D]``
view; the attention is the dense engine's masked cache attention.

Pools and tables live on the engine's device; the page bookkeeping (free
list, prefix cache, page tables) stays on the host, as in the JAX engine.
A cold prefill runs the dense engine's ``_prefill_one`` into one scratch
single-sequence cache the engine allocates once (rows it leaves stale past
the prompt are masked, as ``engine._prefill_one``'s note says), so on CUDA
it reaches the flash kernel; a prefix-cache hit runs only the suffix
through the cache attention (``_suffix_prefill``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.layers import apply_rope, rms_norm, rope_frequencies
from ..ops.quant import mm
from .engine import _pick_token, _prefill_one
from .llama import (LlamaConfig, _cache_attention, _decode_step, _head,
                    _mlp_block, new_caches)


def _quant_kv(vec: torch.Tensor):
    """Per-head-vector symmetric int8: vec [..., d] -> (int8 [..., d],
    fp32 scale [...]). A zero vector gets scale 1. ``torch.round``, like
    ``jnp.round``, rounds half to even."""
    v32 = vec.float()
    amax = v32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(v32 / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant(pages: torch.Tensor, scales: torch.Tensor, dtype):
    """int8 pages [..., Hkv, D] times their scales [..., Hkv], in
    ``dtype`` (the JAX engine multiplies in the model dtype)."""
    return pages.to(dtype) * scales[..., None].to(dtype)


@torch.no_grad()
def _paged_step(params, pools_k, pools_v, scales_k, scales_v,
                tables: torch.Tensor, toks: torch.Tensor,
                lengths: torch.Tensor, temps, top_ks, top_ps, generators,
                cfg: LlamaConfig, cos, sin, page: int,
                kv_int8: bool) -> torch.Tensor:
    """One token for every slot against the shared page pools.

    pools_*: per-layer [num_pages, page, Hkv, D], written in place (and
    scales_* [num_pages, page, Hkv] with int8 KV). tables: [S, P] page ids
    per slot on the device; toks, lengths: [S]. Each layer stores the new
    K/V at each slot's (tables[s, length // page], length % page) and
    attends over the gathered pages, keys at positions <= length visible.
    Returns the drawn tokens [S] (``engine._pick_token``)."""
    S, P = tables.shape
    cap = P * page
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    x = params["embedding"][toks].to(cfg.dtype)[:, None, :]     # [S, 1, d]
    positions = lengths[:, None]
    page_idx = tables.gather(1, (lengths // page)[:, None])[:, 0]
    offs = lengths % page
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = mm(h, layer["wq"]).reshape(S, 1, cfg.n_heads, D)
        k = mm(h, layer["wk"]).reshape(S, 1, Hkv, D)
        v = mm(h, layer["wv"]).reshape(S, 1, Hkv, D)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        pool_k, pool_v = pools_k[li], pools_v[li]
        if kv_int8:
            kq, ks = _quant_kv(k[:, 0])
            vq, vs = _quant_kv(v[:, 0])
            pool_k[page_idx, offs] = kq
            pool_v[page_idx, offs] = vq
            scales_k[li][page_idx, offs] = ks
            scales_v[li][page_idx, offs] = vs
            k_seq = _dequant(pool_k[tables], scales_k[li][tables], cfg.dtype)
            v_seq = _dequant(pool_v[tables], scales_v[li][tables], cfg.dtype)
        else:
            pool_k[page_idx, offs] = k[:, 0].to(pool_k.dtype)
            pool_v[page_idx, offs] = v[:, 0].to(pool_v.dtype)
            k_seq, v_seq = pool_k[tables], pool_v[tables]
        o = _cache_attention(q, k_seq.reshape(S, cap, Hkv, D),
                             v_seq.reshape(S, cap, Hkv, D), positions, cfg)
        x = x + mm(o.reshape(S, 1, cfg.n_heads * D), layer["wo"])
        x = x + _mlp_block(layer, x, cfg)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = mm(x[:, 0], _head(params, cfg))                    # [S, V]
    return _pick_token(logits, temps, top_ks, top_ps, generators)


@torch.no_grad()
def _suffix_prefill(params, caches, suffix_padded: torch.Tensor,
                    prefix_len: int, n_valid_total: int, cfg: LlamaConfig,
                    cos, sin):
    """Prefill only the suffix of a prompt whose first ``prefix_len``
    positions are cached: ``caches`` (per-layer (k, v) [1, total, Hkv, D])
    arrive seeded with the prefix K/V, and the suffix runs from position
    ``prefix_len`` through the cache attention. Returns the next-token
    logits at the prompt's end and the caches, written in place."""
    logits, caches = _decode_step(params, suffix_padded[None], caches,
                                  prefix_len, cfg, cos, sin)
    return logits[0, n_valid_total - prefix_len - 1], caches


@dataclass
class _PagedSlot:
    request_id: str
    length: int
    max_new: int
    eos_id: Optional[int]
    prompt: List[int] = field(default_factory=list)   # original prompt
    pages: List[int] = field(default_factory=list)
    n_shared: int = 0        # leading pages borrowed from the prefix cache
    emitted: List[int] = field(default_factory=list)
    done: bool = False


class PagedEngine:
    """``GenerationEngine`` semantics over a shared page pool.

    ``num_pages * page_size`` cache positions are shared by all sequences;
    a request holds ceil(current length / page_size) pages, so admission
    waits for pages, not for a worst-case slot. When the pool runs dry in
    flight, a sequence is preempted by recompute: its pages are freed and
    it is requeued at the head with prompt + emitted tokens and its
    generator's state. ``enable_prefix_cache`` shares the full pages of
    prompt prefixes between requests; ``kv_dtype="int8"`` stores the pages
    quantized per head vector. ``params`` must lie on ``device``.
    """

    def __init__(self, params, cfg: LlamaConfig, *, max_slots: int = 8,
                 num_pages: int = 64, page_size: int = 16,
                 max_len: int = 512, enable_prefix_cache: bool = False,
                 kv_dtype: str = "model", device=None):
        if kv_dtype not in ("model", "int8"):
            raise ValueError("kv_dtype must be 'model' or 'int8'")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.S = max_slots
        self.page = page_size
        self.num_pages = num_pages
        self.P = max_len // page_size           # table width per slot
        self.max_len = self.P * page_size
        self.cos, self.sin = rope_frequencies(cfg.head_dim, self.max_len,
                                              cfg.rope_theta,
                                              device=self.device)
        # int8 pages: per-head-vector scales beside them; tokens are close
        # to the model dtype's, not equal.
        self.kv_int8 = kv_dtype == "int8"
        shape = (num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        pool_dt = torch.int8 if self.kv_int8 else cfg.dtype

        def pools(make):
            return [make() for _ in range(cfg.n_layers)]

        self.pools_k = pools(lambda: torch.zeros(shape, dtype=pool_dt,
                                                 device=self.device))
        self.pools_v = pools(lambda: torch.zeros(shape, dtype=pool_dt,
                                                 device=self.device))
        none = [None] * cfg.n_layers
        self.scales_k = pools(lambda: torch.ones(
            shape[:-1], device=self.device)) if self.kv_int8 else none
        self.scales_v = pools(lambda: torch.ones(
            shape[:-1], device=self.device)) if self.kv_int8 else none
        # The one single-sequence dense cache every prefill writes into.
        self._scratch = new_caches(cfg, 1, self.max_len, self.device)
        # Page 0 is a reserved scratch page: inactive slots still flow
        # through the step and write at tables[i, 0] = 0, offset 0, which
        # must never be a page a live sequence owns. Table padding points
        # at it too; reads past a sequence's length are masked.
        self.free_pages = list(range(1, num_pages))
        self.tables = np.zeros((self.S, self.P), dtype=np.int64)
        self.slots: List[Optional[_PagedSlot]] = [None] * self.S
        self.last_tok = np.zeros(self.S, dtype=np.int64)
        self.temps = np.zeros(self.S, dtype=np.float32)
        self.top_ks = np.zeros(self.S, dtype=np.int64)
        self.top_ps = np.ones(self.S, dtype=np.float32)
        self.generators = [torch.Generator(device=self.device).manual_seed(i)
                           for i in range(self.S)]
        self.pending: List[tuple] = []
        self._admit_events: List[tuple] = []
        #: Prefills run so far (one per admitted request, a suffix
        #: prefill after a prefix hit included).
        self.prefills = 0
        #: Requests preempted by recompute so far.
        self.preemptions = 0
        self._prefill_buckets = (16, 64, 256)
        # Prefix cache: full prompt pages keyed by the prompt up to their
        # end -> [page id, refcount]. Pages with refcount 0 stay resident
        # until pool pressure evicts them, least recently used first.
        self.enable_prefix_cache = enable_prefix_cache
        self._prefix: Dict[tuple, list] = {}
        self._prefix_lru: List[tuple] = []     # keys, oldest first
        self.prefix_hits = 0
        self.prefix_misses = 0

    # ---------------------------------------------------------- pages
    def _pages_needed(self, length: int) -> int:
        return -(-length // self.page)

    def _free(self, slot: _PagedSlot):
        for i, pg in enumerate(slot.pages):
            if i < slot.n_shared:
                self._decref(pg)
            else:
                self.free_pages.append(pg)
        slot.pages = []
        slot.n_shared = 0

    def _decref(self, page: int):
        for entry in self._prefix.values():
            if entry[0] == page:
                entry[1] -= 1
                return
        self.free_pages.append(page)  # its cache entry was evicted

    def _reclaim(self, need: int) -> None:
        """Evict LRU unreferenced prefix pages until ``need`` are free."""
        while len(self.free_pages) < need and self._prefix_lru:
            for key in list(self._prefix_lru):
                entry = self._prefix.get(key)
                if entry is not None and entry[1] == 0:
                    self._prefix.pop(key)
                    self._prefix_lru.remove(key)
                    self.free_pages.append(entry[0])
                    break
            else:
                return  # everything referenced; nothing to evict

    def invalidate_prefix_cache(self) -> None:
        """Drop every cached prefix mapping; needed after a weight swap,
        or later prompts would hit K/V computed with the old weights.
        Unreferenced pages return to the free pool now. Pages still shared
        by running slots keep their entries (for the refcounts) under
        keys no prompt can match, and ``_reclaim`` evicts them once the
        last holder drains."""
        fresh: Dict[tuple, list] = {}
        lru: List[tuple] = []
        for i, key in enumerate(list(self._prefix_lru)):
            entry = self._prefix.get(key)
            if entry is None:
                continue
            if entry[1] == 0:
                self.free_pages.append(entry[0])
            else:
                stale_key = ("__stale__", i, entry[0])
                fresh[stale_key] = entry
                lru.append(stale_key)
        self._prefix = fresh
        self._prefix_lru = lru

    # ---------------------------------------------------------- admit
    def submit(self, request_id: str, prompt: List[int], *,
               max_new_tokens: int = 32, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None) -> None:
        """``temperature=0`` (default) is greedy; otherwise temperature
        sampling with optional top-k and nucleus top-p, deterministic per
        ``seed``."""
        if len(prompt) + max_new_tokens + 1 > self.max_len:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds per-sequence capacity {self.max_len}")
        if self._pages_needed(len(prompt) + max_new_tokens + 1) > \
                self.num_pages - 1:
            raise ValueError(
                "request needs more pages than the pool holds; grow "
                "num_pages or shrink the request")
        self.pending.append((request_id, list(prompt), max_new_tokens,
                             eos_id, float(temperature), int(top_k),
                             float(top_p), seed, None))

    def _prefix_pages(self, n: int) -> int:
        """Full prompt pages that may be cached: never the whole prompt,
        since one suffix token must run for the next-token logits."""
        return min(n // self.page, (n - 1) // self.page)

    def _cached_prefix_pages(self, prompt: List[int]) -> List[int]:
        """The longest run of cached full prompt pages."""
        if not self.enable_prefix_cache:
            return []
        pages: List[int] = []
        for j in range(1, self._prefix_pages(len(prompt)) + 1):
            entry = self._prefix.get(tuple(prompt[:j * self.page]))
            if entry is None:
                break
            pages.append(entry[0])
        return pages

    def _register_prefix_pages(self, slot: _PagedSlot):
        """Put every full prompt page (borrowed or fresh) in the prefix
        cache and pin them through the slot's refcounts."""
        j_max = self._prefix_pages(len(slot.prompt))
        for j in range(1, j_max + 1):
            key = tuple(slot.prompt[:j * self.page])
            entry = self._prefix.get(key)
            if entry is None:
                self._prefix[key] = [slot.pages[j - 1], 1]
                self._prefix_lru.append(key)
            else:
                entry[1] += 1
                self._prefix_lru.remove(key)
                self._prefix_lru.append(key)  # LRU refresh
        slot.n_shared = j_max

    def _prefill(self, prompt: List[int], shared: List[int]):
        """Prefill ``prompt`` into the scratch cache; with ``shared``
        prefix pages, seed the scratch cache with their K/V and run only
        the suffix. Returns the next-token logits."""
        L0 = len(shared) * self.page       # cached prefix length
        suffix = prompt[L0:]
        room = self.max_len - L0
        # A bucket past the cache's end would not fit; such suffixes take
        # the room left.
        pad = next((b for b in self._prefill_buckets
                    if len(suffix) <= b <= room), room)
        padded = torch.tensor(suffix + [0] * (pad - len(suffix)),
                              dtype=torch.long, device=self.device)
        self.prefills += 1
        if not shared:
            logits, _ = _prefill_one(self.params, padded, len(prompt),
                                     self._scratch, self.cfg, self.cos,
                                     self.sin)
            return logits
        tbl = torch.tensor(shared, dtype=torch.long, device=self.device)
        Hkv, D = self.cfg.n_kv_heads, self.cfg.head_dim
        for li, (kc, vc) in enumerate(self._scratch):
            pk, pv = self.pools_k[li][tbl], self.pools_v[li][tbl]
            if self.kv_int8:  # dequantize the borrowed pages
                pk = _dequant(pk, self.scales_k[li][tbl], self.cfg.dtype)
                pv = _dequant(pv, self.scales_v[li][tbl], self.cfg.dtype)
            kc[0, :L0] = pk.reshape(L0, Hkv, D)
            vc[0, :L0] = pv.reshape(L0, Hkv, D)
        logits, _ = _suffix_prefill(self.params, self._scratch, padded, L0,
                                    len(prompt), self.cfg, self.cos,
                                    self.sin)
        return logits

    def _store_pages(self, pages: List[int], first: int) -> None:
        """Copy the scratch cache's rows of ``pages`` (the sequence's
        pages from index ``first`` on) into the pools."""
        own = pages[first:]
        if not own:
            return
        lo, hi = first * self.page, len(pages) * self.page
        idx = torch.tensor(own, dtype=torch.long, device=self.device)
        shape = (len(own), self.page, self.cfg.n_kv_heads,
                 self.cfg.head_dim)
        for li, (kc, vc) in enumerate(self._scratch):
            ks, vs = kc[0, lo:hi].reshape(shape), vc[0, lo:hi].reshape(shape)
            if self.kv_int8:
                kq, ksc = _quant_kv(ks)
                vq, vsc = _quant_kv(vs)
                self.pools_k[li][idx], self.pools_v[li][idx] = kq, vq
                self.scales_k[li][idx], self.scales_v[li][idx] = ksc, vsc
            else:
                self.pools_k[li][idx], self.pools_v[li][idx] = ks, vs

    def _admit(self):
        while self.pending and any(s is None for s in self.slots):
            prompt = self.pending[0][1]
            shared = self._cached_prefix_pages(prompt)
            need = self._pages_needed(len(prompt) + 1) - len(shared)
            self._reclaim(need)
            if need > len(self.free_pages):
                return  # wait for pages, keep FIFO order
            (rid, prompt, max_new, eos_id, temp, top_k, top_p,
             seed, gen_state) = self.pending.pop(0)
            idx = self.slots.index(None)
            self.temps[idx] = temp
            self.top_ks[idx] = top_k
            self.top_ps[idx] = top_p
            if gen_state is not None:   # resuming a preempted request
                self.generators[idx].set_state(gen_state)
            elif seed is not None:
                self.generators[idx].manual_seed(seed)
            slot = _PagedSlot(rid, length=len(prompt), max_new=max_new,
                              eos_id=eos_id, prompt=list(prompt))
            own = [self.free_pages.pop() for _ in range(need)]
            slot.pages = list(shared) + own
            if shared:
                self.prefix_hits += 1
            elif self.enable_prefix_cache:
                self.prefix_misses += 1
            first_logits = self._prefill(prompt, shared)
            self.tables[idx] = 0
            self.tables[idx, :len(slot.pages)] = slot.pages
            # only the slot's own pages: borrowed ones hold their K/V
            self._store_pages(slot.pages, len(shared))
            # As in the JAX engine, full prompt pages are registered even
            # with the prefix cache off (no prompt can then hit them); they
            # stay resident until _reclaim evicts them.
            self._register_prefix_pages(slot)
            tok = int(_pick_token(first_logits[None], [temp], [top_k],
                                  [top_p], [self.generators[idx]])[0])
            slot.emitted.append(tok)
            self.last_tok[idx] = tok
            self._admit_events.append((rid, tok))
            if (eos_id is not None and tok == eos_id) or \
                    len(slot.emitted) >= max_new:
                slot.done = True  # reaped by the next step()
            self.slots[idx] = slot

    def _release(self, i: int) -> None:
        """Free slot ``i``'s pages and point its lane at the scratch
        page; an idle slot draws nothing."""
        self._free(self.slots[i])
        self.slots[i] = None
        self.tables[i] = 0
        self.temps[i] = 0.0

    # ----------------------------------------------------------- step
    def step(self) -> List[tuple]:
        """Admit pending, advance active slots one token. Returns the
        (request_id, token) events emitted this step in order; a token of
        ``None`` marks that request's completion."""
        self._admit()
        events: List[tuple] = list(self._admit_events)
        self._admit_events = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                events.append((s.request_id, None))
                self._release(i)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return events
        # Grow the page tables before the step for slots crossing a page
        # boundary (this step writes at position `length`).
        for i in active:
            s = self.slots[i]
            if s.length % self.page == 0 and \
                    self._pages_needed(s.length + 1) > len(s.pages):
                if not self.free_pages:
                    self._reclaim(1)  # evict idle prefix pages first
                if not self.free_pages:
                    # The pool is exhausted in flight: preempt by
                    # recompute. Free the pages and requeue the request at
                    # the head with prompt + emitted as its prompt, the
                    # budget that remains and its generator's state;
                    # streamed tokens are not emitted again.
                    self.pending.insert(0, (
                        s.request_id, s.prompt + s.emitted,
                        s.max_new - len(s.emitted), s.eos_id,
                        float(self.temps[i]), int(self.top_ks[i]),
                        float(self.top_ps[i]), None,
                        self.generators[i].get_state()))
                    self._release(i)
                    self.preemptions += 1
                    continue
                pg = self.free_pages.pop()
                s.pages.append(pg)
                self.tables[i, len(s.pages) - 1] = pg
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return events
        lengths = torch.tensor([s.length if s else 0 for s in self.slots],
                               dtype=torch.long, device=self.device)
        out = _paged_step(
            self.params, self.pools_k, self.pools_v, self.scales_k,
            self.scales_v, torch.from_numpy(self.tables).to(self.device),
            torch.from_numpy(self.last_tok).to(self.device), lengths,
            self.temps.tolist(), self.top_ks.tolist(), self.top_ps.tolist(),
            self.generators, self.cfg, self.cos, self.sin, self.page,
            self.kv_int8).tolist()
        for i in active:
            s = self.slots[i]
            tok = out[i]
            s.length += 1
            s.emitted.append(tok)
            self.last_tok[i] = tok
            events.append((s.request_id, tok))
            if (s.eos_id is not None and tok == s.eos_id) or \
                    len(s.emitted) >= s.max_new:
                s.done = True
                events.append((s.request_id, None))
                self._release(i)
        return events

    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def drop_all(self) -> List[str]:
        """Forget every pending and active request (after a failed step,
        whose slots are in no known state) and return their pages; returns
        their ids."""
        rids = [p[0] for p in self.pending]
        rids += [s.request_id for s in self.slots if s is not None]
        self.pending = []
        self._admit_events = []
        for i, s in enumerate(self.slots):
            if s is not None:
                self._release(i)
        return rids

    def run_to_completion(self) -> Dict[str, List[int]]:
        """Drive until every submitted request finishes; returns each
        request's full token list."""
        results: Dict[str, List[int]] = {}
        acc: Dict[str, List[int]] = {}
        while self.has_work():
            for rid, tok in self.step():
                if tok is None:
                    results[rid] = acc.pop(rid, [])
                else:
                    acc.setdefault(rid, []).append(tok)
        return results
