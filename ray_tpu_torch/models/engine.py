"""Continuous-batching generation engine (port of
``ray_tpu/models/engine.py``).

S cache slots share one decode step; requests join and leave between
steps. The JAX engine ``vmap``s a single-sequence step over the slots;
here the slot axis is explicit: one batched ``_decode_step`` whose start
is a [S] tensor of per-slot lengths, writing each slot's new K/V at its
own offset with an in-place index write and masking each slot's keys with
``arange(total) <= length``. Inactive slots still flow through the math
(their outputs are ignored), as in the JAX engine.

A prefill writes the request's K/V in place into its slot's rows of the
engine cache. Keys it leaves stale past the prompt are never read: decode
writes position p before any query can attend it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..ops.layers import rope_frequencies
from .llama import LlamaConfig, _decode_step, new_caches


def _keep_mask(logits: torch.Tensor, temps: torch.Tensor,
               top_ks: torch.Tensor, top_ps: torch.Tensor):
    """Temperature-scaled logits and the top-k / nucleus keep mask for each
    row of ``logits`` [S, V], built from one descending sort. Nucleus keeps
    the tokens whose preceding cumulative mass is < p (always the top
    token); ``top_k <= 0`` turns top-k off."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    scaled = logits / temps.clamp(min=1e-6)[:, None]
    sorted_probs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
    cum = torch.cumsum(sorted_probs, dim=-1)
    k = top_ks[:, None]
    k_mask = torch.where(k > 0, ranks < k, True)
    p_mask = torch.gather(cum - sorted_probs, -1, ranks) < top_ps[:, None]
    return scaled, k_mask & p_mask


def _pick_token(logits: torch.Tensor, temps: Sequence[float],
                top_ks: Sequence[int], top_ps: Sequence[float],
                generators: Sequence[torch.Generator]) -> torch.Tensor:
    """One token per row of ``logits`` [S, V]: greedy where ``temp <= 0``,
    else a draw from row i's generator over the masked, scaled logits."""
    logits = logits.float()
    tokens = logits.argmax(dim=-1)
    rows = [i for i, t in enumerate(temps) if t > 0.0]
    if not rows:
        return tokens
    dev = logits.device
    scaled, keep = _keep_mask(
        logits[rows], torch.tensor([temps[i] for i in rows], device=dev),
        torch.tensor([top_ks[i] for i in rows], device=dev),
        torch.tensor([top_ps[i] for i in rows], device=dev))
    probs = torch.softmax(torch.where(keep, scaled, -1e30), dim=-1)
    for j, i in enumerate(rows):
        tokens[i] = torch.multinomial(probs[j], 1, generator=generators[i])[0]
    return tokens


@torch.no_grad()
def _prefill_one(params, prompt_padded: torch.Tensor, n_valid: int, caches,
                 cfg: LlamaConfig, cos, sin):
    """Prefill one request into ``caches`` (per-layer (k, v) [1, total,
    Hkv, D], written in place). Returns the next-token logits, read at
    position ``n_valid - 1``, and the caches."""
    logits, caches = _decode_step(params, prompt_padded[None], caches, 0,
                                  cfg, cos, sin)
    return logits[0, n_valid - 1], caches


@dataclass
class _Slot:
    request_id: str
    length: int              # tokens currently in the slot's cache
    max_new: int             # emit exactly this many (or stop at eos)
    eos_id: Optional[int]
    emitted: List[int] = field(default_factory=list)
    done: bool = False


class GenerationEngine:
    """Slot-based continuous batching over one model replica.

    ``submit`` enqueues a request; ``step`` advances every active slot one
    token and returns the (request_id, token) events of this step, a token
    of ``None`` marking completion. ``run_to_completion`` drives the loop
    for callers that do not stream. ``params`` must lie on ``device``.
    """

    def __init__(self, params, cfg: LlamaConfig, *, max_slots: int = 4,
                 max_len: int = 512, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.S = max_slots
        self.total = max_len
        self.cos, self.sin = rope_frequencies(cfg.head_dim, max_len,
                                              cfg.rope_theta,
                                              device=self.device)
        self.caches = new_caches(cfg, max_slots, max_len, self.device)
        self.slots: List[Optional[_Slot]] = [None] * self.S
        self.last_tok = np.zeros(self.S, dtype=np.int64)
        self.temps = np.zeros(self.S, dtype=np.float32)   # 0 = greedy
        self.top_ks = np.zeros(self.S, dtype=np.int64)    # 0 = off
        self.top_ps = np.ones(self.S, dtype=np.float32)
        self.generators = [torch.Generator(device=self.device).manual_seed(i)
                           for i in range(self.S)]
        self.pending: List[tuple] = []
        self._admit_events: List[tuple] = []
        #: Prefills run so far (one per admitted request).
        self.prefills = 0
        # one padded prefill shape per bucket, not per prompt length
        self._prefill_buckets = (16, 64, 256)

    # ------------------------------------------------------------ admit
    def submit(self, request_id: str, prompt: List[int], *,
               max_new_tokens: int = 32, eos_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: Optional[int] = None) -> None:
        """``temperature=0`` (default) is greedy; otherwise temperature
        sampling with optional top-k and nucleus top-p, deterministic per
        ``seed``."""
        if len(prompt) + max_new_tokens + 1 > self.total:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({max_new_tokens}) "
                f"exceeds engine max_len {self.total}")
        self.pending.append((request_id, list(prompt), max_new_tokens,
                             eos_id, float(temperature), int(top_k),
                             float(top_p), seed))

    def _admit(self):
        while self.pending and any(s is None for s in self.slots):
            (rid, prompt, max_new, eos_id, temp, top_k, top_p,
             seed) = self.pending.pop(0)
            idx = self.slots.index(None)
            self.temps[idx] = temp
            self.top_ks[idx] = top_k
            self.top_ps[idx] = top_p
            if seed is not None:
                self.generators[idx].manual_seed(seed)
            n = len(prompt)
            # A bucket past max_len would not fit the cache (the JAX
            # engine fails there); such prompts take max_len.
            pad = next((b for b in self._prefill_buckets
                        if n <= b <= self.total), self.total)
            padded = torch.tensor(prompt + [0] * (pad - n),
                                  dtype=torch.long, device=self.device)
            slot_caches = [(kc[idx:idx + 1], vc[idx:idx + 1])
                           for kc, vc in self.caches]
            first_logits, _ = _prefill_one(self.params, padded, n,
                                           slot_caches, self.cfg, self.cos,
                                           self.sin)
            self.prefills += 1
            first = _pick_token(first_logits[None], [temp], [top_k],
                                [top_p], [self.generators[idx]])
            tok = int(first[0])
            slot = _Slot(rid, length=n, max_new=max_new, eos_id=eos_id)
            slot.emitted.append(tok)
            self.last_tok[idx] = tok
            self._admit_events.append((rid, tok))
            if (eos_id is not None and tok == eos_id) or \
                    len(slot.emitted) >= max_new:
                slot.done = True  # reaped by the next step()
            self.slots[idx] = slot

    def _free(self, i: int) -> None:
        self.slots[i] = None
        self.temps[i] = 0.0  # an idle slot draws nothing

    # ------------------------------------------------------------- step
    def step(self) -> List[tuple]:
        """Admit pending, advance active slots one token. Returns the
        (request_id, token) events emitted this step in order; a token of
        ``None`` marks that request's completion."""
        self._admit()
        events: List[tuple] = list(self._admit_events)
        self._admit_events = []
        # reap slots finished at admit time (short max_new / instant eos)
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                events.append((s.request_id, None))
                self._free(i)
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return events
        lengths = torch.tensor([s.length if s else 0 for s in self.slots],
                               dtype=torch.long, device=self.device)
        toks = torch.from_numpy(self.last_tok).to(self.device)[:, None]
        logits, self.caches = _decode_step(self.params, toks, self.caches,
                                           lengths, self.cfg, self.cos,
                                           self.sin)
        out = _pick_token(logits[:, -1], self.temps.tolist(),
                          self.top_ks.tolist(), self.top_ps.tolist(),
                          self.generators).tolist()
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
                self._free(i)
        return events

    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    def drop_all(self) -> List[str]:
        """Forget every pending and active request (after a failed step,
        whose slots are in no known state); returns their ids."""
        rids = [p[0] for p in self.pending]
        rids += [s.request_id for s in self.slots if s is not None]
        self.pending = []
        self._admit_events = []
        for i in range(self.S):
            self._free(i)
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
