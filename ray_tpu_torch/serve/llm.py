"""LLM serving: one continuous-batching engine behind an async handler.

Port of ``ray_tpu/serve/llm.py``. Unary calls get the full token list,
streaming calls get tokens as the engine emits them, and concurrent
requests share every decode step through one engine pump. What needs the
runtime tier (a Serve deployment, the object plane) or a later model
slice (the paged cache, speculative decoding) raises
``NotImplementedError`` until it is ported.
"""

from __future__ import annotations

import asyncio
import threading
import time
import uuid
from typing import Any, Dict, Optional

import torch

from ..models.engine import GenerationEngine
from ..ops.quant import Q8
from ..util import events as plane_events


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, Q8):
        return Q8(tree.w.to(device), tree.s.to(device))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    raise TypeError(f"unsupported weight leaf {type(tree)}")


class LLMServer:
    """Async callable hosting one :class:`GenerationEngine`.

    ``model_factory() -> (params, cfg)`` builds the weights on ``device``.
    Requests: ``{"prompt": [token ids], "max_new_tokens": n, "eos_id":
    optional, "temperature", "top_k", "top_p", "seed", "stream": bool}``.
    """

    def __init__(self, model_factory, *, max_slots: int = 4,
                 max_len: int = 512, kv_cache: str = "dense",
                 draft_factory=None, device=None):
        if kv_cache == "paged":
            raise NotImplementedError(
                "kv_cache='paged' waits for the port of models/paged.py "
                "(ROADMAP A2)")
        if kv_cache != "dense":
            raise ValueError(f"kv_cache must be 'dense' or 'paged', "
                             f"got {kv_cache!r}")
        if draft_factory is not None:
            raise NotImplementedError(
                "speculative decoding waits for the port of "
                "models/speculative.py (ROADMAP A2)")
        params, cfg = model_factory()
        self.engine = GenerationEngine(params, cfg, max_slots=max_slots,
                                       max_len=max_len, device=device)
        self._weights_version = 1
        self._queues: Dict[str, asyncio.Queue] = {}
        self._loop_task: Optional[asyncio.Task] = None
        # Serializes engine steps (in an executor thread) against a weight
        # swap from another thread: the swap lands between steps.
        self._engine_lock = threading.Lock()

    # ----------------------------------------------------- engine pump
    def _ensure_loop(self):
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._engine_loop())

    def _locked_step(self):
        with self._engine_lock:
            return self.engine.step()

    async def _engine_loop(self):
        loop = asyncio.get_running_loop()
        while self.engine.has_work():
            # The step is device-bound; run it off the event loop so new
            # submissions stay responsive.
            try:
                events = await loop.run_in_executor(None, self._locked_step)
            except Exception as e:
                self._fail_all(e)
                return
            for rid, tok in events:
                q = self._queues.get(rid)
                if q is not None:
                    q.put_nowait(tok)
            await asyncio.sleep(0)

    def _fail_all(self, err: Exception) -> None:
        """A failed step leaves the engine's slots in no known state: drop
        every request and hand the error to each waiting handler, which
        raises it instead of waiting for tokens that never come."""
        with self._engine_lock:
            self.engine.drop_all()
        for q in self._queues.values():
            q.put_nowait(err)

    def _submit(self, body: dict) -> str:
        rid = uuid.uuid4().hex
        self._queues[rid] = asyncio.Queue()
        plane_events.emit("serve.req.queue", plane="serve",
                          tenant=str(body.get("tenant") or ""),
                          rid=rid[:8], prompt_len=len(body["prompt"]),
                          weights_version=self._weights_version,
                          queued=len(self._queues))
        try:
            self.engine.submit(rid, [int(t) for t in body["prompt"]],
                               max_new_tokens=int(
                                   body.get("max_new_tokens", 32)),
                               eos_id=body.get("eos_id"),
                               temperature=float(
                                   body.get("temperature", 0.0)),
                               top_k=int(body.get("top_k", 0)),
                               top_p=float(body.get("top_p", 1.0)),
                               seed=body.get("seed"))
        except Exception:
            # A rejected submit (bad prompt, over max_len) must not
            # strand its freshly-inserted queue entry forever.
            self._queues.pop(rid, None)
            raise
        self._ensure_loop()
        return rid

    # ------------------------------------------------------- handlers
    async def __call__(self, body: dict):
        if not isinstance(body, dict):
            raise TypeError(f"a request is a dict, got {type(body)}")
        if body.get("_admin"):
            return self._admin(body)
        if body.get("speculative"):
            raise NotImplementedError(
                "speculative requests wait for the port of "
                "models/speculative.py (ROADMAP A2)")
        if body.get("stream"):
            return self._stream(body)
        t0 = time.time()
        tenant = str(body.get("tenant") or "")
        rid = self._submit(body)
        q = self._queues[rid]
        toks = []
        try:
            while True:
                tok = await q.get()
                if isinstance(tok, Exception):
                    raise tok
                if tok is None:
                    break
                if not toks:
                    plane_events.emit(
                        "serve.req.first_token", plane="serve",
                        tenant=tenant, rid=rid[:8],
                        weights_version=self._weights_version,
                        dur=time.time() - t0)
                toks.append(tok)
        finally:
            self._queues.pop(rid, None)
        plane_events.emit("serve.req.tokens_done", plane="serve",
                          tenant=tenant, rid=rid[:8],
                          weights_version=self._weights_version,
                          tokens=len(toks), dur=time.time() - t0)
        return {"tokens": toks, "num_tokens": len(toks)}

    async def _stream(self, body: dict):
        t0 = time.time()
        rid = self._submit(body)
        q = self._queues[rid]
        first = True
        try:
            while True:
                tok = await q.get()
                if isinstance(tok, Exception):
                    raise tok
                if tok is None:
                    return
                if first:
                    first = False
                    plane_events.emit(
                        "serve.req.first_token", plane="serve",
                        tenant=str(body.get("tenant") or ""),
                        rid=rid[:8],
                        weights_version=self._weights_version,
                        dur=time.time() - t0)
                yield tok
        finally:
            self._queues.pop(rid, None)

    # ------------------------------------------- admin / weight refresh
    def _admin(self, body: dict):
        op = body["_admin"]
        if op == "stats":
            return {"weights_version": self._weights_version,
                    "active_requests": len(self._queues)}
        raise ValueError(f"unknown _admin op {op!r}")

    def reconfigure(self, user_config) -> None:
        """Live weight refresh: ``{"weights": tree}`` swaps the engine's
        parameters between two steps without dropping in-flight
        requests; it waits for a running step, so call it off the event
        loop while requests are in flight. ``weights_ref`` needs the
        object plane and raises."""
        if not isinstance(user_config, dict):
            return
        if user_config.get("weights_ref") is not None:
            raise NotImplementedError(
                "weights_ref needs the object plane, which waits for the "
                "runtime tier's port (ROADMAP R2)")
        params = user_config.get("weights")
        if params is None:
            return
        params = _to_device(params, self.engine.device)
        with self._engine_lock:
            self.engine.params = params
            self._weights_version += 1


def build_llm_app(model_factory, **kwargs):
    """A Serve deployment around :class:`LLMServer`; needs the Serve
    runtime, which waits for the runtime tier's port."""
    raise NotImplementedError(
        "build_llm_app needs the Serve runtime, which waits for the "
        "runtime tier's port (ROADMAP R1)")
