"""LLM serving: one continuous-batching engine behind an async handler.

Port of ``ray_tpu/serve/llm.py``. Unary calls get the full token list,
streaming calls get tokens as the engine emits them, and concurrent
requests share every decode step through one engine pump. The engine is
the dense-slot ``GenerationEngine`` or, with ``kv_cache="paged"``, the
page-pool ``PagedEngine``; with a ``draft_factory``, requests that ask for
``{"speculative": true}`` run batch-1 speculative decoding beside it.
``build_llm_app`` wraps it in a Serve deployment, whose replicas can take
new weights over the object plane (``reconfigure({"weights_ref": ref})``).
"""

from __future__ import annotations

import asyncio
import threading
import time
import uuid
from typing import Any, Dict, Optional

import torch

from ..models.engine import GenerationEngine
from ..models.paged import PagedEngine
from ..models.speculative import generate_speculative
from ..ops.quant import Q8
from ..util import events as plane_events
# `serve.deployment` the attribute shadows the submodule; import the
# decorator from the module itself.
from .deployment import deployment as _deployment


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
    """Async callable hosting one engine.

    ``model_factory() -> (params, cfg)`` builds the weights on ``device``.
    Requests: ``{"prompt": [token ids], "max_new_tokens": n, "eos_id":
    optional, "temperature", "top_k", "top_p", "seed", "stream": bool}``,
    or ``{"prompt", "max_new_tokens", "speculative": true, "k": optional}``
    when ``draft_factory(params, cfg) -> (draft_params, draft_cfg)`` is
    given (for example ``lambda p, c: truncated_draft(p, c, n_layers)``).
    ``kv_cache="paged"`` hosts a ``PagedEngine`` with ``num_pages``,
    ``page_size``, ``enable_prefix_cache`` and ``kv_dtype``.
    """

    def __init__(self, model_factory, *, max_slots: int = 4,
                 max_len: int = 512, kv_cache: str = "dense",
                 num_pages: int = 64, page_size: int = 16,
                 enable_prefix_cache: bool = False,
                 kv_dtype: str = "model",
                 draft_factory=None, draft_k: int = 4, device=None):
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f"kv_cache must be 'dense' or 'paged', "
                             f"got {kv_cache!r}")
        params, cfg = model_factory()
        if kv_cache == "paged":
            self.engine = PagedEngine(
                params, cfg, max_slots=max_slots, num_pages=num_pages,
                page_size=page_size, max_len=max_len,
                enable_prefix_cache=enable_prefix_cache, kv_dtype=kv_dtype,
                device=device)
        else:
            self.engine = GenerationEngine(params, cfg, max_slots=max_slots,
                                           max_len=max_len, device=device)
        self._cfg = cfg
        self._max_len = max_len
        self._max_slots = max_slots
        # Speculative decoding: requests that opt in run the batch-1
        # verify-k loop beside the engine, at most max_slots at a time
        # (each holds its own target and draft caches).
        self._draft_factory = draft_factory
        self._spec = None
        if draft_factory is not None:
            self._spec = (params, cfg, *draft_factory(params, cfg), draft_k)
        self._spec_sem: Optional[asyncio.Semaphore] = None
        self._spec_inflight = 0
        self._spec_peak = 0
        self._spec_requests = 0
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._weights_version = 1
        self._queues: Dict[str, asyncio.Queue] = {}
        self._loop_task: Optional[asyncio.Task] = None
        # Serializes engine steps (in an executor thread) against a weight
        # swap from another thread: the swap and the prefix cache's
        # invalidation land between steps, so no admission allocates a
        # page just freed or registers old-weight pages after the wipe.
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

    @staticmethod
    def _body(request: Any) -> dict:
        if isinstance(request, dict):
            return request
        if hasattr(request, "json"):
            return request.json()
        raise TypeError(f"unsupported request: {type(request)}")

    # ------------------------------------------------------- handlers
    async def __call__(self, request: Any):
        body = self._body(request)
        if body.get("_admin"):
            return self._admin(body)
        if body.get("speculative"):
            return await self._speculative(body)
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

    async def _speculative(self, body: dict):
        """Batch-1 speculative decode. The response carries the round
        stats (acceptance rate, tokens per target forward), so callers see
        the draft's real speedup."""
        if self._spec is None:
            raise ValueError(
                "speculative request but no draft_factory configured")
        params, cfg, dparams, dcfg, k = self._spec
        prompt = [int(t) for t in body["prompt"]]
        max_new = int(body.get("max_new_tokens", 32))
        k = int(body.get("k", k))
        # The speculative caches hold prompt + max_new + k + 1 positions.
        total = len(prompt) + max_new + k + 1
        if k < 1 or total > self._max_len:
            raise ValueError(
                f"prompt+max_new_tokens+k+1 = {total} exceeds engine "
                f"max_len {self._max_len} (or k < 1)")
        if self._spec_sem is None:
            self._spec_sem = asyncio.Semaphore(self._max_slots)
        loop = asyncio.get_running_loop()
        async with self._spec_sem:
            self._spec_inflight += 1
            self._spec_peak = max(self._spec_peak, self._spec_inflight)
            try:
                toks, stats = await loop.run_in_executor(
                    None, lambda: generate_speculative(
                        params, dparams,
                        torch.tensor([prompt], device=self.engine.device),
                        cfg, dcfg, max_new=max_new, k=k))
            finally:
                self._spec_inflight -= 1
        self._spec_requests += 1
        self._spec_rounds += stats["rounds"]
        self._spec_drafted += stats["drafted"]
        self._spec_accepted += stats["accepted"]
        out = toks[0].tolist()  # already on the host
        return {"tokens": out, "num_tokens": len(out),
                "speculative_stats": stats}

    # ------------------------------------------- admin / weight refresh
    def _admin(self, body: dict):
        op = body["_admin"]
        if op == "stats":
            return {
                "weights_version": self._weights_version,
                "active_requests": len(self._queues),
                "spec_requests": self._spec_requests,
                "spec_inflight": self._spec_inflight,
                "spec_inflight_peak": self._spec_peak,
                "spec_rounds": self._spec_rounds,
                "spec_drafted": self._spec_drafted,
                "spec_accepted": self._spec_accepted,
                "spec_acceptance_rate":
                    self._spec_accepted / max(self._spec_drafted, 1),
                "spec_admission_bound": self._max_slots,
            }
        raise ValueError(f"unknown _admin op {op!r}")

    def reconfigure(self, user_config):
        """Live weight refresh: ``{"weights": tree}`` or ``{"weights_ref":
        ref}`` (the driver ``put`` s the tree once and each replica fetches
        it over the object plane) swaps the engine's parameters between two
        steps without dropping in-flight requests, drops the paged engine's
        prefix cache (its pages hold K/V of the old weights) and rebuilds
        the speculative draft from the new weights.

        Loop-aware: the controller's fan-out calls this from an executor
        thread, where a blocking fetch is fine; a handle-routed call lands
        on the replica's event loop, where a blocking ``get`` would
        deadlock the loop that must deliver the object, so that path gets
        a coroutine (awaited by the replica) that fetches in the executor.
        """
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return self._refresh_weights(user_config)

        async def _run():
            await asyncio.get_running_loop().run_in_executor(
                None, self._refresh_weights, user_config)

        return _run()

    def _refresh_weights(self, user_config) -> None:
        if not isinstance(user_config, dict):
            return
        params = user_config.get("weights")
        ref = user_config.get("weights_ref")
        if ref is not None:
            import ray_tpu_torch

            params = ray_tpu_torch.get(ref)
        if params is None:
            return
        # A fetched tree is store views on the host: move it to the
        # engine's device once, not once per step.
        params = _to_device(params, self.engine.device)
        with self._engine_lock:
            self.engine.params = params
            if isinstance(self.engine, PagedEngine):
                self.engine.invalidate_prefix_cache()
            self._weights_version += 1
        if self._spec is not None:
            # One tuple rebind: a speculative request reads the old pair or
            # the new one, never a mix.
            self._spec = (params, self._cfg,
                          *self._draft_factory(params, self._cfg),
                          self._spec[4])


def build_llm_app(model_factory, *, max_slots: int = 4,
                  max_len: int = 512, num_replicas: int = 1,
                  kv_cache: str = "dense", num_pages: int = 64,
                  page_size: int = 16,
                  enable_prefix_cache: bool = False,
                  kv_dtype: str = "model",
                  draft_factory=None, draft_k: int = 4, device=None):
    """Bind an LLM serving app: ``serve.run(build_llm_app(factory))``.
    ``kv_cache="paged"`` hosts the page-pool engine; ``draft_factory=
    (params, cfg) -> (draft_params, draft_cfg)`` enables the speculative
    request path. ``device`` is each replica's (``None``: its card)."""
    dep = _deployment(LLMServer, num_replicas=num_replicas)
    return dep.bind(model_factory, max_slots=max_slots, max_len=max_len,
                    kv_cache=kv_cache, num_pages=num_pages,
                    page_size=page_size,
                    enable_prefix_cache=enable_prefix_cache,
                    kv_dtype=kv_dtype,
                    draft_factory=draft_factory, draft_k=draft_k,
                    device=device)
