"""Runtime context: who/where am I, inside tasks and actors.

Reference: ``python/ray/runtime_context.py`` (``ray.get_runtime_context()``
→ node id, worker id, task id, actor id, assigned resources). Execution
identity is tracked in a contextvar set by the executor around user
code: pool threads behave like locals, and each async actor call's
asyncio.Task gets an isolated context (concurrent calls on one loop
thread never see each other's identity).
"""

from __future__ import annotations

import contextvars
from typing import Dict, Optional

# contextvars (not threading.local): async actor calls share the loop
# thread but each asyncio.Task gets its own context, so concurrent calls
# never read each other's identity; pool threads behave like locals.
_exec_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "rtpt_exec", default=None)


def _set_execution(task_id: Optional[bytes] = None,
                   actor_id: Optional[bytes] = None,
                   resources: Optional[dict] = None):
    _exec_ctx.set((task_id, actor_id, resources or {}))


def _clear_execution():
    _exec_ctx.set(None)


class RuntimeContext:
    """Answers identity/topology questions from any process."""

    def _worker(self):
        from ray_tpu_torch._private.worker import global_worker

        return global_worker()

    def get_node_id(self) -> str:
        w = self._worker()
        return w.node_id.hex() if isinstance(w.node_id, (bytes, bytearray)) \
            else (w.node_id or b"").hex() if w.node_id else ""

    def get_worker_id(self) -> str:
        return self._worker().worker_id.hex()

    def get_job_id(self) -> str:
        """The session name (this runtime scopes work per session; the
        job-submission subsystem layers real job ids on top)."""
        return self._worker().session_name or ""

    def get_task_id(self) -> Optional[str]:
        ctx = _exec_ctx.get()
        return ctx[0].hex() if ctx and ctx[0] else None

    def get_actor_id(self) -> Optional[str]:
        ctx = _exec_ctx.get()
        return ctx[1].hex() if ctx and ctx[1] else None

    def get_assigned_resources(self) -> Dict[str, float]:
        ctx = _exec_ctx.get()
        return dict(ctx[2]) if ctx else {}

    @property
    def was_current_actor_reconstructed(self) -> bool:
        import os

        return os.environ.get("RAY_TPU_TORCH_ACTOR_RESTARTED") == "1"

    def get(self) -> dict:
        """Legacy dict form (reference ``RuntimeContext.get``)."""
        return {
            "node_id": self.get_node_id(),
            "worker_id": self.get_worker_id(),
            "job_id": self.get_job_id(),
            "task_id": self.get_task_id(),
            "actor_id": self.get_actor_id(),
        }


_context = RuntimeContext()


def get_runtime_context() -> RuntimeContext:
    return _context
