"""Workflows: durable DAG execution with per-step checkpointing + resume.

Analog of the reference's ``python/ray/workflow``: each step of a bound DAG
runs as a cluster task and its result is persisted to storage
(``workflow/workflow_storage.py``); re-running or resuming a workflow loads
completed steps from storage instead of re-executing
(``workflow_state_from_storage.py``). Step identity is the node's position
in the deterministic topological order plus the function name.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode, MultiOutputNode

# Workflow statuses (reference: workflow/common.py WorkflowStatus)
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
CANCELED = "CANCELED"
RESUMABLE = "RESUMABLE"

_default_storage = None
_lock = threading.Lock()
_cancel_flags: Dict[str, bool] = {}


def init(storage: Optional[str] = None):
    """Set the storage root for workflow metadata + step results."""
    global _default_storage
    _default_storage = storage or os.path.join(
        os.path.expanduser("~"), ".ray_tpu_torch_workflows")
    os.makedirs(_default_storage, exist_ok=True)
    return _default_storage


def _storage() -> str:
    if _default_storage is None:
        init()
    return _default_storage


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage(), workflow_id)


def _status_path(workflow_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), "status.json")


def _write_status(workflow_id: str, status: str, extra: Optional[dict] = None):
    os.makedirs(_wf_dir(workflow_id), exist_ok=True)
    doc = {"workflow_id": workflow_id, "status": status,
           "updated_at": time.time()}
    if extra:
        doc.update(extra)
    tmp = _status_path(workflow_id) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, _status_path(workflow_id))


def _read_status(workflow_id: str) -> dict:
    try:
        with open(_status_path(workflow_id)) as f:
            return json.load(f)
    except OSError:
        raise ValueError(f"no workflow with id {workflow_id!r}")


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic step id per node: topo index + name."""
    ids: Dict[int, str] = {}
    for i, node in enumerate(dag.topo_order()):
        opts = getattr(node, "_wf_options", None)
        if opts and opts.get("name"):
            # workflow.options(name=...): the given name IS the step id
            # (stable across DAG edits, the reference contract).
            ids[id(node)] = opts["name"]
            continue
        name = ""
        if isinstance(node, FunctionNode):
            name = getattr(node._fn, "__name__", "fn")
        ids[id(node)] = f"{i:04d}_{name or type(node).__name__}"
    return ids


def _step_path(workflow_id: str, step_id: str) -> str:
    return os.path.join(_wf_dir(workflow_id), "steps", f"{step_id}.pkl")


class WorkflowError(RuntimeError):
    """Base for workflow-level failures (reference:
    ``workflow.exceptions.WorkflowError``)."""


class WorkflowExecutionError(WorkflowError):
    """A workflow failed mid-execution (reference:
    ``WorkflowExecutionError``). Step exceptions propagate with their
    original type; this wraps engine-level failures (e.g. a resume
    whose persisted DAG is gone)."""


class WorkflowCanceledError(WorkflowError):
    pass


# Reference spelling (workflow/exceptions.py)
WorkflowCancellationError = WorkflowCanceledError


class EventListener:
    """Durable event-source adapter base (reference:
    ``workflow/event_listener.py``): subclass ``poll_for_event`` to
    bridge an external system into ``wait_for_event``-style steps."""

    async def poll_for_event(self, *args, **kwargs):
        raise NotImplementedError

    async def event_checkpointed(self, event) -> None:
        pass


class _Continuation:
    """Marker a step returns to extend the workflow (``continuation``)."""

    def __init__(self, dag: DAGNode, args: tuple = ()):
        self.dag = dag
        self.args = args


def continuation(dag: DAGNode, *, args: tuple = ()) -> "_Continuation":
    """Return from a step to continue the workflow with another DAG
    (reference: ``workflow.continuation``): the continuation's steps
    join the same workflow id and checkpoint under a generation prefix,
    so resume replays them from storage like any other step."""
    if not isinstance(dag, DAGNode):
        raise TypeError("continuation expects a bound DAG node")
    return _Continuation(dag, args)


def options(*, name: Optional[str] = None, checkpoint: bool = True,
            **metadata):
    """Per-step options wrapper (reference: ``workflow.options``):
    ``workflow.options(name="fetch", checkpoint=False)(fn.bind(x))``
    names the step (stable ids across DAG edits) and can skip its
    checkpoint."""

    def apply(node: DAGNode) -> DAGNode:
        node._wf_options = {"name": name, "checkpoint": checkpoint,
                            "metadata": metadata}
        return node

    return apply


def _execute(dag: DAGNode, workflow_id: str, input_args: tuple,
             step_prefix: str = "") -> Any:
    """Run the DAG, checkpointing each FunctionNode result; previously
    checkpointed steps short-circuit (the resume path). ``step_prefix``
    namespaces continuation generations."""
    steps_dir = os.path.join(_wf_dir(workflow_id), "steps")
    os.makedirs(steps_dir, exist_ok=True)
    # Persist the DAG itself so resume() can re-run without the caller
    # rebuilding it (reference: workflow spec storage).
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if not os.path.exists(dag_path):
        with open(dag_path, "wb") as f:
            cloudpickle.dump((dag, input_args), f)

    ids = _step_ids(dag)
    cache: Dict[int, Any] = {}
    for node in dag.topo_order():
        if _cancel_flags.get(workflow_id):
            raise WorkflowCanceledError(workflow_id)
        step_id = step_prefix + ids[id(node)]
        path = _step_path(workflow_id, step_id)
        opts = getattr(node, "_wf_options", None) or {}
        durable = opts.get("checkpoint", True)
        if isinstance(node, FunctionNode) and os.path.exists(path):
            with open(path, "rb") as f:
                cache[id(node)] = ray_tpu_torch.put(cloudpickle.load(f))
            continue
        out = node._execute_self(cache, input_args, {})
        if isinstance(node, FunctionNode):
            value = ray_tpu_torch.get(out)  # barrier: durability per step
            if durable:
                with open(path + ".tmp", "wb") as f:
                    cloudpickle.dump(value, f)
                os.replace(path + ".tmp", path)
            out = ray_tpu_torch.put(value)
        cache[id(node)] = out
    result = cache[id(dag)]
    if isinstance(dag, MultiOutputNode):
        return [ray_tpu_torch.get(r) for r in result]
    return ray_tpu_torch.get(result)


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        args: tuple = ()) -> Any:
    """Execute a DAG durably; returns the final output value."""
    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    with _lock:
        _cancel_flags.pop(workflow_id, None)
    _write_status(workflow_id, RUNNING)
    try:
        result = _execute(dag, workflow_id, args)
        gen = 0
        while isinstance(result, _Continuation):
            gen += 1
            result = _execute(result.dag, workflow_id, result.args,
                              step_prefix=f"g{gen}_")
    except WorkflowCanceledError:
        _write_status(workflow_id, CANCELED)
        raise
    except Exception as e:
        _write_status(workflow_id, FAILED, {"error": repr(e)})
        raise
    _write_status(workflow_id, SUCCESSFUL)
    out_path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    with open(out_path, "wb") as f:
        cloudpickle.dump(result, f)
    return result


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              args: tuple = ()):
    """Like run() but returns a concurrent Future."""
    from concurrent.futures import ThreadPoolExecutor

    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run, dag, workflow_id=workflow_id, args=args)
    fut.workflow_id = workflow_id
    pool.shutdown(wait=False)
    return fut


def resume_async(workflow_id: str):
    """``resume`` on a background thread; returns a Future (reference:
    ``workflow.resume_async``)."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(resume, workflow_id)
    fut.workflow_id = workflow_id
    pool.shutdown(wait=False)
    return fut


def get_output_async(workflow_id: str):
    """``get_output`` as a Future (reference:
    ``workflow.get_output_async``)."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(get_output, workflow_id)
    pool.shutdown(wait=False)
    return fut


def sleep(duration: float) -> DAGNode:
    """A durable sleep step (reference: ``workflow.sleep``). Once slept,
    the checkpoint makes resume skip it; a crash MID-sleep re-sleeps the
    full duration on resume (the step model checkpoints only completed
    steps)."""

    @ray_tpu_torch.remote
    def _wf_sleep(d):
        time.sleep(d)
        return None

    return _wf_sleep.bind(duration)


def resume(workflow_id: str) -> Any:
    """Re-run a FAILED/CANCELED/RESUMABLE workflow; completed steps load
    from storage (reference: workflow_state_from_storage.py)."""
    status = _read_status(workflow_id)
    if status["status"] == SUCCESSFUL:
        return get_output(workflow_id)
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    try:
        with open(dag_path, "rb") as f:
            dag, input_args = cloudpickle.load(f)
    except OSError as e:
        raise WorkflowExecutionError(
            f"workflow {workflow_id!r} has no persisted DAG "
            "to resume from") from e
    with _lock:
        _cancel_flags.pop(workflow_id, None)
    return run(dag, workflow_id=workflow_id, args=input_args)


def resume_all() -> List[str]:
    """Resume every non-successful stored workflow; returns their ids."""
    resumed = []
    for wf in list_all():
        if wf["status"] in (FAILED, CANCELED, RUNNING, RESUMABLE):
            try:
                resume(wf["workflow_id"])
                resumed.append(wf["workflow_id"])
            except Exception:
                pass
    return resumed


def get_status(workflow_id: str) -> str:
    return _read_status(workflow_id)["status"]


def get_output(workflow_id: str) -> Any:
    out_path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(out_path):
        status = get_status(workflow_id)
        raise ValueError(
            f"workflow {workflow_id} has no output (status={status})")
    with open(out_path, "rb") as f:
        return cloudpickle.load(f)


def get_metadata(workflow_id: str) -> dict:
    doc = _read_status(workflow_id)
    steps_dir = os.path.join(_wf_dir(workflow_id), "steps")
    try:
        doc["checkpointed_steps"] = sorted(
            f[:-4] for f in os.listdir(steps_dir) if f.endswith(".pkl"))
    except OSError:
        doc["checkpointed_steps"] = []
    return doc


def list_all() -> List[dict]:
    root = _storage()
    out = []
    for name in sorted(os.listdir(root)):
        try:
            out.append(_read_status(name))
        except ValueError:
            continue
    return out


def cancel(workflow_id: str):
    """Request cancellation of a workflow running in this process."""
    with _lock:
        _cancel_flags[workflow_id] = True
    _write_status(workflow_id, CANCELED)


def wait_for_event(channel: str, *, timeout: Optional[float] = None):
    """A workflow step that blocks until a message arrives on a pubsub
    channel (reference: ``workflow.wait_for_event`` + EventListener,
    ``python/ray/workflow/api.py`` / ``event_listener.py``). Returns the
    event's message payload into the DAG.

    Checkpointing comes from ordinary step persistence: once the event
    arrives the step result is durable, so ``resume`` never re-waits.
    Delivery is subscribe-then-publish — producers should publish until
    the workflow acknowledges (out-of-band) or use a durable trigger,
    same at-least-once contract as the reference's event system.
    """
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def _wait_for_event(ch, to):
        from ray_tpu_torch.util import pubsub

        with pubsub.subscribe(ch) as sub:
            deadline = None if to is None else time.time() + to
            while True:
                # Bounded poll steps so a closed subscription is noticed
                # (poll returns None both on timeout and on close).
                step = 1.0 if deadline is None else \
                    min(1.0, max(0.05, deadline - time.time()))
                item = sub.poll(timeout=step)
                if item is None:
                    if sub._closed.is_set():
                        raise RuntimeError(
                            f"subscription to {ch!r} closed while "
                            "waiting for the event")
                    if deadline is not None and time.time() >= deadline:
                        raise TimeoutError(
                            f"no event on channel {ch!r} within {to}s")
                    continue
                if item.get("resubscribed"):
                    continue  # gap marker, not an event
                return item["message"]  # any payload, including None

    node = _wait_for_event.bind(channel, timeout)
    return node


def delete(workflow_id: str):
    import shutil

    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)


__all__ = [
    "init", "run", "run_async", "resume", "resume_async", "resume_all",
    "get_status", "get_output", "get_output_async", "get_metadata",
    "list_all", "cancel", "delete", "sleep", "options", "continuation",
    "InputNode", "MultiOutputNode", "wait_for_event", "EventListener",
    "WorkflowError", "WorkflowExecutionError", "WorkflowCancellationError",
    "RUNNING", "SUCCESSFUL", "FAILED", "CANCELED", "RESUMABLE",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu('workflow')
del _rlu
