"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``.

The runtime core (since the runtime slice): tasks, actors and named
actors, the shared-memory object store (``put``/``get``/``wait``), the GCS
control plane, placement groups, and the GPU as a resource a worker is
pinned to (``get_gpu_ids``), copied from ``ray_tpu``'s JAX-free runtime
tier with the reference's API (``python/ray/__init__.py``): ``init``,
``shutdown``, ``remote``, ``get``, ``put``, ``wait``, ``kill``, ``cancel``,
``get_actor``, ``nodes``, ``cluster_resources``, ``available_resources``,
``get_gpu_ids``, ``get_runtime_context``. ``train`` holds
``TorchTrainer``, which runs a training loop in worker actors, and
``serve`` the Serve runtime (deployments, handles, a controller, HTTP and
RPC ingress) with ``build_llm_app``.

The compute tier: Llama-family, Mixtral (MoE) and ViT model code
(``models``, each with a differentiable forward and ``loss_fn``), its ops
(``ops``, with hand-written Hopper flash-attention forward, backward and
ring-step kernels under ``csrc/``), the continuous-batching engine and the
LLM server (``serve.llm``), and the mesh, collectives, FSDP/TP sharding,
expert parallelism, pipeline, ring attention and Ulysses (``parallel``).
A training step is ``loss_fn``, autograd and ``torch.optim.AdamW`` over
``models.trainable(params)``. It imports ``torch`` and ``numpy`` (and the
runtime ``cloudpickle``, ``msgpack``) only; the JAX package ``ray_tpu``
stays the reference the tests hold this one to.

Entry points that build tensors take ``device=`` and default to CUDA;
without a GPU they raise unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import atexit
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ._private import node as _node_mod
from ._private import worker as _worker_mod
from ._private.ids import ActorID, NodeID, ObjectID, TaskID
from ._private.remote import (ActorClass, ActorHandle, ActorMethod,
                              RemoteFunction, method, remote)
from ._private.serialization import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ._private.worker import ObjectRef, ObjectRefGenerator
from ._private.runtime_context import get_runtime_context

__version__ = "0.1.0"

_head_node = None
_initialized = False


def is_initialized() -> bool:
    return _initialized


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default",
         num_initial_workers: int = 2,
         probe_gpu: bool = True,
         ignore_reinit_error: bool = False,
         object_store_memory: Optional[int] = None,
         port: int = 0,
         host: str = "",
         log_to_driver: bool = True,
         logging_config: Optional["LoggingConfig"] = None,
         _system_config: Optional[Dict[str, Any]] = None):
    """Start (or connect to) a ray_tpu_torch cluster.

    With no ``address``, spawns a head process (GCS + node agent + worker
    pool) for this host — the analog of ``ray.init()`` head-node bootstrap
    (reference: ``python/ray/_private/worker.py:1262``). ``num_gpus``
    sets the node's GPU count; without it a subprocess counts the cards
    (``probe_gpu``), so no runtime process holds a CUDA context.
    """
    global _head_node, _initialized
    if _initialized:
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice; use "
                           "ignore_reinit_error=True to allow this.")
    if logging_config is not None:
        # Before any session process spawns: children inherit the env.
        os.environ["RAY_TPU_TORCH_LOG_LEVEL"] = logging_config.log_level
        os.environ["RAY_TPU_TORCH_LOG_ENCODING"] = logging_config.encoding
    if _system_config:
        # Central typed flags (reference: RayConfig _system_config,
        # ray_config_def.h:21): installed BEFORE any session process
        # spawns so the whole tree shares one table.
        from ._private.config import set_system_config

        set_system_config(_system_config)
    if address is None:
        # Submitted jobs / joined drivers auto-connect to their cluster
        # (reference: RAY_ADDRESS, python/ray/_private/worker.py:1262).
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    if address == "auto":
        address = None
        cur = os.path.join(_node_mod.default_session_root(), "ray_current_cluster")
        if os.path.exists(cur):
            address = open(cur).read().strip() or None
    client_mode = False
    if address is not None and address.startswith("ray://"):
        # Remote-driver ("Ray Client") connection — reference:
        # ``python/ray/util/client/`` ray:// proxy. Here the same control
        # protocol serves remote drivers directly; client mode switches the
        # object plane to the GCS transfer relay since no host store is
        # shared with the cluster.
        address = address[len("ray://"):]
        client_mode = True
    if address is None:
        from ._private.node import HeadNode

        res = dict(resources or {})
        if object_store_memory is not None:
            res["object_store_memory"] = float(object_store_memory)
        _head_node = HeadNode(num_cpus=num_cpus, num_gpus=num_gpus,
                              resources=res or None,
                              num_initial_workers=num_initial_workers,
                              probe_gpu=probe_gpu, port=port, host=host)
        address = _head_node.address
    w = _worker_mod.Worker(role="driver")
    w.namespace = namespace
    w.connect(address, client_mode=client_mode)
    _worker_mod.set_global_worker(w)
    _initialized = True
    atexit.register(shutdown)
    return address


def client_server_address() -> Optional[str]:
    """``ray://`` address remote drivers can connect to, if this cluster was
    started with ``init(port=...)`` (reference: Ray Client server,
    ``python/ray/util/client/server/``)."""
    if _head_node is not None and _head_node.tcp_address:
        return "ray://" + _head_node.tcp_address
    return None


def shutdown():
    """Disconnect and, if this driver started the cluster, tear it down."""
    global _head_node, _initialized
    if not _initialized:
        return
    w = _worker_mod._global_worker
    if w is not None:
        if _head_node is not None:
            try:
                w.request_gcs({"t": "shutdown"}, timeout=5)
            except Exception:
                pass
        w.disconnect()
    _worker_mod.set_global_worker(None)
    if _head_node is not None:
        _head_node.stop()
        _head_node = None
    _initialized = False
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    w = _worker_mod.global_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or a list, got {type(refs)}")
    return w.get(list(refs), timeout)


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return _worker_mod.global_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return _worker_mod.global_worker().wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _worker_mod.global_worker().kill_actor(actor._id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    _worker_mod.global_worker().cancel_task(ref.task_id(), force)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (reference: ``ray.get_actor``)."""
    w = _worker_mod.global_worker()
    aid = w.get_actor_id_by_name(name, namespace or w.namespace)
    # Method names are unknown without the class; permissive handle resolves
    # any non-underscore attribute as a method.
    return _AnyMethodActorHandle(aid, [], 0)


class _AnyMethodActorHandle(ActorHandle):
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace of task/actor execution events (``ray.timeline``)."""
    from ray_tpu_torch.util.state import timeline as _timeline

    return _timeline(filename)


def nodes() -> List[dict]:
    info = _worker_mod.global_worker().cluster_info()
    return [
        {"NodeID": n["node_id"].hex(), "Alive": n["alive"],
         "State": n.get("state",
                        "ALIVE" if n["alive"] else "DEAD"),
         "Draining": n.get("draining", False),
         "DrainReason": n.get("drain_reason", ""),
         "NodeManagerHostname": n["hostname"], "Resources": n["total"],
         "Available": n["avail"], "Workers": n["workers"]}
        for n in info["nodes"]
    ]


def drain_node(node_id: str, *, reason: str = "",
               deadline_s: Optional[float] = None) -> bool:
    """Gracefully drain a node (lifecycle ``ALIVE -> DRAINING -> DEAD``;
    reference: the ``DrainNode`` autoscaler protocol).

    From the moment the GCS records the drain the scheduler places
    nothing new on the node (tasks, actors, placement-group bundles),
    restartable actors are proactively migrated elsewhere, and in-flight
    tasks get until the deadline to finish; at the deadline the node is
    force-transitioned to DEAD and the normal recovery paths (task retry,
    lineage reconstruction, actor restart) complete the workload.

    Args:
        node_id: hex node id (see ``ray_tpu_torch.nodes()`` /
            ``ray_tpu_torch.util.state.list_nodes``).
        reason: human-readable drain reason, surfaced by the state API.
        deadline_s: migration window; defaults to the ``drain_deadline_s``
            config flag.
    """
    msg: Dict[str, Any] = {"t": "drain_node",
                           "node_id": bytes.fromhex(node_id),
                           "reason": reason}
    if deadline_s is not None:
        msg["deadline_s"] = float(deadline_s)
    reply = _worker_mod.global_worker().request_gcs(msg)
    return bool(reply.get("ok"))


def cluster_resources() -> Dict[str, float]:
    # DRAINING nodes are excluded: their capacity is leaving the cluster
    # and nothing new can be placed on them.
    info = _worker_mod.global_worker().cluster_info()
    out: Dict[str, float] = {}
    for n in info["nodes"]:
        if n["alive"] and not n.get("draining"):
            for k, v in n["total"].items():
                out[k] = out.get(k, 0.0) + v
    return out


def available_resources() -> Dict[str, float]:
    # DRAINING nodes are excluded (see cluster_resources): elastic
    # consumers sizing against this must not count doomed capacity.
    info = _worker_mod.global_worker().cluster_info()
    out: Dict[str, float] = {}
    for n in info["nodes"]:
        if n["alive"] and not n.get("draining"):
            for k, v in n["avail"].items():
                out[k] = out.get(k, 0.0) + v
    return out


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "nodes", "drain_node",
    "cluster_resources",
    "available_resources", "timeline", "ObjectRef", "ActorHandle", "ActorClass",
    "RemoteFunction", "TaskError", "ActorDiedError", "WorkerCrashedError",
    "ObjectLostError", "GetTimeoutError", "TaskCancelledError",
    "method", "get_gpu_ids", "show_in_dashboard", "get_runtime_context",
    "LoggingConfig",
    "resolve_device",
]

import enum as _enum
from dataclasses import dataclass as _dataclass


class Language(_enum.Enum):
    """Worker language of a remote function/actor (reference:
    ``ray.Language`` — PYTHON/JAVA/CPP)."""

    PYTHON = 0
    JAVA = 1
    CPP = 2


# Process-role constants (reference: ray.SCRIPT_MODE etc.). LOCAL_MODE's
# inline-execution behavior is deliberately NOT implemented — the
# reference deprecated it; the constant exists for source compatibility.
SCRIPT_MODE = 0
WORKER_MODE = 1
LOCAL_MODE = 2


def __getattr__(name):
    # Lazily, so that the runtime's head and node agent, which import this
    # package, never import torch.
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(
        f"module 'ray_tpu_torch' has no attribute {name!r}")


@_dataclass
class LoggingConfig:
    """Worker-process logging settings (reference: ``ray.LoggingConfig``).

    Applied by ``init(logging_config=...)``: ``log_level`` propagates to
    every session process via ``RAY_TPU_TORCH_LOG_LEVEL``; ``encoding`` "TEXT"
    or "JSON" selects the session log line format.
    """

    encoding: str = "TEXT"
    log_level: str = "INFO"

    def __post_init__(self):
        if self.encoding not in ("TEXT", "JSON"):
            raise ValueError(f"unsupported log encoding {self.encoding!r}")


def get_gpu_ids() -> List[str]:
    """GPU ids assigned to this worker (reference: ``ray.get_gpu_ids``):
    the worker sets ``CUDA_VISIBLE_DEVICES`` to the ids the GCS leased it
    before its first CUDA call (``GPUAcceleratorManager.
    set_visible_accelerators``)."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    return [] if not vis else [v for v in vis.split(",") if v != ""]


def show_in_dashboard(message: str, key: str = "") -> None:
    """Attach a free-form status string to this worker, visible in the
    dashboard's KV namespace (reference: ``ray.show_in_dashboard``)."""
    w = _worker_mod.global_worker()
    slot = key or w.worker_id.hex()
    w.kv_put(f"msg:{slot}", str(message).encode("utf-8"), ns="dashboard")



def exit_actor():
    """Gracefully exit the current actor after the in-flight call
    completes (reference: ``ray.actor.exit_actor``): the caller of THIS
    method receives ``None``; later calls observe the actor's death."""
    ctx = get_runtime_context()
    if ctx.get_actor_id() is None:
        raise RuntimeError(
            "exit_actor() can only be called inside an actor method")
    from ray_tpu_torch._private.serialization import ActorExitSignal

    raise ActorExitSignal()


__all__ += ["exit_actor"]


def cpp_function(worker_name: str, fn_name: str):
    """Handle to a named function served by a registered C++ worker
    (reference: ``ray.cpp_function``; machinery:
    ``ray_tpu_torch.cross_language`` + ``native/cpp_client``)."""
    from ray_tpu_torch import cross_language as _xl

    return _xl.cpp_function(worker_name, fn_name)


def java_function(class_name: str, function_name: str):
    """Unsupported: no JVM ships in this image (reference:
    ``ray.java_function``). The msgpack cross-language protocol +
    ``native/cpp_client`` C++ worker are the documented port template."""
    raise NotImplementedError(
        "java workers are not supported (no JVM in this image); see "
        "ray_tpu_torch.cross_language + native/cpp_client for the language-"
        "neutral protocol a Java client would implement")


def java_actor_class(class_name: str):
    """Unsupported — see ``java_function``."""
    raise NotImplementedError(
        "java workers are not supported (no JVM in this image); see "
        "ray_tpu_torch.cross_language + native/cpp_client for the language-"
        "neutral protocol a Java client would implement")


class ClientContext:
    """Live ``ray://`` connection (reference: ``ClientContext``)."""

    def __init__(self, address: str):
        self.address = address
        self.dashboard_url = None

    def disconnect(self):
        shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()


class ClientBuilder:
    """``ray_tpu_torch.client("host:port").connect()`` builder (reference:
    ``ray.client`` / ``python/ray/client_builder.py``). Wraps the same
    remote-driver join ``init(address="ray://...")`` performs."""

    def __init__(self, address: str):
        self._address = address
        self._namespace = "default"

    def namespace(self, ns: str) -> "ClientBuilder":
        self._namespace = ns
        return self

    def connect(self) -> ClientContext:
        addr = self._address
        if not addr.startswith("ray://"):
            addr = "ray://" + addr
        init(address=addr, namespace=self._namespace)
        return ClientContext(addr)


def client(address: str) -> ClientBuilder:
    return ClientBuilder(address)


from ray_tpu_torch import autoscaler  # noqa: E402  (namespace parity)

__all__ += [
    "Language", "SCRIPT_MODE", "WORKER_MODE",
    "LOCAL_MODE", "cpp_function", "java_function", "java_actor_class",
    "client", "client_server_address", "ClientBuilder", "ClientContext",
    "autoscaler",
]
