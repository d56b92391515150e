"""``@remote`` machinery: remote functions and actor classes.

Analog of the reference's ``python/ray/remote_function.py:40``
(``RemoteFunction``), ``python/ray/actor.py:581`` (``ActorClass``,
``ActorHandle``, ``ActorMethod``). Functions are cloudpickled once,
registered in the GCS KV under a content hash, and fetched/cached by
workers.
"""

from __future__ import annotations

import hashlib
import inspect
import os
from typing import Any, Dict, List, Optional, Union

import cloudpickle

from . import serialization
from .ids import ActorID
from .roadmap import not_ported
from .serialization import serialize
from .worker import ObjectRef, global_worker
from ..util import tracing

_DEFAULT_TASK_OPTS = dict(
    num_cpus=1, num_gpus=0, resources=None, num_returns=1, max_retries=3,
    name=None, scheduling_strategy=None, runtime_env=None,
    placement_group=None, placement_group_bundle_index=None,
)
_DEFAULT_ACTOR_OPTS = dict(
    num_cpus=0, num_gpus=0, resources=None, max_restarts=0,
    max_task_retries=0, name=None, namespace=None, lifetime=None,
    max_concurrency=None, concurrency_groups=None,
    scheduling_strategy=None, runtime_env=None,
    placement_group=None, placement_group_bundle_index=None,
)


def method(*, concurrency_group: Optional[str] = None,
           num_returns: Optional[int] = None):
    """Per-method options decorator (reference: ``ray.method`` —
    ``actor.py:116`` ActorMethod options; concurrency groups per
    ``ConcurrencyGroupManager``)."""

    def wrap(fn):
        if concurrency_group is not None:
            fn._concurrency_group = concurrency_group
        if num_returns is not None:
            fn._num_returns = num_returns
        return fn

    return wrap


def _check_num_gpus(opts: dict) -> None:
    """A GPU count above 1 must be whole: a worker is pinned to whole
    cards or to a share of one (upstream Ray refuses such counts too)."""
    n = float(opts.get("num_gpus") or 0)
    if n > 1 and not n.is_integer():
        raise ValueError(f"num_gpus={n}: a count above 1 must be whole")


def _build_resources(opts: dict) -> Dict[str, float]:
    res: Dict[str, float] = {}
    if opts.get("num_cpus"):
        res["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("resources"):
        res.update({k: float(v) for k, v in opts["resources"].items()})
    if not res:
        res = {"CPU": 0.0}
    return res


def _strategy_opts(opts: dict) -> dict:
    """Translate user scheduling options to wire opts (pg/bix/sched)."""
    out = {}
    strategy = opts.get("scheduling_strategy")
    pg = opts.get("placement_group")
    if pg is None and strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
        out["bix"] = strategy.placement_group_bundle_index
    if pg is not None:
        out["pg"] = pg.id.binary() if hasattr(pg, "id") else pg
        if opts.get("placement_group_bundle_index") is not None:
            out["bix"] = opts["placement_group_bundle_index"]
    if isinstance(strategy, str):
        out["sched"] = strategy
    elif strategy is not None and hasattr(strategy, "node_id"):
        out["sched"] = {"type": "node_affinity", "node_id": strategy.node_id,
                        "soft": strategy.soft}
    return out


# Session-scoped cache of prepared (uploaded) runtime_env wire forms,
# keyed by the env's value. Packaging a working_dir re-zips and re-hashes
# the whole tree; doing that once per ``.remote()`` call — including the
# ``fn.options(runtime_env={...}).remote()``-in-a-loop pattern, where every
# call builds a fresh dict — would crater submission throughput. Caveat
# (shared with the reference's URI cache): edits to the directory *during*
# a session are not re-uploaded for an identical runtime_env value.
_RENV_WIRE_CACHE: Dict[tuple, dict] = {}

# Cached wire form of an empty (args, kwargs) tuple (see _prepare_args).


def _prepared_runtime_env(opts: dict):
    renv = opts.get("runtime_env")
    if not renv:
        return None
    w = global_worker()
    try:
        key = (w.session_name, repr(sorted(renv.items(), key=repr)))
    except Exception:
        key = None
    if key is not None and key in _RENV_WIRE_CACHE:
        return _RENV_WIRE_CACHE[key]
    raise not_ported("runtime_env", "runtime_env")
    if key is not None:
        if len(_RENV_WIRE_CACHE) > 256:
            _RENV_WIRE_CACHE.clear()
        _RENV_WIRE_CACHE[key] = wire
    return wire


def _prepare_args(args: tuple, kwargs: dict,
                  collect_deps: bool = False,
                  direct_ok: bool = False) -> dict:
    """Serialize call arguments; large blobs go to shared memory.

    Mirrors the reference's inline-vs-plasma arg split
    (``DependencyResolver`` inlining, ``transport/dependency_resolver.h``):
    small args travel in the control message, large ones are put into the
    object store and fetched zero-copy by the executing worker.

    ``direct_ok`` marks call sites with an already-open peer connection
    (direct actor calls): mid-size args — above the inline limit, at most
    ``direct_arg_threshold`` — skip the shm create/seal + GCS register
    round trip and ride that connection as out-of-band scatter-gather
    buffers instead (``protocol.pack_with_buffers``). The returned dict
    then carries ``"ap"`` (pickle bytes, in the frame header) plus the
    non-serializable ``"_sg"`` SerializedObject whose raw buffers the
    dispatcher hands to the transport; huge args and anything a borrower
    might need later keep the shm+GCS object-plane path.

    ``collect_deps`` additionally reports top-level ObjectRef arguments so
    the submitter can defer dispatch until they resolve — pushing a task
    whose args are still being computed would park it on a worker that
    then blocks, deadlocking pipelines whose producer tasks queue behind
    it (the reference resolves dependencies BEFORE taking a lease,
    ``transport/dependency_resolver.h``).
    """
    if not args and not kwargs:
        # No-arg calls are the hottest control-plane shape; skip the pickle
        # (single definition site shared with the worker-side match).
        return {"args": serialization.empty_args_bytes()}
    w = global_worker()
    out: dict = {}
    if collect_deps:
        from .worker import ObjectRef

        deps = [a.id.binary() for a in args if isinstance(a, ObjectRef)]
        deps += [v.id.binary() for v in kwargs.values()
                 if isinstance(v, ObjectRef)]
        if deps:
            out["deps"] = deps
    sobj = serialize((args, kwargs))
    # Route on data_size (pickle + raw buffers): the direct lane never
    # builds the shm segment layout, so total_size (which computes it)
    # must not be touched before routing.
    nbytes = sobj.data_size
    if nbytes <= serialization.INLINE_THRESHOLD:
        serialization.TRANSPORT_STATS["inline_args"] += 1
        out["args"] = sobj.to_bytes()
        return out
    if direct_ok and nbytes <= serialization.DIRECT_ARG_THRESHOLD:
        serialization.TRANSPORT_STATS["direct_lane_args"] += 1
        serialization.TRANSPORT_STATS["direct_lane_bytes"] += nbytes
        out["ap"] = sobj.pickle_bytes
        out["_sg"] = sobj
        return out
    serialization.TRANSPORT_STATS["shm_args"] += 1
    oid = w.put_serialized(sobj)
    # Hold a reference until the consuming task is done: register then let
    # the GCS-side refcount keep it; the executing worker borrows it. The
    # matching -1 is queued by Worker.release_task_args when the task (and
    # any lineage spec pinning it) reaches a terminal state; the liveness
    # note keeps a control-plane-restart resync honest about the in-flight
    # count.
    w.note_ref_live(oid, +1)
    out["argsref"] = oid.binary()
    out["argsn"] = sobj.total_size
    return out


class RemoteFunction:
    def __init__(self, fn, opts: Optional[dict] = None):
        self._fn = fn
        self._opts = dict(_DEFAULT_TASK_OPTS)
        if opts:
            self._opts.update(opts)
        _check_num_gpus(self._opts)
        self._blob: Optional[bytes] = None
        self._fid: Optional[str] = None
        self._registered_sessions: set = set()
        self.__name__ = getattr(fn, "__name__", "remote_fn")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Remote function {self.__name__} cannot be called directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "RemoteFunction":
        opts = dict(self._opts)
        opts.update(overrides)
        rf = RemoteFunction(self._fn, opts)
        rf._blob = self._blob
        rf._fid = self._fid
        rf._registered_sessions = self._registered_sessions
        return rf

    def _ensure_registered(self) -> str:
        w = global_worker()
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._fn)
            self._fid = (
                f"{self.__name__}-{hashlib.sha1(self._blob).hexdigest()[:16]}")
        if w.session_name not in self._registered_sessions:
            w.kv_put(self._fid, self._blob, ns="fn")
            # Shadow for GCS-restart replay: a crash before the WAL
            # append loses the blob durably, and this session cache
            # would never re-send — resync replays every noted export.
            w.note_export("fn", self._fid, self._blob)
            self._registered_sessions.add(w.session_name)
        return self._fid

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: ``dag/dag_node.py`` bind API)."""
        raise not_ported("bind (dag)", "dag")

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        w = global_worker()
        fid = self._ensure_registered()
        opts = self._opts
        # Wire options are invariant per RemoteFunction instance — build
        # once (submission throughput: .remote() in a tight loop is the
        # reference's hottest public call path, remote_function.py:266).
        wire_opts = getattr(self, "_wire_opts", None)
        if wire_opts is None:
            wire_opts = {
                "res": _build_resources(opts),
                "retries": opts.get("max_retries", 3),
                "name": opts.get("name") or self.__name__,
            }
            renv = _prepared_runtime_env(opts)
            if renv:
                wire_opts["runtime_env"] = renv
            wire_opts.update(_strategy_opts(opts))
            self._wire_opts = wire_opts
        nret = opts.get("num_returns", 1)
        if nret == "streaming":
            nret = "dynamic"  # alias: both resolve to an ObjectRefGenerator
        msg_args = _prepare_args(args, kwargs, collect_deps=True)
        if tracing.active():
            # Per-call span: copy the cached wire opts (the hot path when
            # tracing is off never pays for the copy).
            wire_opts = dict(wire_opts)
            tracing.inject_task_opts(wire_opts, wire_opts["name"])
        refs = w.submit_task(fid, msg_args, nret, wire_opts)
        return refs[0] if nret in (1, "dynamic") else refs


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._call(self._name, args, kwargs,
                                  self._num_returns, {})

    def bind(self, *args, **kwargs):
        """Lazy method-call node on a live actor handle."""
        raise not_ported("bind (dag)", "dag")

    def options(self, num_returns: Optional[int] = None, **kw):
        m = ActorMethod(self._handle, self._name,
                        num_returns or self._num_returns)
        return m

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor method {self._name} cannot be called directly; use "
            f"{self._name}.remote().")


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names: List[str],
                 max_task_retries: int = 0,
                 method_num_returns: Optional[Dict[str, int]] = None):
        self._actor_id = actor_id
        self._method_names = list(method_names)
        self._max_task_retries = max_task_retries
        self._method_num_returns = dict(method_num_returns or {})

    @property
    def _id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor has no method {name!r}; available: "
                f"{sorted(self._method_names)}")
        return ActorMethod(self, name,
                           self._method_num_returns.get(name, 1))

    def _call(self, method: str, args: tuple, kwargs: dict,
              num_returns: int, extra_opts: dict):
        w = global_worker()
        # direct_ok: the call rides the actor's own connection, so
        # mid-size args can go out-of-band on it (the direct arg lane).
        msg_args = _prepare_args(args, kwargs, direct_ok=True)
        opts = {"retries": self._max_task_retries}
        opts.update(extra_opts)
        if tracing.active():
            tracing.inject_task_opts(opts, method)
        refs = w.submit_actor_task_msg(self._actor_id, method, msg_args,
                                       num_returns, opts)
        return refs[0] if num_returns == 1 else refs

    def __reduce__(self):
        return (_rebuild_actor_handle,
                (self._actor_id.binary(), self._method_names,
                 self._max_task_retries, self._method_num_returns))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"


def _rebuild_actor_handle(aid_bytes, method_names, max_task_retries,
                          method_num_returns=None):
    return ActorHandle(ActorID(aid_bytes), method_names, max_task_retries,
                       method_num_returns)


class ActorClass:
    def __init__(self, cls, opts: Optional[dict] = None):
        self._cls = cls
        self._opts = dict(_DEFAULT_ACTOR_OPTS)
        if opts:
            self._opts.update(opts)
        _check_num_gpus(self._opts)
        self._blob: Optional[bytes] = None
        self._fid: Optional[str] = None
        self._registered_sessions: set = set()
        self.__name__ = getattr(cls, "__name__", "Actor")

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote().")

    def options(self, **overrides) -> "ActorClass":
        opts = dict(self._opts)
        opts.update(overrides)
        ac = ActorClass(self._cls, opts)
        ac._blob = self._blob
        ac._fid = self._fid
        ac._registered_sessions = self._registered_sessions
        return ac

    def _method_names(self) -> List[str]:
        return [n for n, m in inspect.getmembers(self._cls)
                if callable(m) and not n.startswith("__")]

    def _method_num_returns(self) -> Dict[str, int]:
        """Per-method @ray_tpu_torch.method(num_returns=...) declarations."""
        out = {}
        for n, m in inspect.getmembers(self._cls):
            nr = getattr(m, "_num_returns", None)
            if nr is not None:
                out[n] = nr
        return out

    def _validate_concurrency_groups(self):
        declared = set((self._opts.get("concurrency_groups") or {}))
        for n, m in inspect.getmembers(self._cls):
            g = getattr(m, "_concurrency_group", None)
            if g is not None and g not in declared:
                raise ValueError(
                    f"method {n!r} uses concurrency_group {g!r} but the "
                    f"actor declares only {sorted(declared)} — add it to "
                    "@remote(concurrency_groups={...})")

    def _ensure_registered(self) -> str:
        w = global_worker()
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._cls)
            self._fid = (
                f"{self.__name__}-{hashlib.sha1(self._blob).hexdigest()[:16]}")
        if w.session_name not in self._registered_sessions:
            w.kv_put(self._fid, self._blob, ns="fn")
            # Shadow for GCS-restart replay: a crash before the WAL
            # append loses the blob durably, and this session cache
            # would never re-send — resync replays every noted export.
            w.note_export("fn", self._fid, self._blob)
            self._registered_sessions.add(w.session_name)
        return self._fid

    def bind(self, *args, **kwargs):
        """Lazy actor-construction DAG node."""
        raise not_ported("bind (dag)", "dag")

    def remote(self, *args, **kwargs) -> ActorHandle:
        w = global_worker()
        fid = self._ensure_registered()
        opts = self._opts
        wire_opts = {
            "res": _build_resources(opts),
            "max_restarts": opts.get("max_restarts", 0),
            "name": opts.get("name"),
            "namespace": opts.get("namespace") or w.namespace,
            "lifetime": opts.get("lifetime"),
            "max_concurrency": opts.get("max_concurrency"),
            "concurrency_groups": opts.get("concurrency_groups"),
        }
        renv = _prepared_runtime_env(opts)
        if renv:
            wire_opts["runtime_env"] = renv
        wire_opts.update(_strategy_opts(opts))
        msg_args = _prepare_args(args, kwargs)
        self._validate_concurrency_groups()
        aid = w.create_actor_msg(fid, msg_args, wire_opts)
        return ActorHandle(aid, self._method_names(),
                           opts.get("max_task_retries", 0),
                           self._method_num_returns())


def _maybe_static_check(target):
    """Decoration-time anti-pattern analysis, asked for by
    ``RAY_TPU_TORCH_STATIC_CHECKS=1``: not ported (the reference's
    ``analysis/``), so asking raises."""
    if os.environ.get("RAY_TPU_TORCH_STATIC_CHECKS") == "1":
        raise not_ported("static checks (analysis/)", "tooling")


def remote(*args, **kwargs):
    """``@remote`` decorator for functions and classes."""

    def wrap(target):
        _maybe_static_check(target)
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    if len(args) == 1 and not kwargs and (inspect.isfunction(args[0])
                                          or inspect.isclass(args[0])):
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only")
    return wrap
