"""Lazy task/actor DAGs: ``fn.bind(...)`` graphs.

Analog of the reference's ``ray.dag`` (``python/ray/dag/dag_node.py``):
``.bind()`` builds a lazy DAG of function/actor-method calls; ``execute()``
submits it through the normal task path. ``experimental_compile()`` (see
``ray_tpu_torch.dag.compiled``) pre-resolves an actor pipeline for repeated
low-overhead execution (``dag/compiled_dag_node.py:668``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch


class DAGNode:
    """Base lazy node. Subclasses hold their upstream args."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ------------------------------------------------------------- traversal

    def _children(self) -> List["DAGNode"]:
        out = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                out.append(a)
        return out

    def topo_order(self) -> List["DAGNode"]:
        """Post-order (dependencies first), deduplicated."""
        seen: Dict[int, DAGNode] = {}
        order: List[DAGNode] = []

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    # ------------------------------------------------------------- execution

    def execute(self, *input_args, **input_kwargs):
        """Run the whole DAG through the normal task/actor path; returns the
        ObjectRef(s) of this output node."""
        cache: Dict[int, Any] = {}
        for node in self.topo_order():
            cache[id(node)] = node._execute_self(cache, input_args,
                                                 input_kwargs)
        return cache[id(self)]

    def _resolve_args(self, cache, input_args, input_kwargs) -> Tuple[tuple, dict]:
        def res(a):
            if isinstance(a, DAGNode):
                return cache[id(a)]
            return a

        return (tuple(res(a) for a in self._bound_args),
                {k: res(v) for k, v in self._bound_kwargs.items()})

    def _execute_self(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self, max_inflight: int = 10):
        """Compile this (linear, actor-method) DAG into a persistent
        pipeline (reference: ``dag/dag_node.py:184``)."""
        from .compiled import CompiledDAG

        return CompiledDAG(self, max_inflight=max_inflight)


class InputNode(DAGNode):
    """Placeholder for execute()-time input (reference: dag/input_node.py).

    Usable as a context manager per the reference idiom::

        with InputNode() as inp:
            dag = f.bind(inp)
    """

    def __init__(self, index: int = 0):
        super().__init__((), {})
        self.index = index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_self(self, cache, input_args, input_kwargs):
        if self.index >= len(input_args):
            raise ValueError(
                f"DAG expects input #{self.index}; execute() got "
                f"{len(input_args)} positional args")
        return input_args[self.index]


class InputAttributeNode(DAGNode):
    """``inp[key]`` / ``inp.attr`` access on the input."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self.key = key

    def _execute_self(self, cache, input_args, input_kwargs):
        base = cache[id(self._bound_args[0])]
        if isinstance(self.key, str) and not isinstance(base, (dict, list)):
            return getattr(base, self.key)
        return base[self.key]


def _input_getitem(self, key):
    return InputAttributeNode(self, key)


InputNode.__getitem__ = _input_getitem


class FunctionNode(DAGNode):
    """A bound ``@remote`` function call."""

    def __init__(self, remote_fn, args, kwargs, options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._fn = remote_fn
        self._options = options or {}

    def _execute_self(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_args(cache, input_args, input_kwargs)
        fn = self._fn.options(**self._options) if self._options else self._fn
        return fn.remote(*args, **kwargs)

    def with_options(self, **opts) -> "FunctionNode":
        return FunctionNode(self._fn, self._bound_args, self._bound_kwargs,
                            {**self._options, **opts})


class ClassNode(DAGNode):
    """A bound actor construction; ``.method.bind()`` hangs method nodes off
    it. The actor is created lazily once per execute()d DAG."""

    def __init__(self, actor_cls, args, kwargs, options: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._cls = actor_cls
        self._options = options or {}
        self._cached_handle = None
        self._lock = threading.Lock()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)

    def _execute_self(self, cache, input_args, input_kwargs):
        with self._lock:
            if self._cached_handle is None:
                args, kwargs = self._resolve_args(cache, input_args,
                                                  input_kwargs)
                cls = (self._cls.options(**self._options)
                       if self._options else self._cls)
                self._cached_handle = cls.remote(*args, **kwargs)
        return self._cached_handle


class _HandleNode(DAGNode):
    """Wraps a live ActorHandle so ClassMethodNode has a uniform parent."""

    def __init__(self, handle):
        super().__init__((), {})
        self._handle = handle

    def _execute_self(self, cache, input_args, input_kwargs):
        return self._handle


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, parent, method: str, args, kwargs):
        # parent participates as a dependency so topo order creates the actor
        # (or resolves the upstream node) first.
        super().__init__((parent,) + tuple(args), kwargs)
        self._method = method

    def _execute_self(self, cache, input_args, input_kwargs):
        resolved = [cache[id(a)] if isinstance(a, DAGNode) else a
                    for a in self._bound_args]
        handle, args = resolved[0], resolved[1:]
        kwargs = {k: cache[id(v)] if isinstance(v, DAGNode) else v
                  for k, v in self._bound_kwargs.items()}
        return getattr(handle, self._method).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """Bundle several outputs (reference: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_self(self, cache, input_args, input_kwargs):
        return [cache[id(o)] for o in self._bound_args]


def experimental_compile(dag: DAGNode, **kwargs):
    from .compiled import CompiledDAG

    return CompiledDAG(dag, **kwargs)


__all__ = [
    "DAGNode", "InputNode", "InputAttributeNode", "FunctionNode",
    "ClassNode", "ClassMethodNode", "MultiOutputNode",
    "experimental_compile",
]
