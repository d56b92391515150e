"""Serialization debugging: find WHY an object won't pickle.

Reference: ``python/ray/util/check_serialize.py``
(``ray.util.inspect_serializability``) — when cloudpickle rejects a task
argument or captured closure, walk the object graph (closure globals /
nonlocals for functions, members for everything else) and report the
innermost culprit instead of cloudpickle's opaque top-level error.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Optional, Set, TextIO, Tuple

import cloudpickle


class FailureTuple:
    """One non-serializable node: the object, the variable name it was
    reached by, and the object holding the reference."""

    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return (f"FailTuple({self.name} [obj={self.obj!r}, "
                f"parent={self.parent!r}])")


def _serializable(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


class _Report:
    def __init__(self, out: Optional[TextIO]):
        self.out = out
        self.level = 0

    def line(self, msg: str):
        if self.out is not None:
            print("    " * self.level + msg, file=self.out)


def _walk(obj: Any, name: str, depth: int, parent: Any,
          failures: List[FailureTuple], seen: Set[int], rep: _Report
          ) -> bool:
    """Returns True when ``obj`` serializes; records the innermost
    failure otherwise."""
    if id(obj) in seen:
        return True
    seen.add(id(obj))
    if _serializable(obj):
        return True
    rep.line(f"Serialization FAILED for {name} ({type(obj).__name__})")
    if depth <= 0:
        failures.append(FailureTuple(obj, name, parent))
        return False

    found_inner = False
    rep.level += 1
    if inspect.isfunction(obj):
        try:
            closure = inspect.getclosurevars(obj)
            captured = list(closure.globals.items()) + \
                list(closure.nonlocals.items())
        except (TypeError, ValueError):
            captured = []
        if captured:
            rep.line(f"checking {len(captured)} captured variables "
                     f"of {name}...")
        for sub_name, sub in captured:
            if not _walk(sub, sub_name, depth - 1, obj, failures, seen,
                         rep):
                found_inner = True
                break
    else:
        members: List[Tuple[str, Any]] = []
        try:
            members.extend(
                inspect.getmembers(obj, predicate=inspect.isfunction))
        except Exception:
            pass
        dct = getattr(obj, "__dict__", None)
        if isinstance(dct, dict):
            members.extend(dct.items())
        if isinstance(obj, dict):
            members.extend((str(k), v) for k, v in obj.items())
        elif isinstance(obj, (list, tuple, set)):
            members.extend((f"{name}[{i}]", v)
                           for i, v in enumerate(obj))
        for sub_name, sub in members:
            if sub_name.startswith("__") and sub_name.endswith("__"):
                continue
            if not _walk(sub, sub_name, depth - 1, obj, failures, seen,
                         rep):
                found_inner = True
                break
    rep.level -= 1
    if not found_inner:
        # This object is itself the leaf culprit.
        failures.append(FailureTuple(obj, name, parent))
    return False


def inspect_serializability(obj: Any, name: Optional[str] = None,
                            depth: int = 3,
                            print_file: Optional[TextIO] = None
                            ) -> Tuple[bool, Set[FailureTuple]]:
    """Check ``obj`` for serializability; on failure, return the
    innermost non-serializable members (reference:
    ``ray.util.inspect_serializability``).

    Returns (serializable, failure_set). ``print_file`` (e.g.
    ``sys.stdout``) enables the indented trace the reference prints.
    """
    rep = _Report(print_file)
    failures: List[FailureTuple] = []
    ok = _walk(obj, name or getattr(obj, "__name__", repr(obj)[:40]),
               depth, None, failures, set(), rep)
    return ok, set(failures)
