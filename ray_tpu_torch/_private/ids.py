"""Unique identifiers for tasks, actors, objects, nodes, and jobs.

TPU-native analog of the reference's ID scheme (``src/ray/common/id.h``): the
reference embeds lineage in IDs (ObjectID = TaskID + return index) so that any
worker holding a ref can find the task that produces it. We keep that property:
an ``ObjectID`` is its producing ``TaskID`` plus a 4-byte big-endian return
index; a ``put`` object uses a random pseudo-task id with index ``2**31 + n``
mirroring ``ObjectID::FromIndex`` semantics.
"""

from __future__ import annotations

import os
import threading

_UNIQUE_LEN = 16  # bytes for Node/Job/Actor/Worker ids
_TASK_LEN = 16
_INDEX_LEN = 4
_OBJECT_LEN = _TASK_LEN + _INDEX_LEN

PUT_INDEX_BASE = 2**31


class BaseID:
    """Immutable byte-string identifier with hex printing."""

    __slots__ = ("_bytes", "_hash")
    _LENGTH = _UNIQUE_LEN

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self._LENGTH:
            raise ValueError(
                f"{type(self).__name__} requires {self._LENGTH} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        self._hash = hash(id_bytes)

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(os.urandom(cls._LENGTH))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls._LENGTH)

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self._LENGTH

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"


class JobID(BaseID):
    _LENGTH = 4


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    _LENGTH = _TASK_LEN

    # Fast unique ids for the hot submit path: one urandom prefix per
    # process + a counter, instead of a 16-byte urandom syscall per task
    # (~80us/call of driver CPU at high call rates). Fork-safe: the
    # prefix regenerates when the pid changes (zygote-forked workers
    # would otherwise mint identical id streams).
    _fast_prefix: bytes = b""
    _fast_pid: int = -1
    _fast_counter = None
    _fast_lock = threading.Lock()

    @classmethod
    def fast_unique(cls) -> "TaskID":
        pid = os.getpid()
        if pid != cls._fast_pid:
            with cls._fast_lock:
                if pid != cls._fast_pid:  # double-checked: one init wins
                    import itertools

                    cls._fast_prefix = os.urandom(_TASK_LEN - 8)
                    cls._fast_counter = itertools.count()
                    cls._fast_pid = pid
        # next() on an itertools.count is atomic under the GIL.
        return cls(cls._fast_prefix
                   + next(cls._fast_counter).to_bytes(8, "little"))


class ObjectID(BaseID):
    """TaskID (16B) + big-endian return index (4B)."""

    _LENGTH = _OBJECT_LEN

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(_INDEX_LEN, "big"))

    @classmethod
    def for_put(cls, put_counter: int) -> "ObjectID":
        # Puts get a fresh pseudo-task id; index space is disjoint from returns.
        return cls(
            os.urandom(_TASK_LEN)
            + (PUT_INDEX_BASE + put_counter % PUT_INDEX_BASE).to_bytes(_INDEX_LEN, "big")
        )

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_TASK_LEN:], "big")

    def is_put(self) -> bool:
        return self.return_index() >= PUT_INDEX_BASE


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
