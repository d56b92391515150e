"""Per-host shared-memory object store (plasma equivalent).

The reference implements this tier in C++ (``src/ray/object_manager/plasma/``:
``PlasmaStore``, mmap'd dlmalloc arenas, UDS clients with fd-passing). Our
TPU-native design keeps the same semantics — create/seal/get/release with
zero-copy reads shared across every process on a host — but uses two
interchangeable backends:

  * ``NativeStore`` — the C++ arena allocator in ``native/shm_store.cc``
    (one big POSIX shm segment, offset-based allocation, lock in shared
    memory). Preferred when the compiled extension is available.
  * ``PyShmStore`` — one POSIX shm segment per object via
    ``multiprocessing.shared_memory``. Always available; slightly higher
    per-object syscall cost but identical semantics.

Both give readers a writable-mapped ``memoryview`` over the same physical
pages the writer filled — the property the TPU data path needs so host
buffers can feed ``jax.device_put`` without a copy.

Object layout inside the segment: raw payload bytes produced by
``serialization.dumps_into`` (msgpack meta header + pickle5 out-of-band
buffers). Sealing is tracked by the store index, not in-band.
"""

from __future__ import annotations

import os
import threading
from multiprocessing import shared_memory, resource_tracker
from typing import Dict, Optional

from . import failpoints
from .ids import ObjectID

_PREFIX = "rtpt"


def spill_path(session_dir: str, object_id: ObjectID) -> str:
    """Deterministic spill-file location for an object.

    The GCS writes spill files here and every process on the head host
    (agents, workers answering chunk fetches) derives the same path from
    (session_dir, oid) alone — serve-from-spill needs no path exchange.
    """
    return os.path.join(session_dir, "spill", object_id.hex() + ".bin")


class SpillIOBudget:
    """One byte budget for every spill-tier read in this process.

    Striped chunk serves (many pullers preading one spilled object) and
    full restores draw from the same bucket: at most ``limit`` bytes of
    spill IO admitted at once, extra readers queue. Admission is
    at-least-one — a single read larger than the whole budget still runs
    (alone) instead of deadlocking. Counters double as the spill
    accounting surface (``stats()``): serves and restores are separate
    lanes of one budget, which is the invariant the object-plane-v2
    tests pin down.
    """

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self._inflight = 0
        self._cond = threading.Condition()
        self._stats = {"serve_reads": 0, "serve_bytes": 0,
                       "restore_reads": 0, "restore_bytes": 0,
                       "queued": 0}

    def acquire(self, nbytes: int, kind: str = "serve"):
        with self._cond:
            if self._inflight + nbytes > self.limit and self._inflight > 0:
                self._stats["queued"] += 1
                while self._inflight > 0 and \
                        self._inflight + nbytes > self.limit:
                    self._cond.wait(timeout=1.0)
            self._inflight += nbytes
            self._stats[f"{kind}_reads"] += 1
            self._stats[f"{kind}_bytes"] += nbytes

    def release(self, nbytes: int):
        with self._cond:
            self._inflight -= nbytes
            self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            out = dict(self._stats)
            out["inflight"] = self._inflight
            out["limit"] = self.limit
            return out


_spill_budget: Optional[SpillIOBudget] = None
_spill_budget_lock = threading.Lock()


def spill_budget(limit: int = 0) -> SpillIOBudget:
    """Process-global spill IO budget (created on first use)."""
    global _spill_budget
    with _spill_budget_lock:
        if _spill_budget is None:
            if limit <= 0:
                from .config import config
                limit = config().spill_read_budget
            _spill_budget = SpillIOBudget(limit)
        return _spill_budget


def spill_io_stats() -> dict:
    """Spill accounting snapshot; zeros before any spill IO happened."""
    with _spill_budget_lock:
        b = _spill_budget
    if b is None:
        return {"serve_reads": 0, "serve_bytes": 0, "restore_reads": 0,
                "restore_bytes": 0, "queued": 0, "inflight": 0, "limit": 0}
    return b.stats()


class _SpillData:
    """Lazy pread window over a spill file, shaped like the whole-object
    memoryview the serve paths slice.

    Supports exactly the contract ``serve_obj_fetch`` /
    ``_serve_conn_blocking`` rely on: ``len(data)`` is the object size
    and ``data[off:off+ln]`` yields that chunk's bytes — here via
    ``os.pread`` against a shared fd (pread is positionless, so
    concurrent serve threads share one descriptor safely). A short read
    (file truncated or unlinked under us — eviction vs. serve race)
    raises ``OSError``; the serve paths translate that into a retryable
    chunk miss instead of shipping garbage.
    """

    __slots__ = ("_path", "_nbytes", "_budget", "_fd", "_lock")

    def __init__(self, path: str, nbytes: int,
                 budget: Optional[SpillIOBudget] = None):
        self._path = path
        self._nbytes = int(nbytes)
        self._budget = budget
        self._fd: Optional[int] = None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._nbytes

    def _ensure_fd(self) -> int:
        with self._lock:
            if self._fd is None:
                self._fd = os.open(self._path, os.O_RDONLY)
            return self._fd

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("spill view supports slice reads only")
        start, stop, step = key.indices(self._nbytes)
        if step != 1:
            raise ValueError("spill view reads must be contiguous")
        ln = max(0, stop - start)
        if ln == 0:
            return b""
        act = None
        if failpoints.active():
            # Spill-read boundary: ``raise`` is an injected IO error
            # (FailpointError is a ConnectionError, hence an OSError —
            # the same class a vanished file raises); ``short`` truncates
            # the pread result so the short-read validation below trips.
            act = failpoints.fire("store.spill.read")
        if self._budget is not None:
            self._budget.acquire(ln, "serve")
        try:
            buf = os.pread(self._ensure_fd(), ln, start)
        finally:
            if self._budget is not None:
                self._budget.release(ln)
        if act in ("short", "drop"):
            buf = buf[:len(buf) // 2]
        if len(buf) != ln:
            raise OSError(
                f"short spill read: wanted {ln} at {start}, got {len(buf)}")
        return buf

    def release(self):
        self.close()

    def close(self):
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass


class SpillView:
    """Serve-from-spill view: chunk-granular reads straight off the
    spill tier, no arena restore.

    Duck-types :class:`PlasmaObjectView` for the chunk-serve paths —
    ``.data`` (sliceable, sized) and ``.close()`` — so a resolver can
    hand it to ``serve_obj_fetch`` / the blocking serve loop unchanged.
    Restoring a multi-GB spilled object into RAM before the first chunk
    moves is the broadcast cliff object plane v2 removes: the serve side
    now preads exactly the requested chunk.
    """

    __slots__ = ("data",)

    def __init__(self, path: str, nbytes: int,
                 budget: Optional[SpillIOBudget] = None):
        self.data = _SpillData(path, nbytes,
                               budget if budget is not None
                               else spill_budget())

    def transfer(self):
        return None

    def close(self):
        self.data.close()


def open_spilled(session_dir: str, object_id: ObjectID,
                 nbytes: int) -> Optional[SpillView]:
    """A :class:`SpillView` over the object's spill file, or None when
    the file is absent (not spilled here / already restored+unlinked)."""
    path = spill_path(session_dir, object_id)
    try:
        if nbytes <= 0:
            nbytes = os.path.getsize(path)
        elif not os.path.exists(path):
            return None
    except OSError:
        return None
    return SpillView(path, nbytes)


class _Segment(shared_memory.SharedMemory):
    """SharedMemory whose finalizer tolerates live zero-copy exports.

    CPython's ``SharedMemory.__del__`` raises a noisy "Exception ignored:
    BufferError: cannot close exported pointers exist" at interpreter
    shutdown when zero-copy views (numpy arrays over shm) are still alive.
    That teardown order is fine for us — the mapping dies with the process —
    so our own segments swallow it. Scoped as a subclass so user code's
    SharedMemory keeps stdlib behavior.
    """

    def __del__(self):
        try:
            self.close()
        except (BufferError, OSError):
            pass


def _untrack(shm: shared_memory.SharedMemory):
    """Stop the resource_tracker from owning this segment.

    The store's lifetime is managed by the head node process (the GCS deletes
    segments on final deref / shutdown); per-process resource trackers would
    otherwise unlink segments when any single process exits.
    """
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception:
        pass


class PlasmaObjectView:
    """A sealed object: zero-copy view plus the backing handle.

    ``release_cb`` (arena-backed stores) drops the block's reader pin;
    call ``close()`` exactly once, or hand the pin to the deserialized
    value's buffers via ``serialization.deserialize(..., pin=...)`` and
    call ``transfer()`` instead.
    """

    __slots__ = ("data", "_shm", "_release_cb")

    def __init__(self, data: memoryview, shm=None, release_cb=None):
        self.data = data
        self._shm = shm
        self._release_cb = release_cb

    def transfer(self):
        """Detach the release callback (ownership moved to a _Pin)."""
        cb = self._release_cb
        self._release_cb = None
        return cb

    def close(self):
        try:
            self.data.release()
        except BufferError:
            pass
        if self._shm is not None:
            self._shm.close()
        cb = self._release_cb
        self._release_cb = None
        if cb is not None:
            cb()


class PyShmStore:
    """One shm segment per object. Segment name is derived from the id."""

    def __init__(self, session_name: str):
        self._session = session_name
        # Objects this process created but not yet sealed.
        self._pending: Dict[ObjectID, shared_memory.SharedMemory] = {}
        # Cache of attached segments (reader side).
        self._attached: Dict[ObjectID, shared_memory.SharedMemory] = {}
        self._lock = threading.Lock()

    def _name(self, object_id: ObjectID) -> str:
        return f"{_PREFIX}_{self._session}_{object_id.hex()[:32]}"

    def create(self, object_id: ObjectID, nbytes: int) -> memoryview:
        nbytes = max(nbytes, 1)
        shm = _Segment(
            name=self._name(object_id), create=True, size=nbytes
        )
        _untrack(shm)
        with self._lock:
            self._pending[object_id] = shm
        return shm.buf[:nbytes]

    def seal(self, object_id: ObjectID):
        with self._lock:
            shm = self._pending.pop(object_id, None)
            if shm is not None:
                self._attached[object_id] = shm

    def abort(self, object_id: ObjectID):
        with self._lock:
            shm = self._pending.pop(object_id, None)
        if shm is not None:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                pass

    def get(self, object_id: ObjectID, nbytes: int) -> Optional[PlasmaObjectView]:
        """Attach to a sealed object. Returns None if the segment is gone."""
        with self._lock:
            shm = self._attached.get(object_id)
        if shm is None:
            try:
                shm = _Segment(name=self._name(object_id))
            except FileNotFoundError:
                return None
            _untrack(shm)
            with self._lock:
                self._attached.setdefault(object_id, shm)
        return PlasmaObjectView(shm.buf[:nbytes], None)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            if object_id in self._attached:
                return True
        try:
            shm = _Segment(name=self._name(object_id))
        except FileNotFoundError:
            return False
        _untrack(shm)
        with self._lock:
            self._attached.setdefault(object_id, shm)
        return True

    def delete(self, object_id: ObjectID):
        with self._lock:
            shm = self._attached.pop(object_id, None)
        if shm is None:
            try:
                shm = _Segment(name=self._name(object_id))
                _untrack(shm)
            except FileNotFoundError:
                return
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
        try:
            shm.close()
        except BufferError:
            pass

    def close(self):
        with self._lock:
            for shm in list(self._pending.values()) + list(self._attached.values()):
                try:
                    shm.close()
                except BufferError:
                    # A zero-copy view (e.g. a numpy array backed by this
                    # segment) is still alive in user code; leave the mapping
                    # to process exit.
                    pass
            self._pending.clear()
            self._attached.clear()


def _try_native_store(session_name: str, capacity: int, populate: int):
    try:
        from .shm_native import NativeStore

        return NativeStore(session_name, capacity, populate=populate)
    except Exception:
        return None


def make_store(session_name: str, capacity: int = 0, prefer_native: bool = True,
               populate: int = 0):
    """Create the host object store client for this process.

    ``populate`` (bytes) starts the background page-commit sweep over that
    much of the arena and should be set by exactly one process per host
    (the GCS/head): tmpfs page commits are arena-wide, and N concurrent
    populaters just multiply the kernel work.
    """
    # Per-node arena isolation: real deployments get one arena per host
    # naturally; fake multi-node clusters set RAY_TPU_TORCH_STORE_SUFFIX per
    # simulated node so cross-"node" object transfer paths are exercised
    # for real (reference: fake_multi_node provider testing, cluster_utils).
    session_name += os.environ.get("RAY_TPU_TORCH_STORE_SUFFIX", "")
    if prefer_native and not os.environ.get("RAY_TPU_TORCH_DISABLE_NATIVE_STORE"):
        store = _try_native_store(session_name, capacity, populate)
        if store is not None:
            return store
    return PyShmStore(session_name)
