"""Serialization: cloudpickle + pickle5 out-of-band buffers into shared memory.

Mirrors the reference's ``SerializationContext``
(``python/ray/_private/serialization.py:122``): cloudpickle for arbitrary
Python objects, custom reducers for ``ObjectRef``/``ActorHandle`` (installed
by ``worker.py``), and zero-copy handling of large binary buffers (numpy
arrays and CPU torch tensors) which land 64-byte-aligned in the
shared-memory segment and come back as views of it (a tensor through
``torch.from_numpy``; bf16 travels as its ``uint16`` bits). A CUDA tensor
takes torch's own reduction, which restores it onto the receiving
process's card and raises in a process without one.

Segment layout::

    u32 header_len | msgpack header | padding | buffer_0 | padding | buffer_1 ...

header = {"p": pickle_bytes, "o": [buffer offsets], "l": [buffer lengths]}
"""

from __future__ import annotations

import copyreg
import hashlib
import io
import pickle
import sys as _sys
import struct
import threading
import traceback
import types
from typing import Any, List, Optional, Tuple

import cloudpickle
import msgpack

_U32 = struct.Struct("<I")
_ALIGN = 64

# Side-effect ledger for the two-attempt serialize below: pickling an
# ObjectRef sends the borrower's +1 IMMEDIATELY (worker.ObjectRef.__reduce__
# — sender-side incref, see its docstring). If the stdlib attempt pickles
# some refs and then fails on a later object, the cloudpickle retry re-fires
# those increfs; the undo callbacks recorded here balance the first
# attempt's, or a ref copy that never reaches a receiver leaks its count.
_REDUCE_LEDGER = threading.local()


def note_reduce_undo(undo) -> None:
    lst = getattr(_REDUCE_LEDGER, "lst", None)
    if lst is not None:
        lst.append(undo)


# --------------------------------------------------------------------------
# Definition-export cache (reference: ``_private/function_manager.py`` —
# the driver exports each function/actor-class definition to GCS ONCE and
# every later message carries only its id). Here the same idea covers any
# ``__main__``-defined class or function reached by the cloudpickle
# fallback: the first serialize ships the full by-value definition to the
# GCS KV under a content hash; every subsequent serialize emits a ~60-byte
# token. Receivers resolve the token via their local cache or one KV
# fetch. Without this, EVERY serve-handle call or task arg holding a
# driver-script class re-pickles (and re-ships) the whole class body —
# a serve handle regression was profiled exactly here (~0.29 ms of
# cloudpickle per call vs ~20 us for the tokenized form).
#
# Semantics: unlike the reference's frozen-at-registration export table,
# a cached token is only reused while a cheap fingerprint of the
# definition still matches — mutating a ``__main__`` class body /
# attribute or a function's code/defaults/closure between sends
# re-exports under the NEW content hash, so workers never silently run
# stale code (the notebook re-def case).

_EXPORT_NS = "defexports"
_export_lock = threading.Lock()
# id(obj) -> (token, weakref, fingerprint). Weak so the cache never pins
# a definition (a __main__ lambda closing over a large array must stay
# collectable); the weakref doubles as the id-reuse guard — an entry only
# counts if its referent IS the object being serialized. KV blobs are
# content-hashed, so re-exporting an identical definition rewrites the
# same key (the GCS export table is cluster-lifetime, as in the
# reference).
_export_by_id: dict = {}
import weakref as _weakref
_export_by_token: "_weakref.WeakValueDictionary" = \
    _weakref.WeakValueDictionary()


def _definition_fingerprint(obj):
    """Cheap mutation detector for a cached export. Identity-based: any
    rebinding of a class attribute (monkeypatched method, changed class
    attr) or of a function's code/defaults/closure cell produces new
    constituent objects, so the id tuple changes. False negatives need a
    recycled id at the same key — vanishingly rare for a notebook edit —
    and cost only a stale-token reuse; false positives just re-export."""
    try:
        if isinstance(obj, types.FunctionType):
            cells = ()
            if obj.__closure__:
                ids = []
                for c in obj.__closure__:
                    try:
                        ids.append(id(c.cell_contents))
                    except ValueError:  # empty cell
                        ids.append(-1)
                cells = tuple(ids)
            return (id(obj.__code__), id(obj.__defaults__),
                    id(obj.__kwdefaults__), cells)
        return tuple((k, id(v)) for k, v in obj.__dict__.items())
    except Exception:
        return object()  # un-fingerprintable: never matches → re-export


def _id_cache_get(obj):
    ent = _export_by_id.get(id(obj))
    if ent is None:
        return None
    token, wr, fp = ent
    if wr() is not obj:
        _export_by_id.pop(id(obj), None)  # id reuse after GC — stale entry
        return None
    if fp != _definition_fingerprint(obj):
        # Definition mutated since export: drop the token so this send
        # re-exports the current body under its new content hash.
        _export_by_id.pop(id(obj), None)
        return None
    return token


def _id_cache_put(obj, token: str) -> None:
    i = id(obj)
    ent = None

    def _evict(_):
        # Pop only OUR entry: after CPython id reuse, this (delayed) GC
        # callback must not evict a NEW object's live cache entry.
        if _export_by_id.get(i) is ent:
            _export_by_id.pop(i, None)

    try:
        wr = _weakref.ref(obj, _evict)
    except TypeError:
        return  # not weakref-able: never cached, always re-tokenized
    ent = (token, wr, _definition_fingerprint(obj))
    _export_by_id[i] = ent


def reset_export_cache() -> None:
    """Called on every new driver session (Worker construction): tokens
    cached against a previous session's GCS KV must not leak into a fresh
    cluster whose KV never saw the export — the receiver would fail
    resolution. Worker processes are freshly forked, so this matters for
    the re-init()-ed driver/notebook case."""
    with _export_lock:
        _export_by_id.clear()
        _export_by_token.clear()


_EMPTY_ARGS_CACHE: Optional[bytes] = None


def empty_args_bytes() -> bytes:
    """THE canonical wire form of ((), {}) — remote._prepare_args sends
    it for every no-arg call and worker_main._load_args matches it to
    skip the unpickle; a single definition site keeps the bytes from
    silently drifting apart (which would quietly disable the fast path).
    """
    global _EMPTY_ARGS_CACHE
    if _EMPTY_ARGS_CACHE is None:
        _EMPTY_ARGS_CACHE = serialize(((), {})).to_bytes()
    return _EMPTY_ARGS_CACHE


def _export_kv():
    """GCS KV accessors of the connected worker, or None off-cluster."""
    try:
        from . import worker as _w

        w = _w._global_worker
        if w is None or getattr(w, "gcs", None) is None:
            return None
        return w
    except Exception:
        return None


def _load_export(token: str):
    with _export_lock:
        obj = _export_by_token.get(token)
    if obj is not None:
        return obj
    w = _export_kv()
    blob = w.kv_get(token, ns=_EXPORT_NS) if w is not None else None
    if blob is None:
        raise RuntimeError(
            f"definition export {token!r} not found (GCS unreachable or "
            "export was never published)")
    obj = cloudpickle.loads(blob)
    # First insert wins: concurrent loads of the same token on a multi-
    # threaded worker must converge on ONE class object, or isinstance
    # checks across tasks split.
    with _export_lock:
        winner = _export_by_token.get(token)
        if winner is None:
            _export_by_token[token] = winner = obj
            _id_cache_put(winner, token)
    return winner


class _ExportPickler(cloudpickle.CloudPickler):
    """cloudpickle that tokenizes ``__main__`` classes/functions (and
    reduces tensors through ``_TensorFirst``, set below)."""

    def reducer_override(self, obj):
        if (isinstance(obj, (type, types.FunctionType))
                and getattr(obj, "__module__", None) == "__main__"):
            with _export_lock:
                token = _id_cache_get(obj)
            if token is None:
                w = _export_kv()
                if w is not None:
                    try:
                        blob = cloudpickle.dumps(obj, protocol=5)
                        token = ("dx:" + getattr(obj, "__qualname__", "?")
                                 + ":" + hashlib.sha1(blob).hexdigest())
                        w.kv_put(token, blob, ns=_EXPORT_NS)
                        # Shadowed for GCS-restart replay (see
                        # Worker._kv_exports): the id cache below never
                        # re-sends, so a crash-lost export would orphan
                        # every consumer of this token.
                        w.note_export(_EXPORT_NS, token, blob)
                        with _export_lock:
                            _id_cache_put(obj, token)
                            _export_by_token.setdefault(token, obj)
                    except Exception:
                        token = None  # export failed: ship by value
            if token is not None:
                return (_load_export, (token,))
        return super().reducer_override(obj)


# ------------------------------------------------------- torch tensors
# CPU tensors of these dtypes travel as a numpy array over the same bytes,
# so pickle protocol 5 ships their data out of band (into the arena) and
# the receiver wraps the arena view without a copy. bf16 has no numpy
# dtype: its bits travel as uint16.
_TENSOR_DTYPES = ("bool", "uint8", "int8", "int16", "int32", "int64",
                  "float16", "float32", "float64", "complex64",
                  "complex128", "bfloat16")


def _rebuild_cpu_tensor(arr, dtype: str, requires_grad: bool,
                        parameter: bool = False):
    import warnings

    import numpy as np
    import torch

    if dtype == "bfloat16":
        arr = arr.view(np.int16)
    with warnings.catch_warnings():
        # an arena view is read-only; the tensor shares it, as the numpy
        # array the reference hands back does
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(t):
    name = str(t.dtype).rpartition(".")[2]
    if (t.device.type != "cpu" or t.layout != _torch().strided
            or name not in _TENSOR_DTYPES or t.is_quantized):
        return t.__reduce_ex__(5)  # torch's own (CUDA: onto this card)
    import numpy as np

    d = t.detach().resolve_conj().resolve_neg().contiguous()
    arr = (d.view(_torch().int16).numpy().view(np.uint16)
           if name == "bfloat16" else d.numpy())
    return (_rebuild_cpu_tensor, (arr, name, bool(t.requires_grad),
                                  type(t) is not _torch().Tensor))


def _torch():
    return _sys.modules["torch"]


class _TensorFirst:
    """Dispatch table that reduces plain tensors and parameters through
    ``_reduce_tensor`` and defers every other type to ``base``."""

    def __init__(self, base):
        self.base = base

    def __getitem__(self, cls):
        # Another thread may be importing torch: sys.modules then holds a
        # module without its attributes yet, and no value of their types
        # can exist.
        torch = _sys.modules.get("torch")
        nn = getattr(torch, "nn", None)
        if cls is getattr(torch, "Tensor", None) \
                or cls is getattr(nn, "Parameter", None):
            return _reduce_tensor
        return self.base[cls]


class _TensorPickler(pickle.Pickler):
    dispatch_table = _TensorFirst(copyreg.dispatch_table)


def _dumps(value, buffer_callback) -> bytes:
    if "torch" not in _sys.modules:
        # no tensor can exist in this process: the C fast path as is
        return pickle.dumps(value, protocol=5,
                            buffer_callback=buffer_callback)
    buf = io.BytesIO()
    _TensorPickler(buf, protocol=5, buffer_callback=buffer_callback
                   ).dump(value)
    return buf.getvalue()


_ExportPickler.dispatch_table = _TensorFirst(
    cloudpickle.CloudPickler.dispatch_table)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


# Pickle streams at least this large are stored out-of-line in the
# segment layout ("po"/"pl") instead of inline in the msgpack header —
# see SerializedObject._layout.
_PICKLE_OOL_MIN = 64 * 1024


class SerializedObject:
    """Pickle bytes plus out-of-band buffers, ready to be written.

    The shared-memory segment layout (header + aligned buffer offsets) is
    computed LAZILY: the direct arg lane ships ``pickle_bytes`` and the
    raw ``buffers`` straight onto a connection (scatter-gather frame) and
    never needs offsets, so the two msgpack header packs + offset
    fix-point would be pure waste on that path — ``data_size`` routes the
    threshold decision without them.
    """

    __slots__ = ("pickle_bytes", "buffers", "_header", "_offsets", "_total",
                 "_po", "raw")

    def __init__(self, pickle_bytes: bytes,
                 buffers: List[pickle.PickleBuffer], raw: bool = False):
        # ``raw``: pickle_bytes IS the value (a large bytes blob stored
        # verbatim — checkpoint shards, tokenizer files, packed pages).
        # Skipping pickle on both sides saves a full scan + copy each way
        # at exactly the sizes where it costs hundreds of ms.
        self.pickle_bytes = pickle_bytes
        self.raw = raw
        self._po = None
        if not buffers and not raw and len(pickle_bytes) < _PICKLE_OOL_MIN:
            # Buffer-less values (every small task arg/result) need no
            # offset fix-point: one header pack instead of two — this
            # runs on EVERY control-plane message, visible at benchmark
            # rates on both the submit and reply paths.
            self.buffers = []
            self._header = msgpack.packb(
                {"p": pickle_bytes, "o": [], "l": []}, use_bin_type=True)
            self._offsets = []
            self._total = 4 + len(self._header)
            return
        self.buffers = [b.raw() for b in buffers]
        self._header = None
        self._offsets = None
        self._total = None

    @property
    def data_size(self) -> int:
        """Payload bytes (pickle + buffers), without segment-layout
        padding — the cheap routing size for threshold decisions."""
        n = len(self.pickle_bytes)
        for b in self.buffers:
            n += len(b)
        return n

    @property
    def total_size(self) -> int:
        if self._total is None:
            self._layout()
        return self._total

    def _layout(self):
        offsets: List[int] = []
        lens = [len(b) for b in self.buffers]
        # Large pickle streams (a big bytes/str value pickles INLINE) go
        # out-of-line like a buffer ("po"/"pl" offsets) instead of riding
        # inside the msgpack header as a bin: packing copies the bin into
        # the header and unpacking copies it back out — a full extra copy
        # each way at exactly the sizes where it hurts (measured ~0.25 s
        # per side for a 256 MB blob).
        big = self.raw or len(self.pickle_bytes) >= _PICKLE_OOL_MIN
        probe = {"o": [], "l": lens}
        if self.raw:
            probe["rb"] = 1
        if big:
            probe["po"] = 0
            probe["pl"] = len(self.pickle_bytes)
        else:
            probe["p"] = self.pickle_bytes
        header = msgpack.packb(probe, use_bin_type=True)
        # Offsets depend on header length; header length depends on offsets'
        # encoded size. Fix-point in two passes (offset ints encode stably the
        # second time because we pad the data start to alignment and reserve
        # 16 bytes of int-growth slack per slot).
        pos = _align(4 + len(header) + 16 * (len(lens) + (1 if big else 0)))
        po = None
        if big:
            po = pos
            pos = _align(pos + len(self.pickle_bytes))
        for ln in lens:
            offsets.append(pos)
            pos = _align(pos + ln)
        final = {"o": offsets, "l": lens}
        if self.raw:
            final["rb"] = 1
        if big:
            final["po"] = po
            final["pl"] = len(self.pickle_bytes)
        else:
            final["p"] = self.pickle_bytes
        header = msgpack.packb(final, use_bin_type=True)
        first_slot = po if po is not None else (offsets[0] if offsets
                                                else None)
        if first_slot is not None and 4 + len(header) > first_slot:
            raise RuntimeError("serialization header overflow")
        self._header = header
        self._offsets = offsets
        self._po = po
        self._total = pos if (big or offsets) else 4 + len(header)

    def write_into(self, buf: memoryview):
        if self._header is None:
            self._layout()
        buf[:4] = _U32.pack(len(self._header))
        buf[4 : 4 + len(self._header)] = self._header
        if self._po is not None:
            buf[self._po : self._po + len(self.pickle_bytes)] = \
                self.pickle_bytes
        for off, b in zip(self._offsets, self.buffers):
            buf[off : off + len(b)] = b

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        self.write_into(memoryview(out))
        return bytes(out)


def serialize(value: Any) -> SerializedObject:
    # Fast path: the stdlib C pickler (3x cheaper than cloudpickle for the
    # hot arg/result shapes — tuples of arrays/scalars). It must not be
    # allowed to pickle ``__main__``-defined functions/classes BY REFERENCE
    # (the executing worker's ``__main__`` is the worker bootstrap, not the
    # driver script — the reference always routes through cloudpickle for
    # this reason, ``_private/serialization.py:122``): any by-ref global
    # record names its module, so a ``__main__`` marker in the bytes means
    # the value needs cloudpickle's by-value treatment. False positives
    # (the literal string in user data) just take the slow path.
    if type(value) is bytes and len(value) >= _PICKLE_OOL_MIN:
        # Large raw blob: store verbatim — pickling a big bytes value
        # copies it twice (dumps + the __main__ marker scan) and loads
        # copies it again, all for an identity transform.
        return SerializedObject(value, [], raw=True)
    buffers: List[pickle.PickleBuffer] = []
    prev = getattr(_REDUCE_LEDGER, "lst", None)
    _REDUCE_LEDGER.lst = undo = []
    try:
        pickled = _dumps(value, buffers.append)
        if b"__main__" not in pickled:
            return SerializedObject(pickled, buffers)
    except Exception:
        pass
    finally:
        _REDUCE_LEDGER.lst = prev
    for cb in undo:
        cb()
    buffers = []
    buf = io.BytesIO()
    _ExportPickler(buf, protocol=5, buffer_callback=buffers.append
                   ).dump(value)
    return SerializedObject(buf.getvalue(), buffers)


class _Pin:
    """Releases a shared-store reader pin when the last buffer dies."""

    __slots__ = ("release",)

    def __init__(self, release):
        self.release = release

    def __del__(self):
        cb = self.release
        self.release = None
        if cb is not None:
            cb()


class _PinnedBuffer:
    """Out-of-band buffer wrapper keeping its arena pin alive (PEP 688).

    Values unpickled zero-copy (numpy/jax arrays over shared memory) hold
    these via their buffer base chain; when the last one is collected the
    pin drops and the arena block becomes recyclable — plasma's
    client-side buffer release (``plasma/client.cc`` Release) without a
    store round-trip.
    """

    __slots__ = ("mv", "pin")

    def __init__(self, mv: memoryview, pin: "_Pin"):
        self.mv = mv
        self.pin = pin

    def __buffer__(self, flags):
        return memoryview(self.mv)


# _PinnedBuffer relies on the pure-Python buffer protocol (PEP 688,
# ``__buffer__``), which exists only on 3.12+. Earlier runtimes get a
# copy-out fallback: correctness over zero-copy (numpy's frombuffer would
# otherwise reject the wrapper with "a bytes-like object is required").
_HAS_PY_BUFFER_PROTOCOL = _sys.version_info >= (3, 12)


def deserialize(data: memoryview, pin=None) -> Any:
    data = memoryview(data)
    (header_len,) = _U32.unpack(data[:4])
    header = msgpack.unpackb(data[4 : 4 + header_len], raw=False)
    if "x" in header:
        # Language-neutral payload (C++ Client::put / cross_language.
        # put_xlang): the value is msgpack, not pickle — readable from
        # any worker language.
        if pin is not None:
            pin()
        return msgpack.unpackb(header["x"], raw=False)
    # Out-of-line pickle stream (large values): a zero-copy view into the
    # data, so the pin must survive until loads() has consumed it —
    # released in the finally below, never before.
    po = header.get("po")
    pk = data[po : po + header["pl"]] if po is not None else header["p"]
    if header.get("rb"):
        # Raw bytes blob stored verbatim (no pickle): one memcpy out of
        # the segment and done.
        try:
            return bytes(pk)
        finally:
            if pin is not None:
                pin()
    release_after = pin
    if pin is not None and header["o"] and not _HAS_PY_BUFFER_PROTOCOL:
        # Pre-3.12: copy the out-of-band buffers out of the arena so the
        # returned value holds no pin.
        buffers = [bytes(data[off : off + ln])
                   for off, ln in zip(header["o"], header["l"])]
    elif pin is not None and header["o"]:
        holder = _Pin(pin)
        release_after = None  # ownership moved to the value's buffers
        buffers = [
            _PinnedBuffer(data[off : off + ln], holder)
            for off, ln in zip(header["o"], header["l"])
        ]
    else:
        buffers = [
            data[off : off + ln] for off, ln in zip(header["o"], header["l"])
        ]
    try:
        return pickle.loads(pk, buffers=buffers)
    finally:
        if release_after is not None:
            release_after()


from .config import config as _cfg, on_config_change as _on_cfg_change

# Match the reference's 100KB inline-return limit (flag:
# RAY_TPU_TORCH_INLINE_THRESHOLD). Read via ``serialization.INLINE_THRESHOLD``
# (module attribute), not by-value import — the refresh hook below
# re-snapshots it when ``init(_system_config=...)`` overrides flags after
# this module was imported. DIRECT_ARG_THRESHOLD caps the actor-call
# direct arg lane (out-of-band scatter-gather frames on the actor
# connection, protocol.pack_with_buffers).
INLINE_THRESHOLD = _cfg().inline_threshold
DIRECT_ARG_THRESHOLD = _cfg().direct_arg_threshold


def _refresh_flags():
    global INLINE_THRESHOLD, DIRECT_ARG_THRESHOLD
    INLINE_THRESHOLD = _cfg().inline_threshold
    DIRECT_ARG_THRESHOLD = _cfg().direct_arg_threshold


_on_cfg_change(_refresh_flags)


# Transport counters for the argument data plane (read via
# ``transport_stats()``; asserted by the tier-1 data-plane smoke test and
# printed by benchmarks/microbench.py). Driver-side, per-process; plain
# ints under the GIL — the hot path pays one dict-incref each.
TRANSPORT_STATS = {
    "inline_args": 0,       # args rode the control frame (msgpack bin)
    "direct_lane_args": 0,  # args rode the actor conn out-of-band
    "direct_lane_bytes": 0,
    "shm_args": 0,          # args went through shm create + GCS register
    # Cooperative broadcast (the P2P chunk plane, _private/broadcast.py):
    # serve side — SG serves slice the pinned view with no bytes() copy;
    # a nonzero copy counter means a peer fell back to the legacy path.
    "bcast_sg_chunks_served": 0,
    "bcast_copy_chunks_served": 0,
    "bcast_bytes_served": 0,
    # pull side — chunk-granular retries and coalesced concurrent gets.
    "bcast_chunk_retries": 0,
    "pull_dedup_hits": 0,
    # Versioned weight broadcast (rl/podracer.py): driver-side puts per
    # published version — the smoke test asserts exactly one put per
    # version (re-shipping a copy per runner is the anti-pattern).
    "weight_bcast_puts": 0,
    # Reference plane: outbound GCS wait subscriptions. The per-ref lane
    # pays one obj_wait frame per unresolved ref; the batched lane pays
    # one obj_waits frame per burst (tests assert a 1k-ref wait stays
    # O(1) here — the frame counters are the proof surface).
    "obj_wait_frames": 0,
    "obj_waits_frames": 0,
}


def transport_stats() -> dict:
    """Snapshot of this process's argument-transport counters."""
    return dict(TRANSPORT_STATS)


def reset_transport_stats() -> None:
    for k in TRANSPORT_STATS:
        TRANSPORT_STATS[k] = 0


class DynamicReturns:
    """Descriptor value of a ``num_returns="dynamic"`` task's primary
    return: the ordered return-object ids the generator produced
    (reference: ObjectRefGenerator for dynamic generator tasks,
    ``_raylet.pyx:281``). The driver resolves this into an
    ``ObjectRefGenerator``."""

    __slots__ = ("oids",)

    def __init__(self, oids):
        self.oids = list(oids)

    def __reduce__(self):
        return (DynamicReturns, (self.oids,))


class TaskError(Exception):
    """An exception raised inside a task, re-raised at ``get`` on the caller.

    Equivalent of the reference's ``RayTaskError``
    (``python/ray/exceptions.py``): carries the remote traceback text and the
    original cause when it is picklable.
    """

    def __init__(self, function_name: str, tb_str: str, cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.tb_str = tb_str
        self.cause = cause
        super().__init__(tb_str)

    def __str__(self):
        return (
            f"task {self.function_name} failed with the following error:\n"
            f"{self.tb_str}"
        )

    def __reduce__(self):
        return (TaskError, (self.function_name, self.tb_str, self.cause))


class WorkerCrashedError(Exception):
    """The worker process executing the task died unexpectedly."""


class ActorExitSignal(BaseException):
    """Raised by ``ray_tpu_torch.exit_actor()``: the current call completes
    with ``None`` and the actor process exits after the reply drains
    (reference: ``ray.actor.exit_actor`` semantics)."""


class ActorDiedError(Exception):
    """The actor is dead (crashed, killed, or out of restarts)."""


class ObjectLostError(Exception):
    """The object's value was lost and could not be reconstructed."""


class GetTimeoutError(TimeoutError):
    """``get`` exceeded its timeout."""


class TaskCancelledError(Exception):
    """The task was cancelled before or during execution."""


def pack_error(function_name: str, exc: BaseException) -> SerializedObject:
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        err = TaskError(function_name, tb, exc)
        return serialize(err)
    except Exception:
        # Cause not picklable — drop it, keep the traceback text.
        return serialize(TaskError(function_name, tb, None))
