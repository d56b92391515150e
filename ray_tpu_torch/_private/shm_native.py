"""ctypes binding for the C++ arena object store (``ray_tpu_torch/native/shm_store.cc``).

Compiles the shared library on first use (g++ is part of the baked image;
pybind11 is not, hence the plain C ABI + ctypes). The compiled .so is cached
next to the source keyed by content hash, so rebuilds happen only when the
C++ changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
import time
from typing import Dict, Optional

from .ids import ObjectID
from .object_store import PlasmaObjectView

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
_lib = None
_lib_lock = threading.Lock()

from .config import config as _cfg

# Sparse mapping; pages commit on write (flag: RAY_TPU_TORCH_ARENA_BYTES).
DEFAULT_CAPACITY = _cfg().arena_bytes


def _build_lib() -> str:
    src = os.path.join(_NATIVE_DIR, "shm_store.cc")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    cache_dir = os.environ.get("RAY_TPU_TORCH_NATIVE_CACHE",
                               os.path.join(_PKG_DIR, "_build"))
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, f"libshm_store_{digest}.so")
    if not os.path.exists(out):
        tmp = out + f".tmp{os.getpid()}"
        # One-shot native build at store bootstrap (cached .so after):
        # runs before any plane serves traffic.  # raylint: disable=RTL101
        subprocess.run(  # raylint: disable=RTL101
            # -lrt: shm_open/shm_unlink live in librt before glibc 2.34
            # (a no-op link on newer hosts where they merged into libc).
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp,
             "-lpthread", "-lrt"],
            check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(_build_lib())
            except OSError:
                # The content-hash cache can hold a .so built on an
                # INCOMPATIBLE host (e.g. a newer glibc than this
                # container) — its presence blocks the rebuild, and
                # every process then silently falls back to the Python
                # shared_memory store, which cannot rescan the arena
                # after a GCS restart. Rebuild from source into a
                # host-local cache; exporting the env var points spawned
                # workers/agents at the same rebuilt lib.
                import tempfile

                # uid-scoped: a shared world-writable dir could be
                # pre-created/poisoned by another user (CDLL would load
                # their .so) or be unwritable for us.
                cache = os.path.join(tempfile.gettempdir(),
                                     f"ray_tpu_torch_native_cache_{os.getuid()}")
                os.environ["RAY_TPU_TORCH_NATIVE_CACHE"] = cache
                lib = ctypes.CDLL(_build_lib())
            lib.rtpt_store_open.restype = ctypes.c_void_p
            lib.rtpt_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                            ctypes.c_int]
            lib.rtpt_store_create.restype = ctypes.c_uint64
            lib.rtpt_store_create.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p,
                                              ctypes.c_uint64]
            lib.rtpt_store_seal.restype = ctypes.c_int
            lib.rtpt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.rtpt_store_lookup.restype = ctypes.c_int
            lib.rtpt_store_lookup.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rtpt_store_acquire.restype = ctypes.c_int
            lib.rtpt_store_acquire.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rtpt_store_release.restype = ctypes.c_int
            lib.rtpt_store_release.argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p]
            lib.rtpt_store_prefault_step.restype = ctypes.c_int
            lib.rtpt_store_prefault_step.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_uint64]
            lib.rtpt_store_delete.restype = ctypes.c_int
            lib.rtpt_store_delete.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p]
            lib.rtpt_store_list.restype = ctypes.c_uint64
            lib.rtpt_store_list.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
            lib.rtpt_store_set_populated.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_uint64]
            lib.rtpt_store_get_populated.restype = ctypes.c_uint64
            lib.rtpt_store_get_populated.argtypes = [ctypes.c_void_p]
            lib.rtpt_store_stats.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.rtpt_store_total_size.restype = ctypes.c_uint64
            lib.rtpt_store_total_size.argtypes = [ctypes.c_void_p]
            lib.rtpt_store_close.argtypes = [ctypes.c_void_p]
            lib.rtpt_store_unlink.argtypes = [ctypes.c_char_p]
            _lib = lib
        return _lib


class NativeStore:
    """Arena-backed store client; same interface as ``PyShmStore``."""

    def __init__(self, session_name: str, capacity: int = 0,
                 populate: int = 0):
        self.lib = get_lib()
        # shm name limit: keep it short and unique per session.
        tag = hashlib.sha1(session_name.encode()).hexdigest()[:16]
        self._name = f"/rtpt_{tag}".encode()
        cap = capacity or DEFAULT_CAPACITY
        self.handle = self.lib.rtpt_store_open(self._name, cap, 1)
        if not self.handle:
            raise OSError("failed to open native shm store")
        total = self.lib.rtpt_store_total_size(self.handle)
        # Python-side mmap of the same segment for zero-copy memoryviews
        # (ctypes pointers can't produce safe releasable buffers). The fd
        # stays open: page pre-commit falls back to fallocate() on
        # kernels without MADV_POPULATE_WRITE (pre-5.14).
        self._fd = os.open(f"/dev/shm{self._name.decode()}", os.O_RDWR)
        try:
            self._mmap = mmap.mmap(self._fd, total)
        except BaseException:
            os.close(self._fd)
            self._fd = None
            raise
        self._view = memoryview(self._mmap)
        self._total = total
        # Serializes close() against calls that can legally arrive after
        # shutdown (view release_cb from buffer GC, the prefault thread).
        self._close_lock = threading.Lock()
        # madvise must go through ctypes, NOT mmap.madvise: CPython holds
        # the GIL across the syscall, and MADV_POPULATE_WRITE of a cold
        # 64 MiB window takes ~25 ms — enough to stall the whole process
        # (IO loop included) once per window from the populate thread.
        # ctypes foreign calls release the GIL.
        anchor = (ctypes.c_char * 1).from_buffer(self._mmap)
        self._base_addr = ctypes.addressof(anchor)
        del anchor
        self._libc = ctypes.CDLL(None, use_errno=True)
        # Bytes of the arena this PROCESS's page tables already cover.
        self._walked = 0
        if populate:
            # Commit the first ``populate`` bytes of tmpfs pages up front
            # (zero-fill major faults are ~1.4 GB/s; committed pages take
            # cheap minor faults in every process). Page commits are
            # ARENA-wide, so exactly one process per host (the GCS/head)
            # runs this — N populaters would just multiply the kernel work.
            #
            # On hosts with plenty of cores the whole sweep runs on a
            # background thread for free. On tiny hosts a background
            # sweep would either starve (nice) or steal the workload's
            # core (not nice) — there, commit the hot first-fit region
            # synchronously at store open (a one-time ~0.5 s startup cost)
            # and leave only the tail to the background.
            nbytes = min(populate, total)
            sync_bytes = 0
            if (os.cpu_count() or 1) <= 4:
                sync_bytes = min(nbytes, 1 << 30)
                self._madvise(0, sync_bytes)
                self.lib.rtpt_store_set_populated(self.handle, sync_bytes)
                self._walked = sync_bytes
            if nbytes > sync_bytes:
                threading.Thread(
                    target=self._populate_pages,
                    args=(nbytes, sync_bytes), daemon=True,
                    name="arena-populate").start()
        else:
            # Client store: the head commits pages; this process still
            # takes a ~1us shared-memory minor fault per 4K page on first
            # touch. A deprioritized background walk of the committed
            # region populates THIS process's page tables so steady-state
            # creates/reads run fault-free. The walk starts LAZILY on the
            # first actual store use: a 200-worker launch storm would
            # otherwise spend most of the host's CPU on 200 parallel
            # ~1 GiB page-table walks for workers that never touch the
            # arena (measured: ~270k minor faults / ~60 ms CPU per worker,
            # the dominant cost of the many-actors bench on a small host).
            self._walk_started = False

    def _madvise(self, off: int, length: int, advice: int = 23) -> bool:
        """madvise via libc (releases the GIL). 23 = MADV_POPULATE_WRITE
        (Linux 5.14+). Returns False when the kernel rejects the advice."""
        if length <= 0:
            return True
        rc = self._libc.madvise(
            ctypes.c_void_p(self._base_addr + off),
            ctypes.c_size_t(length), ctypes.c_int(advice))
        return rc == 0

    def _commit_range(self, off: int, length: int) -> bool:
        """Commit tmpfs pages for [off, off+length): POPULATE_WRITE where
        the kernel has it, else fallocate — an in-kernel batched
        zero-allocation (~25x cheaper than taking a zero-fill fault per
        4K page during a bulk write, measured on a 4.x host). Both
        release the GIL and only ALLOCATE, so running concurrently with
        writes into the range is safe."""
        if length <= 0:
            return True
        if self._madvise(off, length):
            return True
        # Under the close lock: a background commit thread racing close()
        # could otherwise see the fd closed and REUSED by an unrelated
        # open, and fallocate would extend that file on disk. tmpfs
        # fallocate is an in-kernel zero-alloc (ms for hundreds of MB),
        # so the hold is short.
        with self._close_lock:
            fd = self._fd
            if fd is None:
                return False
            try:
                rc = self._libc.fallocate(
                    fd, ctypes.c_int(0),
                    ctypes.c_long(off), ctypes.c_long(length))
            except Exception:
                return False
        return rc == 0

    def _ensure_walk(self):
        """Start the committed-region walk on first store use (see
        __init__: never-touching workers must not pay for it)."""
        if self._walk_started:
            return
        self._walk_started = True
        threading.Thread(target=self._walk_committed, daemon=True,
                         name="arena-walk").start()

    def _walk_committed(self, window: int = 16 << 20):
        """Client-side page-table walk over the head-committed region
        (tracked by the arena's populated watermark). ~0.5 ms of kernel
        work per 16 MiB window on present pages; paced to stay out of the
        workload's way."""
        import random

        try:
            os.nice(19)
        except OSError:
            pass
        # Jittered head start: concurrent walkers (worker fleets spawn in
        # bursts) must not all hit the kernel in the same window.
        time.sleep(1.0 + random.random() * 2.0)
        off = 0
        idle_rounds = 0
        while idle_rounds < 50:  # stop once the watermark stops moving
            with self._close_lock:
                # C calls take the freed-Handle guard; madvise needs none
                # (unmapped ranges fail with ENOMEM, no fault).
                if not self.handle:
                    return
                limit = int(self.lib.rtpt_store_get_populated(self.handle))
            if off >= limit:
                idle_rounds += 1
                time.sleep(0.1)
                continue
            idle_rounds = 0
            if not self._madvise(off, min(window, limit - off)):
                return
            off = min(off + window, limit)
            self._walked = off
            time.sleep(0.01)

    def _populate_pages(self, nbytes: int, start: int = 0,
                        window: int = 16 << 20):
        # Commits near full speed, overlapping session startup — worker
        # interpreter spawns are seconds long, so this typically finishes
        # before user code runs. Short windows + small sleeps keep any
        # single steal of a busy core to ~6 ms.
        try:
            os.nice(19)  # per-thread on Linux
        except OSError:
            pass
        time.sleep(0.2)
        for off in range(start, nbytes, window):
            # madvise needs no close-lock (unmapped ranges fail with
            # ENOMEM, no fault); the C watermark call does — close() frees
            # the Handle it dereferences. Deliberately NOT the fallocate
            # fallback: eagerly committing the whole logical capacity on
            # kernels without MADV_POPULATE_WRITE would turn every
            # (possibly leaked) session arena into real tmpfs pages —
            # per-object commits in create() cover the paths that matter.
            if not self.handle:
                return
            if not self._madvise(off, min(window, nbytes - off)):
                return
            with self._close_lock:
                if not self.handle:
                    return
                self.lib.rtpt_store_set_populated(
                    self.handle, min(off + window, nbytes))
            time.sleep(0.002)

    @staticmethod
    def _key(object_id: ObjectID) -> bytes:
        return object_id.binary()

    def create(self, object_id: ObjectID, nbytes: int) -> memoryview:
        if not getattr(self, "_walk_started", True):
            self._ensure_walk()
        nbytes = max(nbytes, 1)
        off = self.lib.rtpt_store_create(self.handle, self._key(object_id),
                                         nbytes)
        if off == 0:
            raise MemoryError(
                f"native store out of memory allocating {nbytes} bytes")
        if nbytes >= (1 << 20) and off + nbytes > self._walked:
            # Populate the destination range up front. Cold pages: ~2x
            # faster than zero-fill faults during the copy (fallocate
            # fallback on pre-5.14 kernels: ~25x). Committed pages: still
            # ~2x faster than taking shared-memory minor faults inline
            # (~1us each). Skipped only once this process's background
            # page-table walk has covered the range.
            start = off & ~0xFFF
            length = min(off - start + nbytes, self._total - start)
            if nbytes >= (32 << 20):
                # Big buffers (bulk pulls, checkpoint writes): commit in
                # the background, overlapping the fill. Safe concurrent
                # with writes — both commit paths only ALLOCATE pages; a
                # write racing ahead just takes the ordinary fault for
                # that page.
                threading.Thread(target=self._commit_range,
                                 args=(start, length), daemon=True,
                                 name="arena-commit").start()
            else:
                self._commit_range(start, length)
        return self._view[off:off + nbytes]

    def seal(self, object_id: ObjectID):
        self.lib.rtpt_store_seal(self.handle, self._key(object_id))

    def abort(self, object_id: ObjectID):
        self.lib.rtpt_store_delete(self.handle, self._key(object_id))

    def get(self, object_id: ObjectID, nbytes: int) -> Optional[PlasmaObjectView]:
        """Pin + map a sealed object. The returned view holds a pin on the
        arena block (plasma's client-pin rule): the block cannot be
        recycled until ``view.close()`` — or, for zero-copy reads, until
        the deserialized value's buffers are garbage-collected (the pin is
        handed to them via ``serialization.deserialize(..., pin=...)``)."""
        if not getattr(self, "_walk_started", True):
            self._ensure_walk()
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self.lib.rtpt_store_acquire(self.handle, self._key(object_id),
                                         ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            return None
        n = int(size.value)
        return PlasmaObjectView(
            self._view[off.value:off.value + n], None,
            release_cb=lambda oid=object_id: self.release(oid))

    def release(self, object_id: ObjectID):
        # Zero-copy views release lazily (buffer GC), possibly after
        # close() at interpreter exit — a freed/NULL handle would segfault.
        with self._close_lock:
            if self.handle:
                self.lib.rtpt_store_release(self.handle,
                                            self._key(object_id))

    def contains(self, object_id: ObjectID) -> bool:
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        return self.lib.rtpt_store_lookup(
            self.handle, self._key(object_id),
            ctypes.byref(off), ctypes.byref(size)) == 0

    def delete(self, object_id: ObjectID):
        with self._close_lock:
            if self.handle:
                self.lib.rtpt_store_delete(self.handle, self._key(object_id))

    def list_objects(self, max_objects: int = 65536):
        """Enumerate sealed objects as [(ObjectID, nbytes)] — the restart
        path a recovering GCS uses to rebuild its object directory from
        the surviving arena."""
        keys = (ctypes.c_uint8 * (20 * max_objects))()
        sizes = (ctypes.c_uint64 * max_objects)()
        n = int(self.lib.rtpt_store_list(self.handle, keys, sizes,
                                         max_objects))
        out = []
        raw = bytes(keys)
        for i in range(n):
            out.append((ObjectID(raw[i * 20:(i + 1) * 20]),
                        int(sizes[i])))
        return out

    def stats(self) -> Dict[str, int]:
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        num = ctypes.c_uint64()
        self.lib.rtpt_store_stats(self.handle, ctypes.byref(used),
                                  ctypes.byref(cap), ctypes.byref(num))
        return {"bytes_in_use": used.value, "capacity": cap.value,
                "num_objects": num.value}

    def close(self):
        try:
            self._view.release()
        except BufferError:
            pass
        try:
            self._mmap.close()
        except (BufferError, ValueError):
            pass
        with self._close_lock:
            if self.handle:
                self.lib.rtpt_store_close(self.handle)
                self.handle = None
            fd = getattr(self, "_fd", None)
            if fd is not None:
                self._fd = None
                try:
                    os.close(fd)
                except OSError:
                    pass

    def unlink(self):
        self.lib.rtpt_store_unlink(self._name)
