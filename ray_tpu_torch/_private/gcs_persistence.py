"""GCS durable state: snapshot + append-only WAL in the session dir.

The reference makes the GCS restartable by writing its tables through a
Redis-backed store client (``src/ray/gcs/gcs_server/store_client_kv.cc``)
and replaying them at boot (``gcs_init_data.cc``); raylets and workers then
resync (``python/ray/tests/test_gcs_fault_tolerance.py``). This module is
the TPU-native equivalent with no external dependency: a msgpack WAL plus
periodic snapshot compaction on the session directory (which lives on local
disk and survives a GCS process crash).

What is durable vs rebuilt:
  * WAL/snapshot: KV table, actor records (spec + options + names), PG
    records, and INLINE object payloads (small by definition).
  * Rebuilt on restart from live peers: node/worker membership (agents
    re-register on reconnect), lease state (owners re-request), object
    directory for shm objects (the shared-memory arena itself survives the
    GCS process — its index is rescanned, and reconnecting clients re-report
    holders via resync).

Record format: one msgpack frame per mutation ``[op, payload]``; snapshot
is a single msgpack dict. fsync policy: WAL appends are flushed (buffered
write) on every record and fsync'd on snapshot only — a GCS crash can lose
the last few mutations but never corrupts the log (truncated tail frames
are dropped at replay).
"""

from __future__ import annotations

import io
import os
import struct
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import msgpack

_LEN = struct.Struct("<I")

SNAP = "gcs_snapshot.bin"
WAL = "gcs_wal.bin"


class GcsLog:
    """Append-only durable log with snapshot compaction."""

    def __init__(self, session_dir: str, compact_every: int = 50_000):
        self.dir = session_dir
        self.snap_path = os.path.join(session_dir, SNAP)
        self.wal_path = os.path.join(session_dir, WAL)
        self._wal: Optional[io.BufferedWriter] = None
        self._appends = 0
        self.compact_every = compact_every

    # ------------------------------------------------------------- replay

    def load(self) -> Tuple[Optional[dict], Iterator[Tuple[str, Any]]]:
        """Returns (snapshot dict or None, iterator of WAL (op, payload))."""
        snapshot = None
        if os.path.exists(self.snap_path):
            try:
                with open(self.snap_path, "rb") as f:
                    snapshot = msgpack.unpackb(f.read(), raw=False)
            except Exception:
                snapshot = None
        return snapshot, self._iter_wal()

    def _iter_wal(self) -> Iterator[Tuple[str, Any]]:
        if not os.path.exists(self.wal_path):
            return
        with open(self.wal_path, "rb") as f:
            data = f.read()
        off = 0
        n = len(data)
        while off + 4 <= n:
            (length,) = _LEN.unpack_from(data, off)
            if off + 4 + length > n:
                break  # truncated tail (crash mid-append): drop
            try:
                rec = msgpack.unpackb(data[off + 4:off + 4 + length],
                                      raw=False)
                yield rec[0], rec[1]
            except Exception:
                break  # corrupt frame: stop replay at last good record
            off += 4 + length

    # ------------------------------------------------------------- append

    def _ensure_wal(self) -> io.BufferedWriter:
        if self._wal is None:
            self._wal = open(self.wal_path, "ab")
        return self._wal

    def append(self, op: str, payload: Any):
        payload = msgpack.packb([op, payload], use_bin_type=True)
        w = self._ensure_wal()
        w.write(_LEN.pack(len(payload)))
        w.write(payload)
        w.flush()
        self._appends += 1

    def maybe_compact(self, make_snapshot: Callable[[], dict]):
        if self._appends < self.compact_every:
            return
        self.compact(make_snapshot())

    def compact(self, snapshot: dict):
        """Write a full snapshot and truncate the WAL (atomic rename)."""
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(snapshot, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        with open(self.wal_path, "wb"):
            pass  # truncate
        self._appends = 0

    def close(self):
        if self._wal is not None:
            self._wal.close()
            self._wal = None
