"""Actor-served random access over a sorted dataset.

Re-design of the reference's ``RandomAccessDataset``
(``python/ray/data/random_access_dataset.py``): the dataset is
range-partitioned by a sort on the key column, partitions are spread over a
pool of serving actors, and the driver routes point lookups by the
partition boundaries it recorded at build time. Lookups inside an actor are
O(log rows) via a vectorized searchsorted over the partition's key column —
no per-row Python objects are built until a hit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

from .block import BlockAccessor, to_block


@ray_tpu_torch.remote
class _RARWorker:
    """Holds a contiguous run of sorted partitions and serves lookups."""

    def __init__(self, key: str, *blocks: Any):
        # blocks ride as top-level varargs so the refs resolve to values
        # before the ctor runs (refs nested inside a list would not).
        self._key = key
        tables = [to_block(b) for b in blocks]
        tables = [t for t in tables if t.num_rows]
        self._tables = tables
        self._keys = [np.asarray(t.column(key)) for t in tables]
        self._lows = np.array([k[0] for k in self._keys]) \
            if self._keys else np.array([])

    def num_rows(self) -> int:
        return int(sum(len(k) for k in self._keys))

    def get(self, key) -> Optional[dict]:
        return self.multiget([key])[0]

    def multiget(self, keys: List[Any]) -> List[Optional[dict]]:
        out: List[Optional[dict]] = []
        for key in keys:
            row = None
            if len(self._lows):
                # Last partition whose low bound <= key, then binary
                # search inside it.
                bi = int(np.searchsorted(self._lows, key, side="right")) - 1
                if bi >= 0:
                    ks = self._keys[bi]
                    i = int(np.searchsorted(ks, key))
                    if i < len(ks) and ks[i] == key:
                        row = dict(next(iter(BlockAccessor(
                            self._tables[bi].slice(i, 1)).rows())))
            out.append(row)
        return out


class RandomAccessDataset:
    """Key-indexed distributed view (reference:
    ``ray.data.random_access_dataset.RandomAccessDataset``)."""

    def __init__(self, ds, key: str, *, num_workers: int = 2):
        if ds.num_blocks() < num_workers:
            # sort() range-partitions into num_blocks() partitions; give
            # every worker at least one to hold.
            ds = ds.repartition(num_workers)
        sorted_ds = ds.sort(key)
        refs = list(sorted_ds._stream_refs())
        if not refs:
            raise ValueError("cannot index an empty dataset")
        # Partition boundaries: the sort exchange emits range-ordered
        # partitions, so routing only needs each partition's low key.
        stats = ray_tpu_torch.get([_key_bounds.remote(r, key) for r in refs],
                            timeout=600)
        keyed = [(s, r) for s, r in zip(stats, refs) if s is not None]
        if not keyed:
            raise ValueError("cannot index an empty dataset")
        n = max(1, min(int(num_workers), len(keyed)))
        per = -(-len(keyed) // n)
        self._key = key
        self._workers = []
        self._worker_lows: List[Any] = []
        for i in range(0, len(keyed), per):
            chunk = keyed[i:i + per]
            self._worker_lows.append(chunk[0][0][0])
            self._workers.append(
                _RARWorker.remote(key, *[r for _, r in chunk]))
        self._lows = np.array(self._worker_lows)

    def _route(self, key) -> int:
        i = int(np.searchsorted(self._lows, key, side="right")) - 1
        return max(i, 0)

    def get_async(self, key):
        """ObjectRef of the row dict (or None when absent)."""
        return self._workers[self._route(key)].get.remote(key)

    def multiget(self, keys: List[Any]) -> List[Optional[dict]]:
        """Batched lookup: one RPC per involved worker."""
        by_worker: Dict[int, List[int]] = {}
        for pos, key in enumerate(keys):
            by_worker.setdefault(self._route(key), []).append(pos)
        out: List[Optional[dict]] = [None] * len(keys)
        futs = {
            wi: self._workers[wi].multiget.remote(
                [keys[p] for p in positions])
            for wi, positions in by_worker.items()
        }
        for wi, positions in by_worker.items():
            for p, row in zip(positions, ray_tpu_torch.get(futs[wi])):
                out[p] = row
        return out

    def stats(self) -> str:
        rows = ray_tpu_torch.get([w.num_rows.remote() for w in self._workers])
        return (f"RandomAccessDataset(key={self._key!r}, "
                f"workers={len(self._workers)}, rows_per_worker={rows})")


@ray_tpu_torch.remote
def _key_bounds(block, key):
    t = to_block(block)
    if not t.num_rows:
        return None
    col = np.asarray(t.column(key))
    return (col[0].item(), col[-1].item())
