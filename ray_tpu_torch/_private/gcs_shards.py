"""Sharded directory structures for the GCS hot state.

The reference splits its directory load across dedicated services inside
gcs_server (``gcs_server.h:128-161`` — separate managers for nodes,
actors, placement groups, KV — each with its own io_context in recent
versions) so no single dispatch queue serializes every table. Here the
analog: the hot id-keyed tables (objects / actors / placement groups) are
partitioned into ``gcs_shards`` independent sub-dicts keyed by the id's
bytes. One asyncio loop still drains them today, but every lookup,
insert and scan touches exactly one shard, per-shard fill is observable
(``shard_stats``), and a multi-loop GCS can adopt a shard as its lane
without re-partitioning state.

The container implements the full MutableMapping surface the GCS uses
(get/in/len/iter/values/items/pop/del) so swapping it for a plain dict is
a one-line change per table.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List


class ShardedDict:
    """A dict partitioned into ``nshards`` independent sub-dicts.

    Keys are BaseID instances (ids.py): shard selection masks the id's
    cached byte-hash, so ObjectIDs sharing a producing task still spread
    (the return-index bytes participate in the hash) and selection costs
    one attribute read + mask per access. Shard balance for the three hot
    tables is asserted in tests/test_multi_tenant.py.
    """

    __slots__ = ("shards", "nshards", "_mask")

    def __init__(self, nshards: int = 8):
        # Power-of-two shard count: selection is a mask, not a modulo.
        n = 1
        while n < max(1, int(nshards)):
            n <<= 1
        self.nshards = n
        self._mask = n - 1
        self.shards: List[dict] = [{} for _ in range(n)]

    def _shard(self, key) -> dict:
        # id bytes: hash() is cached on BaseID (ids.py _hash slot), so
        # this is one attribute read + mask — no re-hash per access.
        return self.shards[hash(key) & self._mask]

    # ----------------------------------------------------------- mapping
    def __getitem__(self, key):
        return self._shard(key)[key]

    def __setitem__(self, key, value):
        self._shard(key)[key] = value

    def __delitem__(self, key):
        del self._shard(key)[key]

    def __contains__(self, key) -> bool:
        return key in self._shard(key)

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    def __iter__(self) -> Iterator:
        return itertools.chain.from_iterable(
            list(s) for s in self.shards)

    def get(self, key, default=None):
        return self._shard(key).get(key, default)

    def pop(self, key, *default):
        return self._shard(key).pop(key, *default)

    def setdefault(self, key, default=None):
        return self._shard(key).setdefault(key, default)

    def keys(self):
        return iter(self)

    def values(self):
        # Snapshot per shard: callers mutate mid-scan (eviction, actor
        # cleanup), same reason the GCS wraps dict scans in list().
        return itertools.chain.from_iterable(
            list(s.values()) for s in self.shards)

    def items(self):
        return itertools.chain.from_iterable(
            list(s.items()) for s in self.shards)

    def clear(self):
        for s in self.shards:
            s.clear()

    def stats(self) -> Dict[str, object]:
        sizes = [len(s) for s in self.shards]
        total = sum(sizes)
        mean = total / self.nshards if self.nshards else 0.0
        return {
            "nshards": self.nshards,
            "total": total,
            "sizes": sizes,
            # max/mean fill: 1.0 = perfectly balanced lanes; >>1 means one
            # lane would saturate first under a multi-loop drain.
            "balance": round(max(sizes) / mean, 3) if mean else 1.0,
        }
