"""Consistent-hash ring assigning pool keys to shard ids; this package's
copy of the JAX package's ``shard.ring``, placing every key where that
one does.

The ring is the only routing state the FleetRouter holds: each shard
contributes ``replicas`` virtual points hashed from ``(seed, shard,
replica)``, and a pool key lands on the first point clockwise from the
key's own hash. Adding or removing one shard therefore moves only the
keys in the arcs that shard's points own (~1/K of the keyspace), which
is what lets the router rebuild just the affected pools on a shard
restart instead of re-homing the whole fleet.

Hashing is keyed BLAKE2b, never Python's ``hash()`` and never the
``utils`` RNG seam: placement must be reproducible across processes
(the spawn backend re-derives it) and must consume zero draws from the
seeded stream so netsim replays stay byte-identical sharded vs plain.
"""

from __future__ import annotations

import bisect
import hashlib

DEFAULT_REPLICAS = 64


def _hash64(data: bytes, seed: int) -> int:
    h = hashlib.blake2b(data, digest_size=8,
                        key=seed.to_bytes(8, 'little', signed=False))
    return int.from_bytes(h.digest(), 'big')


class HashRing:
    """Consistent-hash ring over integer shard ids."""

    def __init__(self, shards: int | list[int] = 1,
                 replicas: int = DEFAULT_REPLICAS, seed: int = 0):
        if replicas < 1:
            raise ValueError('replicas must be >= 1')
        self.hr_replicas = int(replicas)
        self.hr_seed = int(seed) & 0xffffffffffffffff
        # Sorted, parallel arrays: point hash -> owning shard id.
        self._points: list[int] = []
        self._owners: list[int] = []
        self._shards: set[int] = set()
        ids = range(shards) if isinstance(shards, int) else shards
        for sid in ids:
            self.add_shard(sid)

    # -- membership ------------------------------------------------------

    def shards(self) -> list[int]:
        return sorted(self._shards)

    def __len__(self) -> int:
        return len(self._shards)

    def add_shard(self, shard_id: int) -> None:
        sid = int(shard_id)
        if sid < 0:
            raise ValueError('shard ids must be >= 0')
        if sid in self._shards:
            return
        self._shards.add(sid)
        for rep in range(self.hr_replicas):
            pt = _hash64(b'shard:%d:%d' % (sid, rep), self.hr_seed)
            i = bisect.bisect_left(self._points, pt)
            # Ties between distinct shards are broken deterministically
            # by shard id so insertion order never changes placement.
            while (i < len(self._points) and self._points[i] == pt
                    and self._owners[i] < sid):
                i += 1
            self._points.insert(i, pt)
            self._owners.insert(i, sid)

    def remove_shard(self, shard_id: int) -> None:
        sid = int(shard_id)
        if sid not in self._shards:
            return
        self._shards.discard(sid)
        keep = [(p, o) for p, o in zip(self._points, self._owners)
                if o != sid]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    # -- assignment ------------------------------------------------------

    def assign(self, key: str) -> int:
        """Owning shard id for ``key``; raises LookupError when the
        ring is empty."""
        if not self._points:
            raise LookupError('hash ring has no shards')
        kh = _hash64(('key:%s' % key).encode('utf-8'), self.hr_seed)
        i = bisect.bisect_right(self._points, kh)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def assignment(self, keys) -> dict:
        return {k: self.assign(k) for k in keys}
