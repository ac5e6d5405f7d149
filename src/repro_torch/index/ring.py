"""Consistent hashing over the object namespace (the index's shard map).

``HashRing`` assigns every logical object name to one of ``shards`` index
shards via consistent hashing with virtual nodes: each shard owns ``vnodes``
pseudo-random tokens on a 64-bit ring; a key belongs to the shard owning the
first token clockwise of the key's hash.  Two properties matter here:

  * **determinism** — tokens and key hashes come from BLAKE2b, not Python's
    per-process-salted ``hash()``, so the key -> shard mapping is identical
    across processes and runs (the sharded index must route an update to the
    same shard the query path reads from, on every host).
  * **minimal movement** — growing from N to N+1 shards only inserts the new
    shard's tokens; a key either keeps its successor token (same shard) or
    its new successor is one of the inserted tokens (moves to the new
    shard).  No key moves *between* pre-existing shards, so a resharding
    event invalidates ~1/(N+1) of the index instead of all of it.  This is
    property-tested in ``tests/test_index_properties.py``.
"""

from __future__ import annotations

import bisect
from hashlib import blake2b
from typing import List, Tuple

__all__ = ["HashRing"]


def _h64(key: str) -> int:
    """Stable 64-bit hash (process-salt-free, unlike builtin ``hash``)."""
    return int.from_bytes(blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Maps object names to shard ids [0, shards) with virtual nodes."""

    def __init__(self, shards: int, vnodes: int = 64):
        if shards < 1:
            raise ValueError(f"need at least 1 shard, got {shards}")
        if vnodes < 1:
            raise ValueError(f"need at least 1 virtual node per shard, got {vnodes}")
        self.shards = int(shards)
        self.vnodes = int(vnodes)
        tokens: List[Tuple[int, int]] = []
        for shard in range(self.shards):
            for v in range(self.vnodes):
                tokens.append((_h64(f"shard:{shard}#vnode:{v}"), shard))
        tokens.sort()
        self._tokens = [t for t, _ in tokens]
        self._owners = [s for _, s in tokens]

    def shard_of(self, key: str) -> int:
        """Owning shard of ``key``: first token clockwise of the key hash."""
        i = bisect.bisect_right(self._tokens, _h64(key))
        if i == len(self._tokens):      # wrap past the last token
            i = 0
        return self._owners[i]

    def __len__(self) -> int:
        return self.shards
