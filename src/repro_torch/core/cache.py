"""Cache with the paper's four eviction policies (Section 3.1.1).

The paper implements Random, FIFO, LRU, and LFU eviction at each executor's
transient data store and uses LRU for all experiments.  Data is immutable after
creation (paper assumption), so there is no coherence protocol — only presence
metadata flows back to the centralized index (see ``core/index.py``).

This module is shared by three consumers:
  * the discrete-event simulator (``core/simulator.py``),
  * the training data pipeline's host shard cache (``data/pipeline.py``),
  * the serving router's per-replica transient stores (``runtime/router.py``),
    which account KV-prefix / adapter / shard objects for the live request path.
"""

from __future__ import annotations

import random as _random
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

EVICTION_POLICIES = ("random", "fifo", "lru", "lfu")


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    bytes_evicted: float = 0.0

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``cache.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, props=("accesses", "hit_rate"))


class Cache:
    """Byte-capacity-bounded object cache with pluggable eviction.

    Keys are logical object names; values are object sizes in bytes.  The
    cache never stores payloads — payload movement is modelled (simulator) or
    performed (runtime) by the owner; this class is the bookkeeping the
    paper's executors perform on their transient stores.
    """

    def __init__(
        self,
        capacity_bytes: float,
        policy: str = "lru",
        rng: Optional[_random.Random] = None,
        on_evict: Optional[Callable[[str, float], None]] = None,
    ):
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; want one of {EVICTION_POLICIES}")
        self.capacity_bytes = float(capacity_bytes)
        self.policy = policy
        self._rng = rng or _random.Random(0)
        self._on_evict = on_evict
        # OrderedDict gives O(1) FIFO/LRU ordering; LFU keeps a freq map.
        self._entries: "OrderedDict[str, float]" = OrderedDict()
        self._freq: Dict[str, int] = {}
        self.used_bytes: float = 0.0
        self.stats = CacheStats()

    # -- queries ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def contents(self) -> List[str]:
        return list(self._entries.keys())

    def size_of(self, name: str) -> float:
        return self._entries[name]

    # -- access path ---------------------------------------------------------
    def access(self, name: str) -> bool:
        """Record an access; returns True on hit (and updates recency/freq)."""
        if name in self._entries:
            self.stats.hits += 1
            if self.policy == "lru":
                self._entries.move_to_end(name)
            if self.policy == "lfu":
                self._freq[name] = self._freq.get(name, 0) + 1
            return True
        self.stats.misses += 1
        return False

    def insert(self, name: str, size_bytes: float) -> List[str]:
        """Insert an object, evicting per policy. Returns evicted names.

        Objects larger than capacity are passed through uncached (the paper's
        executors stream such objects straight from the source).
        """
        if name in self._entries:
            return []
        if size_bytes > self.capacity_bytes:
            return []
        evicted: List[str] = []
        while self.used_bytes + size_bytes > self.capacity_bytes and self._entries:
            evicted.append(self._evict_one())
        self._entries[name] = size_bytes
        self._freq[name] = 1
        self.used_bytes += size_bytes
        self.stats.insertions += 1
        return evicted

    def remove(self, name: str) -> None:
        if name in self._entries:
            self.used_bytes -= self._entries.pop(name)
            self._freq.pop(name, None)

    def clear(self) -> List[str]:
        names = list(self._entries)
        for n in names:
            self.remove(n)
        return names

    # -- eviction ------------------------------------------------------------
    def _pick_victim(self) -> str:
        if self.policy in ("fifo", "lru"):
            # OrderedDict head is oldest-inserted (FIFO) / least-recent (LRU,
            # because access() moves hits to the end).
            return next(iter(self._entries))
        if self.policy == "random":
            return self._rng.choice(list(self._entries.keys()))
        # lfu: least frequently used, ties broken by insertion order.
        return min(self._entries, key=lambda n: (self._freq.get(n, 0),))

    def _evict_one(self) -> str:
        victim = self._pick_victim()
        size = self._entries[victim]
        self.remove(victim)
        self.stats.evictions += 1
        self.stats.bytes_evicted += size
        if self._on_evict is not None:
            self._on_evict(victim, size)
        return victim
