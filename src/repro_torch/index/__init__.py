"""Sharded cache-location index plane.

Architecture (the paper's centralized index, grown for serving scale):

  ``ring.HashRing``        consistent hashing with virtual nodes over the
                           object namespace; deterministic across processes;
                           adding a shard moves only the keys the new shard
                           now owns.
  ``shard.IndexShard``     one slice's I_map/E_map, with the holding tier
                           folded into the I_map entry value (no separate
                           ``(file, executor) -> tier`` side-table) plus
                           per-object access counters.
  ``coherence.CoherenceBus``  loose coherence as per-shard *batched* delta
                           application with last-writer-wins coalescing,
                           replacing the flat index's global per-op deque;
                           optional heartbeat quantization amortizes N
                           messages into one batch.
  ``sharded.ShardedIndex`` the shards behind the exact ``CentralizedIndex``
                           API — drop-in for the dispatcher, router, and
                           simulator at any shard count — plus shard-parallel
                           bulk queries (``bulk_locations``, per-shard
                           candidate tallies) and global ``hot_objects``.
  ``warmstart``            DRP scale-up hook: bulk-clone the hottest
                           peer-held objects into a fresh replica's tiers
                           through the transfer engine, so it joins warm.

``core.index`` re-exports the plane and defines the shared
``CacheLocationIndex`` protocol both index implementations satisfy.
"""

from .coherence import CoherenceBus, CoherenceStats
from .ring import HashRing
from .shard import IndexShard
from .sharded import ShardedIndex
from .warmstart import WarmStartReport, WarmStartStats, clone_hottest

__all__ = [
    "CoherenceBus",
    "CoherenceStats",
    "HashRing",
    "IndexShard",
    "ShardedIndex",
    "WarmStartReport",
    "WarmStartStats",
    "clone_hottest",
]
