"""Centralized + local cache-location indices (paper Section 3.1.1).

The dispatcher maintains a centralized index recording the location of every
cached data object, kept *loosely coherent* with executor caches via periodic
update messages.  Each executor additionally keeps a local index of its own
cache.  Data structures follow the paper's scheduler definitions:

  I_map : file logical name -> sorted set of executors caching it
  E_map : executor name     -> sorted set of logical file names cached there

Both are hash maps of sorted sets, which is what makes the O(|T_i| +
replicationFactor + min(|Q|, W)) scheduling cost cheap in practice (paper
Section 3.2).

Two implementations satisfy the ``CacheLocationIndex`` protocol defined
here: the flat in-process ``CentralizedIndex`` below (the paper's original
shape) and the consistent-hash-sharded ``repro.index.ShardedIndex``
(re-exported at the bottom), which batches coherence per shard and scales
the scan path — see ``src/repro/index/`` for the plane's architecture.
Consumers (dispatcher, router, simulator) program against the protocol and
take either.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import (
    Callable, Deque, Dict, Iterable, Iterator, List, Mapping, Optional,
    Protocol, Set, Tuple, runtime_checkable,
)

# Index event listener: called with (op, file, executor, tier) where op is
#   "add"    — a (file, executor) presence entry was created (tier = the
#              tier it landed in, or None for flat stores),
#   "tier"   — an existing entry's holding tier changed (tier = new tier),
#   "remove" — an existing presence entry was withdrawn.
# Listeners fire only on *actual* state changes (an idempotent re-add is
# silent), which is what lets the vectorized dispatch plane maintain its
# presence/score arrays incrementally instead of rebuilding per decision.
IndexListener = Callable[[str, str, str, Optional[str]], None]


@runtime_checkable
class CacheLocationIndex(Protocol):
    """The index surface the dispatcher/router/simulator consume.

    ``version`` must change whenever any query's answer may have changed
    (the dispatcher memoizes failed window scans against it).
    """

    version: int

    def add(self, file: str, executor: str, tier: Optional[str] = None) -> None: ...
    def remove(self, file: str, executor: str) -> None: ...
    def drop_executor(self, executor: str) -> None: ...
    def publish(self, executor: str, files: Iterable[str],
                tiers: Optional[Mapping[str, str]] = None) -> Tuple[int, int]: ...
    def enqueue_update(self, now: float, op: str, file: str, executor: str) -> None: ...
    def apply_updates(self, now: float) -> int: ...
    def locations(self, file: str) -> Set[str]: ...
    def tier_of(self, file: str, executor: str) -> Optional[str]: ...
    def cached_at(self, executor: str) -> Set[str]: ...
    def cache_hits(self, files: Iterable[str], executor: str) -> int: ...
    def candidate_executors(self, files: Iterable[str]) -> Dict[str, int]: ...
    def replication_factor(self, file: str) -> int: ...
    def subscribe(self, listener: IndexListener) -> None: ...
    def entries(self) -> Iterator[Tuple[str, str, Optional[str]]]: ...
    def note_access(self, file: str, n: int = 1,
                    now: Optional[float] = None) -> None: ...
    def hot_objects(self, k: int,
                    now: Optional[float] = None) -> List[Tuple[str, float]]: ...


# ``HeatCounter`` (decayed per-object access heat) lives in
# ``repro.index.shard`` — a leaf module this one imports at the bottom — and
# is re-exported here; ``CentralizedIndex`` references it at instantiation
# time, after the bottom imports have run.


class CentralizedIndex:
    """Dispatcher-side index. Supports loose coherence via an update queue."""

    def __init__(self, coherence_delay_s: float = 0.0,
                 heat_half_life_s: Optional[float] = None):
        self.i_map: Dict[str, Set[str]] = defaultdict(set)
        self.e_map: Dict[str, Set[str]] = defaultdict(set)
        self.coherence_delay_s = coherence_delay_s
        # Which tier of an executor's store holds the object, when the store
        # is tiered (diffusion.tiers.TieredStore publishes this alongside
        # presence).  Flat stores never set it; queries then return None.
        self._tiers: Dict[Tuple[str, str], str] = {}
        # (apply_at_time, op, file, executor) — drained by the simulator clock;
        # runtime consumers use delay 0 (synchronous in-process updates).
        # Constant delay => appends arrive in time order => deque pop-left.
        self._pending: Deque[Tuple[float, str, str, str]] = deque()
        # Per-object access heat (router-fed): the warm-start ranking signal.
        self._access = HeatCounter(heat_half_life_s)
        self._listeners: List[IndexListener] = []

    # -- synchronous mutation (coherent view) --------------------------------
    version: int = 0  # bumped on every mutation (scheduler scan memoization)

    def subscribe(self, listener: IndexListener) -> None:
        """Register an entry-change listener (see ``IndexListener``)."""
        self._listeners.append(listener)

    def _emit(self, op: str, file: str, executor: str,
              tier: Optional[str]) -> None:
        for cb in self._listeners:
            cb(op, file, executor, tier)

    def add(self, file: str, executor: str, tier: Optional[str] = None) -> None:
        self.version += 1
        holders = self.i_map[file]
        new = executor not in holders
        holders.add(executor)
        self.e_map[executor].add(file)
        old_tier = self._tiers.get((file, executor))
        if tier is not None:
            self._tiers[(file, executor)] = tier
        if self._listeners:
            if new:
                self._emit("add", file, executor,
                           tier if tier is not None else old_tier)
            elif tier is not None and tier != old_tier:
                self._emit("tier", file, executor, tier)

    def remove(self, file: str, executor: str) -> None:
        self.version += 1
        holders = self.i_map.get(file, set())
        present = executor in holders
        holders.discard(executor)
        self.e_map.get(executor, set()).discard(file)
        self._tiers.pop((file, executor), None)
        if present and self._listeners:
            self._emit("remove", file, executor, None)

    def drop_executor(self, executor: str) -> None:
        """Executor released/failed: forget all its cache contents."""
        for f in self.e_map.pop(executor, set()):
            self.i_map.get(f, set()).discard(executor)
            self._tiers.pop((f, executor), None)
            if self._listeners:
                self._emit("remove", f, executor, None)

    def quarantine_executor(self, executor: str) -> int:
        """Crash semantics: ``drop_executor`` *plus* purge of the loose-
        coherence queue.  A clean scale-down may let queued updates drain
        (the executor's entries are already gone; applying them is
        idempotent noise), but after a crash a queued *add* naming the dead
        executor would resurrect a claim dispatch then routes to — so every
        pending op naming it dies with it.  Returns the purged-op count."""
        purged = sum(1 for item in self._pending if item[3] == executor)
        if purged:
            self._pending = deque(item for item in self._pending
                                  if item[3] != executor)
        self.drop_executor(executor)
        return purged

    def publish(
        self,
        executor: str,
        files: Iterable[str],
        tiers: Optional[Mapping[str, str]] = None,
    ) -> Tuple[int, int]:
        """Bulk-sync an executor's cache snapshot (replica heartbeat path).

        Replicas periodically publish their full transient-store contents;
        the index diffs the snapshot against its view and applies only the
        delta.  ``files`` may be a mapping ``name -> tier`` (tiered stores
        publish which tier holds each object).  Returns (added, removed).
        """
        if tiers is None and isinstance(files, Mapping):
            tiers = files
        snapshot = set(files)
        current = self.e_map.get(executor, set())
        added = snapshot - current
        removed = current - snapshot
        for f in added:
            self.add(f, executor)
        for f in removed:
            self.remove(f, executor)
        if tiers:
            for f, t in tiers.items():
                if self._tiers.get((f, executor)) != t:
                    self.add(f, executor, tier=t)   # idempotent; bumps version
        return len(added), len(removed)

    # -- loose coherence ------------------------------------------------------
    def enqueue_update(self, now: float, op: str, file: str, executor: str) -> None:
        self._pending.append((now + self.coherence_delay_s, op, file, executor))

    def apply_updates(self, now: float) -> int:
        """Apply all pending updates due at or before ``now`` (O(applied))."""
        applied = 0
        while self._pending and self._pending[0][0] <= now:
            _, op, f, e = self._pending.popleft()
            (self.add if op == "add" else self.remove)(f, e)
            applied += 1
        return applied

    # -- queries used by the scheduler ----------------------------------------
    def locations(self, file: str) -> Set[str]:
        return self.i_map.get(file, set())

    def tier_of(self, file: str, executor: str) -> Optional[str]:
        """Tier holding ``file`` at ``executor`` (None for flat stores)."""
        return self._tiers.get((file, executor))

    def cached_at(self, executor: str) -> Set[str]:
        return self.e_map.get(executor, set())

    def cache_hits(self, files: Iterable[str], executor: str) -> int:
        """|files(T_i) ∩ E_map(executor)| — the part-2 scoring function."""
        cached = self.e_map.get(executor, set())
        return sum(1 for f in files if f in cached)

    def candidate_executors(self, files: Iterable[str]) -> Dict[str, int]:
        """Part-1 candidate tally: executor -> number of needed files cached."""
        candidates: Dict[str, int] = defaultdict(int)
        for f in files:
            for e in self.i_map.get(f, set()):
                candidates[e] += 1
        return candidates

    def replication_factor(self, file: str) -> int:
        return len(self.i_map.get(file, set()))

    def entry_count(self) -> int:
        """Resident (file, executor) records (memory-footprint metric)."""
        return sum(len(es) for es in self.i_map.values())

    def entries(self) -> Iterator[Tuple[str, str, Optional[str]]]:
        """Iterate every (file, executor, tier) presence record (bootstrap
        path for incremental consumers that subscribe mid-stream)."""
        for f, execs in self.i_map.items():
            for e in execs:
                yield f, e, self._tiers.get((f, e))

    # -- access heat (warm-start ranking) -------------------------------------
    def note_access(self, file: str, n: int = 1,
                    now: Optional[float] = None) -> None:
        self._access.note(file, n, now)

    def hot_objects(self, k: int,
                    now: Optional[float] = None) -> List[Tuple[str, float]]:
        """Top-k objects by (decayed) access heat (heat desc, then name)."""
        return self._access.top(k, now)

    def heat_of(self, file: str, now: Optional[float] = None) -> float:
        return self._access.heat_of(file, now)


class LocalIndex:
    """Executor-side index of its own cached objects (trivial wrapper)."""

    def __init__(self):
        self.files: Set[str] = set()

    def add(self, file: str) -> None:
        self.files.add(file)

    def remove(self, file: str) -> None:
        self.files.discard(file)

    def __contains__(self, file: str) -> bool:
        return file in self.files


# Sharded plane re-exports: both implementations live behind the protocol
# above.  Imported from the submodules directly (not the package __init__'s
# convenience surface) to keep the core <- index <- diffusion import chain
# acyclic regardless of which module loads first.
from ..index.coherence import CoherenceBus  # noqa: E402
from ..index.ring import HashRing  # noqa: E402
from ..index.shard import HeatCounter, IndexShard  # noqa: E402
from ..index.sharded import ShardedIndex  # noqa: E402

__all__ = [
    "CacheLocationIndex",
    "CentralizedIndex",
    "CoherenceBus",
    "HashRing",
    "HeatCounter",
    "IndexListener",
    "IndexShard",
    "LocalIndex",
    "ShardedIndex",
]
