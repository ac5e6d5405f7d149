"""Sharded cache-location index: drop-in replacement for the flat index.

``ShardedIndex`` consistent-hashes the object namespace over N
``IndexShard``s (``HashRing``) and routes every mutation, query, and loose-
coherence update message to the owning shard.  It is API-compatible with
``core.index.CentralizedIndex`` — ``add`` / ``remove`` / ``publish`` /
``locations`` / ``cached_at`` / ``cache_hits`` / ``candidate_executors`` /
``tier_of`` / ``replication_factor`` / ``drop_executor`` / ``enqueue_update``
/ ``apply_updates`` / ``version`` — so the dispatcher, router, and simulator
take it unmodified (``ShardedIndex(shards=1)`` behaves exactly like the flat
index; any shard count produces identical dispatch decisions, asserted by
the ``bench_index_scale`` smoke gate).

What sharding buys at "millions of users" scale:

  * each shard's maps stay small enough to scan/resize independently, and
    per-shard work (candidate tallies, bulk location lookups, coherence
    drains) is embarrassingly parallel — with ``scan_workers > 0`` the bulk
    operations (``bulk_locations``, ``candidate_executors``, ``publish``,
    ``apply_updates``) actually fan their per-shard slices across a
    ``ThreadPoolExecutor``, so the per-batch cost is the *max* shard slice
    rather than the sum;
  * loose coherence becomes per-shard batched delta application through the
    ``CoherenceBus`` instead of one global per-op deque;
  * per-shard access counters give the replica warm-start plane its
    hottest-objects ranking without a global scan (``hot_objects`` merges
    per-shard top-k).

Fan-out discipline: worker threads only ever touch their own shard's maps
(disjoint by construction); everything shared — entry-change listener
emission, ``version`` bumps, bus statistics — is buffered inside the worker
and replayed on the calling thread in shard order after the join, so the
observable event sequence is identical to the serial loop.  The caller
itself must not mutate the index concurrently with a bulk call (true for
the single-threaded router/DES drivers).  ``shard_rpc_latency_s`` models
each per-shard slice call as an out-of-process hop (the one-process-per-
shard deployment the CoherenceBus batches are the wire protocol for):
in-process pure-Python slices are GIL-bound, so the measured win of the
thread pool on a stock CPython build comes from overlapping exactly this
kind of per-shard service/network latency — ``bench_index_scale`` measures
both regimes.
"""

from __future__ import annotations

import time as _time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Set, Tuple,
)

from .coherence import CoherenceBus
from .ring import HashRing
from .shard import IndexShard

__all__ = ["ShardedIndex"]

# Buffered listener event: (op, file, executor, tier)
_Event = Tuple[str, str, str, Optional[str]]


class ShardedIndex:
    """N consistent-hash shards behind the ``CentralizedIndex`` API."""

    def __init__(
        self,
        shards: int = 8,
        coherence_delay_s: float = 0.0,
        vnodes: int = 64,
        batch_window_s: float = 0.0,
        heat_half_life_s: Optional[float] = None,
        scan_workers: int = 0,
        shard_rpc_latency_s: float = 0.0,
    ):
        self.ring = HashRing(shards, vnodes=vnodes)
        self.shards: List[IndexShard] = [
            IndexShard(i, heat_half_life_s=heat_half_life_s)
            for i in range(shards)
        ]
        self.bus = CoherenceBus(shards, delay_s=coherence_delay_s,
                                batch_window_s=batch_window_s)
        self.version = 0            # bumped on every mutation (scan memo)
        self.publishes = 0
        self.publish_added = 0
        self.publish_removed = 0
        self._listeners: List[Callable[[str, str, str, Optional[str]], None]] = []
        self.scan_workers = int(scan_workers)
        self.shard_rpc_latency_s = shard_rpc_latency_s
        # Chaos-plane hook (runtime.chaos): when set, every enqueue_update
        # consults it and a True verdict drops the update message on the
        # floor — a lost shard RPC on the coherence wire.  Loose coherence
        # already tolerates staleness (stale-claim accounting, publish
        # re-sync); the hook makes that tolerance testable under injected
        # loss.  None (default) costs nothing.
        self.rpc_loss: Optional[Callable[[], bool]] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.scan_workers > 0:
            self._pool = ThreadPoolExecutor(
                max_workers=min(self.scan_workers, max(1, shards)),
                thread_name_prefix="idx-shard")

    def close(self) -> None:
        """Shut down the scan pool (no-op without one)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- per-shard fan-out machinery ------------------------------------------
    def _shard_call(self, fn, *args):
        if self.shard_rpc_latency_s > 0.0:
            _time.sleep(self.shard_rpc_latency_s)   # the modeled per-shard hop
        return fn(*args)

    def _fan_out(self, calls: List[Tuple]) -> List:
        """Run ``[(fn, *args), ...]`` — one entry per shard slice — returning
        results in call order.  Uses the scan pool when present and the work
        actually fans out; the single-slice and pool-less cases stay inline
        (no submit/future overhead on the common small-probe path)."""
        if self._pool is None or len(calls) <= 1:
            return [self._shard_call(*c) for c in calls]
        futures = [self._pool.submit(self._shard_call, *c) for c in calls]
        return [f.result() for f in futures]

    @property
    def coherence_delay_s(self) -> float:
        return self.bus.delay_s

    @coherence_delay_s.setter
    def coherence_delay_s(self, v: float) -> None:
        self.bus.delay_s = v

    def shard_of(self, file: str) -> IndexShard:
        return self.shards[self.ring.shard_of(file)]

    # -- entry-change listeners (see core.index.IndexListener) ----------------
    def subscribe(self, listener: Callable[[str, str, str, Optional[str]], None]) -> None:
        self._listeners.append(listener)

    def _emit(self, op: str, file: str, executor: str,
              tier: Optional[str]) -> None:
        for cb in self._listeners:
            cb(op, file, executor, tier)

    def _shard_add(self, shard: IndexShard, file: str, executor: str,
                   tier: Optional[str],
                   sink: Optional[Callable[..., None]] = None) -> None:
        """Shard add + listener emission (every mutation path funnels here).

        ``sink`` redirects the would-be listener calls into a buffer — the
        fan-out workers use it so shared listener state is only touched on
        the calling thread (events replayed in shard order after the join).
        """
        if not self._listeners:
            shard.add(file, executor, tier)
            return
        emit = self._emit if sink is None else sink
        old_tier = shard.tier_of(file, executor)
        new = not shard.holds(file, executor)
        shard.add(file, executor, tier)
        if new:
            emit("add", file, executor,
                 tier if tier is not None else old_tier)
        elif tier is not None and tier != old_tier:
            emit("tier", file, executor, tier)

    def _shard_remove(self, shard: IndexShard, file: str, executor: str,
                      sink: Optional[Callable[..., None]] = None) -> None:
        if not self._listeners:
            shard.remove(file, executor)
            return
        emit = self._emit if sink is None else sink
        present = shard.holds(file, executor)
        shard.remove(file, executor)
        if present:
            emit("remove", file, executor, None)

    # -- synchronous mutation (coherent view) --------------------------------
    def add(self, file: str, executor: str, tier: Optional[str] = None) -> None:
        self.version += 1
        self._shard_add(self.shard_of(file), file, executor, tier)

    def remove(self, file: str, executor: str) -> None:
        self.version += 1
        self._shard_remove(self.shard_of(file), file, executor)

    def drop_executor(self, executor: str) -> None:
        """Executor released/failed: forget its entries in every shard."""
        removed = 0
        for shard in self.shards:
            if self._listeners:
                for f in list(shard.e_map.get(executor, ())):
                    self._shard_remove(shard, f, executor)
                    removed += 1
            else:
                removed += shard.drop_executor(executor)
        if removed:
            self.version += 1

    def quarantine_executor(self, executor: str) -> int:
        """Crash semantics: immediate entry withdrawal in every shard plus a
        ``CoherenceBus`` purge of queued updates naming the dead executor —
        without the purge a due *add* would re-point dispatch at a crashed
        node.  Returns the purged-op count (listener-visible removals happen
        through ``drop_executor`` as usual)."""
        purged = self.bus.purge_executor(executor)
        self.drop_executor(executor)
        return purged

    def publish(
        self,
        executor: str,
        files: Iterable[str],
        tiers: Optional[Mapping[str, str]] = None,
    ) -> Tuple[int, int]:
        """Bulk-sync an executor's cache snapshot, one delta per shard.

        Same semantics as ``CentralizedIndex.publish`` (diff against the
        current view, apply only the delta, refresh changed tiers), but the
        snapshot is pre-split by owning shard so each shard diffs only its
        slice — the amortized heartbeat the coherence plane is built around.
        """
        if tiers is None and isinstance(files, Mapping):
            tiers = files
        by_shard: Dict[int, List[str]] = defaultdict(list)
        for f in files:
            by_shard[self.ring.shard_of(f)].append(f)

        def publish_slice(shard: IndexShard, fs: Iterable[str]):
            events: List[_Event] = []
            sink = (lambda *ev: events.append(ev)) if self._listeners else None
            mutations = 0
            added, removed = shard.diff_snapshot(executor, fs)
            for f in added:
                mutations += 1
                self._shard_add(shard, f, executor,
                                tiers.get(f) if tiers else None, sink)
            for f in removed:
                mutations += 1
                self._shard_remove(shard, f, executor, sink)
            if tiers:
                for f in fs:
                    t = tiers.get(f)
                    if t is not None and f not in added \
                            and shard.tier_of(f, executor) != t:
                        mutations += 1
                        self._shard_add(shard, f, executor, t, sink)
            return len(added), len(removed), mutations, events

        # Every shard participates (a shard with no snapshot slice may hold
        # entries the snapshot withdraws); workers mutate only their own
        # shard, the shared bits replay below in shard order.
        results = self._fan_out([
            (publish_slice, shard, by_shard.get(sid, ()))
            for sid, shard in enumerate(self.shards)
        ])
        added_n = removed_n = 0
        for added_c, removed_c, mutations, events in results:
            for ev in events:
                self._emit(*ev)
            self.version += mutations
            added_n += added_c
            removed_n += removed_c
        self.publishes += 1
        self.publish_added += added_n
        self.publish_removed += removed_n
        return added_n, removed_n

    # -- loose coherence ------------------------------------------------------
    def enqueue_update(self, now: float, op: str, file: str, executor: str,
                       tier: Optional[str] = None) -> None:
        if self.rpc_loss is not None and self.rpc_loss():
            return                      # injected shard-RPC loss (counted)
        self.bus.enqueue(now, op, file, executor, self.ring.shard_of(file), tier)

    def apply_updates(self, now: float) -> int:
        """Drain due update batches into their shards (O(ops drained)).

        With a scan pool, the disjoint per-shard queues are drained on the
        calling thread (cheap deque pops) and the coalesced deltas applied
        across the pool — per-shard map mutation is the slice cost that
        parallelizes; listener events and stats replay serially after."""
        if self._pool is None:
            return self.bus.apply(now, self._apply_delta)
        work: List[Tuple[int, Dict, int]] = []
        for sid in range(len(self.shards)):
            delta, batch_ops = self.bus.drain_shard(sid, now)
            if batch_ops:
                work.append((sid, delta, batch_ops))
        if not work:
            return 0

        def apply_slice(sid: int, delta: Dict):
            events: List[_Event] = []
            sink = (lambda *ev: events.append(ev)) if self._listeners else None
            return self._apply_delta(sid, delta, sink=sink,
                                     bump_version=False), events

        results = self._fan_out([(apply_slice, sid, delta)
                                 for sid, delta, _ in work])
        drained = 0
        for (sid, _delta, batch_ops), (mutations, events) in zip(work, results):
            for ev in events:
                self._emit(*ev)
            if mutations:
                self.version += 1   # one bump per batch, as the serial path
            self.bus.stats.mutations += mutations
            self.bus.stats.applied += batch_ops
            self.bus.stats.batches += 1
            drained += batch_ops
        return drained

    def _apply_delta(
        self, shard_id: int,
        delta: Dict[Tuple[str, str], Tuple[str, Optional[str]]],
        sink: Optional[Callable[..., None]] = None,
        bump_version: bool = True,
    ) -> int:
        shard = self.shards[shard_id]
        mutations = 0
        for (f, e), (op, tier) in delta.items():
            if op == "add":
                self._shard_add(shard, f, e, tier, sink)
            elif op == "readd":                 # coalesced remove-then-add
                self._shard_remove(shard, f, e, sink)
                self._shard_add(shard, f, e, tier, sink)
            else:
                self._shard_remove(shard, f, e, sink)
            mutations += 1
        if mutations and bump_version:
            self.version += 1       # one bump per batch: amortized memo churn
        return mutations

    # -- queries used by the scheduler ----------------------------------------
    def locations(self, file: str) -> Set[str]:
        return self.shard_of(file).locations(file)

    def tier_of(self, file: str, executor: str) -> Optional[str]:
        return self.shard_of(file).tier_of(file, executor)

    def cached_at(self, executor: str) -> Set[str]:
        out: Set[str] = set()
        for shard in self.shards:
            out |= shard.cached_at(executor)
        return out

    def cache_hits(self, files: Iterable[str], executor: str) -> int:
        """|files ∩ E_map(executor)| without materializing the union."""
        return sum(1 for f in files if self.shard_of(f).holds(f, executor))

    def candidate_executors(self, files: Iterable[str]) -> Dict[str, int]:
        """Per-shard candidate tallies merged into one executor -> count map.

        Read-only per-shard slices; with a scan pool the tallies run
        concurrently and merge on the calling thread."""
        by_shard: Dict[int, List[str]] = defaultdict(list)
        for f in files:
            by_shard[self.ring.shard_of(f)].append(f)

        def tally_slice(shard: IndexShard, fs: List[str]) -> Dict[str, int]:
            tally: Dict[str, int] = defaultdict(int)
            for f in fs:
                holders = shard.i_map.get(f)
                if holders:
                    for e in holders:
                        tally[e] += 1
            return tally

        results = self._fan_out([(tally_slice, self.shards[sid], fs)
                                 for sid, fs in by_shard.items()])
        candidates: Dict[str, int] = defaultdict(int)
        for tally in results:
            for e, n in tally.items():
                candidates[e] += n
        return candidates

    def bulk_locations(self, files: Iterable[str]) -> Dict[str, Set[str]]:
        """Shard-grouped location lookup: one pass per shard, no re-hashing
        per query — the bulk form phase-1 window scans want at scale.  With
        a scan pool the per-shard slices run concurrently (the fan-out cost
        the critical-path model in ``bench_index_scale`` predicted, now a
        measured wall-clock number)."""
        by_shard: Dict[int, List[str]] = defaultdict(list)
        for f in files:
            by_shard[self.ring.shard_of(f)].append(f)

        def locate_slice(shard: IndexShard, fs: List[str]) -> Dict[str, Set[str]]:
            return {f: shard.locations(f) for f in fs}

        results = self._fan_out([(locate_slice, self.shards[sid], fs)
                                 for sid, fs in by_shard.items()])
        out: Dict[str, Set[str]] = {}
        for part in results:
            out.update(part)
        return out

    def replication_factor(self, file: str) -> int:
        return self.shard_of(file).replication_factor(file)

    def entry_count(self) -> int:
        return sum(shard.entry_count() for shard in self.shards)

    def entries(self) -> Iterator[Tuple[str, str, Optional[str]]]:
        """Iterate every (file, executor, tier) record across all shards."""
        for shard in self.shards:
            for f, holders in shard.i_map.items():
                for e, tier in holders.items():
                    yield f, e, tier

    # -- access heat (warm-start ranking) --------------------------------------
    def note_access(self, file: str, n: int = 1,
                    now: Optional[float] = None) -> None:
        self.shard_of(file).note_access(file, n, now)

    def hot_objects(self, k: int,
                    now: Optional[float] = None) -> List[Tuple[str, float]]:
        """Global top-k by (decayed) heat: merge of per-shard top-k lists.

        With decay enabled the merge re-ranks per-shard heads decayed to a
        common ``now`` so cross-shard ordering is consistent."""
        if now is None and self.shards and self.shards[0].heat.half_life_s:
            now = max(s.heat.now_hint for s in self.shards)
        merged: List[Tuple[str, float]] = []
        for shard in self.shards:
            merged.extend(shard.hot_objects(k, now))
        merged.sort(key=lambda kv: (-kv[1], kv[0]))
        return merged[:k]

    def heat_of(self, file: str, now: Optional[float] = None) -> float:
        return self.shard_of(file).heat.heat_of(file, now)
