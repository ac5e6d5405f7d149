"""Batched loose coherence for the sharded index.

``CentralizedIndex`` models the paper's loose coherence as one global deque
of per-op update messages, popped one at a time.  At serving scale that is
the wrong shape twice over: every executor cache event is its own message
(no amortization), and one global queue serializes shards that could drain
independently.  The ``CoherenceBus`` replaces it with per-shard delta
batches:

  * updates are enqueued to the owning shard's queue with a due time of
    ``now + delay_s`` — and, when ``batch_window_s > 0``, rounded *up* to
    the next window boundary, so all updates landing inside one window
    become a single heartbeat (the amortized ``publish()`` path: N per-op
    messages collapse into one batched delta application);
  * at drain, each shard's due ops are coalesced by ``(file, executor)``
    with last-writer-wins before touching the maps — an add immediately
    undone by a remove never mutates the shard at all.  Coalesced
    application is order-equivalent to sequential application because ops
    on distinct (file, executor) pairs commute and ops on the same pair are
    resolved by the final one;
  * the bus records amortization stats (ops per applied batch, coalesce
    rate) — what ``bench_index_scale`` sweeps against update rate.

With ``batch_window_s == 0`` drain timing is bit-identical to the flat
index's deque (each op applies exactly when its delay expires), which is
what lets ``ShardedIndex`` guarantee identical dispatch decisions to
``CentralizedIndex`` on a seeded stream (the run.py smoke gate asserts it).
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

__all__ = ["CoherenceBus", "CoherenceStats"]

# One update message: (due_s, op, file, executor, tier)
_Op = Tuple[float, str, str, str, Optional[str]]


@dataclass
class CoherenceStats:
    enqueued: int = 0
    applied: int = 0                # raw ops drained (pre-coalesce)
    mutations: int = 0              # map mutations actually performed
    batches: int = 0                # per-shard batch applications
    coalesced: int = 0              # ops absorbed by last-writer-wins
    widened: int = 0                # adapt() grew the batch window
    shrunk: int = 0                 # adapt() cut the batch window

    @property
    def ops_per_batch(self) -> float:
        """Amortization factor: 1.0 means per-op (flat-index behavior)."""
        return self.applied / self.batches if self.batches else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``coherence.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, props=("ops_per_batch",))


class CoherenceBus:
    """Per-shard batched update queues with a shared delay model."""

    def __init__(
        self,
        num_shards: int,
        delay_s: float = 0.0,
        batch_window_s: float = 0.0,
    ):
        self.delay_s = delay_s
        self.batch_window_s = batch_window_s
        self._queues: List[Deque[_Op]] = [deque() for _ in range(num_shards)]
        self.stats = CoherenceStats()

    def pending(self) -> int:
        return sum(len(q) for q in self._queues)

    def purge_executor(self, executor: str) -> int:
        """Drop every queued op naming ``executor`` (crash quarantine).

        Per-queue rebuild preserves relative order of the survivors, so the
        monotone-due-time invariant the drains rely on is untouched.
        Returns the number of ops purged."""
        purged = 0
        for sid, q in enumerate(self._queues):
            kept = [op for op in q if op[3] != executor]
            if len(kept) != len(q):
                purged += len(q) - len(kept)
                self._queues[sid] = deque(kept)
        return purged

    def enqueue(
        self,
        now: float,
        op: str,
        file: str,
        executor: str,
        shard_id: int,
        tier: Optional[str] = None,
    ) -> None:
        due = now + self.delay_s
        if self.batch_window_s > 0.0:
            # Quantize to the next heartbeat boundary: everything inside one
            # window rides the same batch.  Monotone in ``now`` (constant
            # delay), so per-shard queues stay sorted by due time.  An
            # ``adapt()`` shrink can locally break the ordering for ops
            # already queued under the wider window; those simply ride the
            # batch their (stale) due time lands in — loose coherence.
            due = math.ceil(due / self.batch_window_s) * self.batch_window_s
        self._queues[shard_id].append((due, op, file, executor, tier))
        self.stats.enqueued += 1

    def drain_shard(
        self, shard_id: int, now: float
    ) -> Tuple[Dict[Tuple[str, str], Tuple[str, Optional[str]]], int]:
        """Pop + coalesce one shard's ops due at or before ``now``.

        Returns ``(delta, raw_op_count)`` — the coalesced ``{(file,
        executor): (op, tier)}`` batch and how many queued ops it absorbs
        (``(… , 0)`` when nothing is due).  Factored out of ``apply`` so a
        fanned-out caller (``ShardedIndex`` with a scan pool) can drain the
        disjoint per-shard queues itself and apply the deltas in parallel.
        """
        q = self._queues[shard_id]
        delta: Dict[Tuple[str, str], Tuple[str, Optional[str]]] = {}
        batch_ops = 0
        while q and q[0][0] <= now:
            _, op, f, e, tier = q.popleft()
            key = (f, e)
            if key in delta:
                self.stats.coalesced += 1
                # Coalescing must leave the same net state sequential
                # application would: a tier-less add over a prior add
                # keeps the earlier tier, while an add over a prior
                # remove becomes "readd" (remove-first), so stale tier
                # info cannot survive the remove it should have died in.
                prev_op, prev_tier = delta[key]
                if op == "add":
                    if prev_op == "remove":
                        op = "readd"
                    else:                       # prior add / readd
                        if tier is None:
                            tier = prev_tier
                        if prev_op == "readd":
                            op = "readd"
            delta[key] = (op, tier)
            batch_ops += 1
        return delta, batch_ops

    def apply(
        self,
        now: float,
        apply_fn: Callable[[int, Dict[Tuple[str, str], Tuple[str, Optional[str]]]], int],
    ) -> int:
        """Drain ops due at or before ``now``, one coalesced batch per shard.

        ``apply_fn(shard_id, delta)`` receives ``{(file, executor): (op,
        tier)}`` and returns the number of map mutations it performed.
        Returns the raw op count drained (the flat index's return value).
        """
        drained = 0
        for shard_id in range(len(self._queues)):
            delta, batch_ops = self.drain_shard(shard_id, now)
            if not batch_ops:
                continue
            self.stats.mutations += apply_fn(shard_id, delta)
            self.stats.applied += batch_ops
            self.stats.batches += 1
            drained += batch_ops
        return drained

    # -- window auto-tuning ---------------------------------------------------
    def adapt(
        self,
        stale_claim_rate: float,
        *,
        target_rate: float = 0.02,
        min_window_s: float = 0.0,
        max_window_s: float = 10.0,
        gain: float = 2.0,
        seed_window_s: float = 0.1,
    ) -> float:
        """Close the coherence auto-tuning loop from a measured signal.

        ``stale_claim_rate`` is the fraction of recent dispatches whose
        index view overstated locality (the DES's ``stale_claims`` counter,
        or any equivalent observation).  Above ``target_rate`` the heartbeat
        window shrinks by ``gain`` (fresher index, less amortization); at or
        below half the target it widens by ``gain`` up to ``max_window_s``
        (a dead band between the two avoids oscillation).  Widening from a
        zero window starts at ``seed_window_s``.  Ops already enqueued keep
        their quantized due times — adaptation applies to updates enqueued
        from now on, so per-shard queues stay drainable in order.  Returns
        the new window.
        """
        w = self.batch_window_s
        if stale_claim_rate > target_rate:
            new = w / gain
            if new < max(min_window_s, 1e-6):
                new = min_window_s
            if new != w:
                self.stats.shrunk += 1
        elif stale_claim_rate <= target_rate / 2.0:
            new = min(max_window_s, w * gain if w > 0.0
                      else max(min_window_s, seed_window_s))
            if new != w:
                self.stats.widened += 1
        else:
            return w
        self.batch_window_s = new
        return new
