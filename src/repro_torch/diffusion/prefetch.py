"""Background warm-up: overlap data transfer with compute.

When the dispatcher assigns work to an executor, the objects the *next*
queued items need can start moving toward that executor immediately — by the
time the executor frees and picks them up (Falkon phase 2), the transfer has
fully or partially landed and the swap-in is cheap.  This is the serving-path
analogue of the overlap the paper gets from its task batching: the transfer
rides under the current batch's decode time instead of adding to the next
request's latency.

The prefetcher is a thin policy layer over ``TransferEngine``: it issues
``kind="prefetch"`` fetches for objects missing from the destination's tier
stack (single-flight dedup in the engine makes double-warming free) and
classifies each later demand access as *useful* (landed in time), *late*
(still in flight — the demand paid only the remainder), or never touched.
Warmed objects land in ``admit_tier`` (default 1 = host DRAM when present)
so speculative data does not thrash the HBM tier the live batch is using.

Admission control (the bench_diffusion_tiers p99 fix): prefetches are
``kind="prefetch"`` — the engine's *speculative* priority class — so a
demand fetch preempts them rather than queueing behind them, and the engine
refuses them outright when the slot pool is saturated.  On top of that the
prefetcher applies a load-aware throttle of its own: it stops issuing warms
while engine slot occupancy is at or above ``max_engine_load_frac``, keeping
speculation out of exactly the window where it used to hurt tail latency.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Tuple

from .transfer import Transfer, TransferEngine

__all__ = ["PrefetchStats", "Prefetcher"]


@dataclass
class PrefetchStats:
    issued: int = 0
    bytes_issued: float = 0.0
    useful: int = 0                 # demand access after the warm landed
    late: int = 0                   # demand access while still in flight
    redundant: int = 0              # object was already resident / in flight
    throttled: int = 0              # warms withheld/refused under load
    preempted: int = 0              # in-flight warms killed by demand

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``prefetch.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self)


class Prefetcher:
    """Warms an executor's tier stack for upcoming work's objects."""

    def __init__(
        self,
        engine: TransferEngine,
        size_fn: Callable[[str], float],
        admit_tier: int = 1,
        max_outstanding: int = 32,
        max_tracked: int = 512,
        max_engine_load_frac: float = 0.75,
    ):
        self.engine = engine
        self.size_fn = size_fn
        self.admit_tier = admit_tier
        self.max_outstanding = max_outstanding
        # Load-aware throttle: no new warms while the engine's slot pool is
        # this full — near saturation every slot belongs to demand.
        self.max_engine_load_frac = max_engine_load_frac
        engine.add_cancel_listener(self._on_cancel)
        # Warms whose demand never lands at this (dest, obj) would otherwise
        # accumulate forever; the tracking map is bounded (oldest evicted) so
        # a long-running server can't leak one entry per unconsumed warm.
        self.max_tracked = max_tracked
        self._issued: Dict[Tuple[str, str], float] = {}   # (dest, obj) -> ready_s
        self.stats = PrefetchStats()

    def outstanding(self, now: float) -> int:
        return sum(1 for r in self._issued.values() if r > now)

    def warm(self, dest: str, objects: Iterable[str], now: float) -> List[Transfer]:
        """Start background transfers for objects ``dest`` does not hold."""
        store = self.engine.stores.get(dest)
        if store is None:
            return []
        started: List[Transfer] = []
        for obj in objects:
            if self.engine.load_frac() >= self.max_engine_load_frac:
                self.stats.throttled += 1
                break               # engine near saturation: demand owns it
            if obj in store or self.engine.inflight(dest, obj) is not None:
                self.stats.redundant += 1
                continue
            if self.outstanding(now) >= self.max_outstanding:
                break
            tier = min(self.admit_tier, len(store.tiers) - 1)
            tr = self.engine.fetch(obj, self.size_fn(obj), dest, now,
                                   kind="prefetch", admit_tier=tier)
            if tr is None:          # speculative admission refused
                self.stats.throttled += 1
                break
            while len(self._issued) >= self.max_tracked:
                self._issued.pop(next(iter(self._issued)))   # oldest entry
            self._issued[(dest, obj)] = tr.ready_s
            self.stats.issued += 1
            self.stats.bytes_issued += tr.size_bytes
            started.append(tr)
        return started

    def on_access(self, dest: str, obj: str, now: float) -> None:
        """Demand access touched (dest, obj): classify the warm, if any."""
        ready = self._issued.pop((dest, obj), None)
        if ready is None:
            return
        if ready <= now:
            self.stats.useful += 1
        else:
            self.stats.late += 1

    def _on_cancel(self, dest: str, obj: str, kind: str) -> None:
        """Engine preempted a flight: stop tracking our warm, if it was one."""
        if kind == "prefetch" and self._issued.pop((dest, obj), None) is not None:
            self.stats.preempted += 1
