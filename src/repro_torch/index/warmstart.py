"""Replica warm-start: bulk-clone hot objects into a fresh executor.

Paper Section 3.3 hides resource-allocation latency behind data placement;
the serving-path corollary is that a DRP scale-up should hide *cache* warm-up
the same way.  A replica that joins cold eats a miss streak exactly when the
pool scaled up because load was high — the worst possible moment to replay
prefills.  This module closes that gap: when the router provisions a
replica, it ranks the hottest objects from the index's per-shard access
counters (``hot_objects``) and bulk-clones the ones with at least one live
peer holder into the new replica's tier stack through the existing
``TransferEngine`` (peer-NIC-preferred, single-flight, bandwidth-accounted)
— so by the time the replica starts taking assignments its store already
holds the working set's head.

Everything here is duck-typed against the index / store / engine protocols
(no imports from ``core`` or ``diffusion``): the plane works with either
``CentralizedIndex`` or ``ShardedIndex`` and with or without a transfer
engine (flat stores warm by zero-cost admit, tiered stores pay modeled
transfer time into ``admit_tier`` so speculative clones land below the HBM
tier the live batches are using).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["WarmStartReport", "WarmStartStats", "clone_hottest"]


@dataclass
class WarmStartReport:
    """Outcome of warming one replica."""

    replica: str = ""
    cloned: int = 0                 # objects placed (or transfer-started)
    cloned_to_hbm: int = 0          # clones admitted straight to the top tier
    bytes_cloned: float = 0.0
    skipped_resident: int = 0       # already at the destination
    skipped_cold: int = 0           # hot but no live peer holds a copy
    throttled: int = 0              # engine refused (slots saturated)
    transfer_time_s: float = 0.0    # modeled time until the last clone lands


@dataclass
class WarmStartStats:
    """Router-lifetime aggregate over all warm-started replicas."""

    replicas_warmed: int = 0
    cloned: int = 0
    cloned_to_hbm: int = 0
    bytes_cloned: float = 0.0
    skipped_cold: int = 0
    throttled: int = 0

    def merge(self, report: WarmStartReport) -> None:
        self.replicas_warmed += 1
        self.cloned += report.cloned
        self.cloned_to_hbm += report.cloned_to_hbm
        self.bytes_cloned += report.bytes_cloned
        self.skipped_cold += report.skipped_cold
        self.throttled += report.throttled

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``warmstart.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self)


def clone_hottest(
    index: Any,
    store: Any,
    dest: str,
    size_fn: Callable[[str], float],
    now: float,
    max_objects: int,
    engine: Optional[Any] = None,
    admit_tier: int = 1,
    max_bytes: float = float("inf"),
    hbm_heat_threshold: Optional[float] = None,
) -> WarmStartReport:
    """Warm ``dest``'s tier stack with the index's hottest peer-held objects.

    ``index`` needs ``hot_objects(k, now=...)`` + ``locations(file)``;
    ``store`` is the destination's ``TieredStore`` (``__contains__`` /
    ``admit`` / ``tiers``); ``engine``, when given, routes each clone through
    ``TransferEngine.fetch`` with ``kind="warmstart"`` — a *speculative*
    priority class, so demand fetches preempt warm-start copies rather than
    queue behind them.

    ``hbm_heat_threshold``: objects whose (decayed) heat is at or above this
    value are cloned straight into the top tier (HBM, admit_tier 0) — the
    head of the working set should not pay a swap-in on its first hit;
    everything else lands in ``admit_tier`` so speculative bulk does not
    evict the live batch's HBM residency.
    """
    report = WarmStartReport(replica=dest)
    if max_objects <= 0:
        return report
    # Over-fetch the ranking: resident/cold entries don't count against the
    # clone budget, so ask for enough candidates to fill it.
    for obj, heat in index.hot_objects(max_objects * 4, now=now):
        if report.cloned >= max_objects or report.bytes_cloned >= max_bytes:
            break
        if obj in store:
            report.skipped_resident += 1
            continue
        if not any(h != dest for h in index.locations(obj)):
            report.skipped_cold += 1
            continue
        size = size_fn(obj)
        to_hbm = hbm_heat_threshold is not None and heat >= hbm_heat_threshold
        tier = 0 if to_hbm else admit_tier
        if hasattr(store, "tiers"):
            tier = min(tier, len(store.tiers) - 1)
        if engine is not None:
            # allow_queue: a bulk clone serializes behind the slot pool
            # instead of being refused; demand can still preempt each copy.
            tr = engine.fetch(obj, size, dest, now, kind="warmstart",
                              admit_tier=tier, allow_queue=True)
            if tr is None:          # defensive: engine refused the clone
                report.throttled += 1
                break
            report.transfer_time_s = max(report.transfer_time_s,
                                         tr.remaining_s(now))
        elif hasattr(store, "tiers"):
            store.admit(obj, size, start_tier=tier)
        else:                       # flat store: zero-cost admit
            store.admit(obj, size)
        report.cloned += 1
        if to_hbm:
            report.cloned_to_hbm += 1
        report.bytes_cloned += size
    return report
