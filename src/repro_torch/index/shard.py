"""One shard of the cache-location index.

An ``IndexShard`` is the paper's I_map/E_map pair scoped to the slice of the
object namespace a ``HashRing`` routes here, with one structural change over
``core.index.CentralizedIndex``: the tier holding an object at an executor is
*folded into the I_map entry value* —

    i_map : file -> {executor: tier-or-None}
    e_map : executor -> set of files (this shard's slice only)

— instead of living in a separate ``(file, executor) -> tier`` side-table.
The side-table doubled the entry count of a tiered deployment (one presence
entry + one tier entry per copy) and is exactly what profiles of the flat
index showed growing first; folding it makes presence and tier one record
with one lifetime.

Shards also keep per-object access heat (bumped by the router on every
routed object via ``note_access``) — the ranking signal the replica
warm-start plane uses to decide *which* objects are worth bulk-cloning into
a fresh executor (``index.warmstart``).  With ``heat_half_life_s`` set the
heat decays exponentially (``core.index.HeatCounter``), so ``hot_objects``
ranks the *current* hot set instead of the lifetime one — a long-running
router no longer warm-starts yesterday's sessions.

The invariant property-tested in ``tests/test_index_properties.py``: after
any sequence of add/remove/publish/drop_executor, ``e in i_map[f]`` iff
``f in e_map[e]`` — the two maps never disagree.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["HeatCounter", "IndexShard"]


class HeatCounter:
    """Per-object access heat, optionally exponentially decayed.

    With ``half_life_s=None`` this is the original lifetime counter (the
    count never decays, ``now`` is ignored).  With a finite half-life, each
    access adds 1 to a value that halves every ``half_life_s`` seconds of
    wall/virtual time, so ``hot_objects`` ranks the *current* hot set — a
    long-running router no longer warm-starts yesterday's sessions.

    Decay is applied lazily (at access and at ranking time); the counter
    stores (value-at-last-touch, last-touch-time) per object.
    """

    __slots__ = ("half_life_s", "_heat", "_touched", "_now_hint")

    def __init__(self, half_life_s: Optional[float] = None):
        self.half_life_s = half_life_s
        self._heat: Dict[str, float] = defaultdict(float)
        self._touched: Dict[str, float] = {}
        self._now_hint = 0.0            # latest time observed (ranking default)

    def note(self, file: str, n: int = 1, now: Optional[float] = None) -> None:
        if self.half_life_s is None or now is None:
            self._heat[file] += n
            return
        self._now_hint = max(self._now_hint, now)
        last = self._touched.get(file)
        if last is not None and now > last:
            self._heat[file] *= 0.5 ** ((now - last) / self.half_life_s)
        self._touched[file] = max(now, last if last is not None else now)
        self._heat[file] += n

    @property
    def now_hint(self) -> float:
        """Latest time this counter has observed (cross-shard merge anchor)."""
        return self._now_hint

    def heat_of(self, file: str, now: Optional[float] = None) -> float:
        v = self._heat.get(file, 0.0)
        if self.half_life_s is None or v == 0.0:
            return v
        now = self._now_hint if now is None else now
        last = self._touched.get(file, now)
        if now > last:
            v *= 0.5 ** ((now - last) / self.half_life_s)
        return v

    def top(self, k: int, now: Optional[float] = None) -> List[Tuple[str, float]]:
        """Top-k by (decayed) heat, ties by name (reproducible clone sets)."""
        if self.half_life_s is None:
            ranked = sorted(self._heat.items(), key=lambda kv: (-kv[1], kv[0]))
            return ranked[:k]
        now = self._now_hint if now is None else now
        decayed = [(f, self.heat_of(f, now)) for f in self._heat]
        decayed.sort(key=lambda kv: (-kv[1], kv[0]))
        return decayed[:k]


class IndexShard:
    """I_map/E_map for one consistent-hash slice of the object namespace."""

    __slots__ = ("shard_id", "i_map", "e_map", "heat")

    def __init__(self, shard_id: int = 0,
                 heat_half_life_s: Optional[float] = None):
        self.shard_id = shard_id
        # file -> {executor: tier-or-None}; tier folded into the entry value.
        self.i_map: Dict[str, Dict[str, Optional[str]]] = {}
        self.e_map: Dict[str, Set[str]] = defaultdict(set)
        self.heat = HeatCounter(heat_half_life_s)

    # -- mutation (the coherence bus applies batched deltas through these) ---
    def add(self, file: str, executor: str, tier: Optional[str] = None) -> None:
        holders = self.i_map.get(file)
        if holders is None:
            holders = self.i_map[file] = {}
        # A tier-less re-add (loose-coherence messages carry no tier) must
        # not erase known tier info — the flat index's separate side-table
        # had this property implicitly; folded storage must keep it.
        if tier is not None or executor not in holders:
            holders[executor] = tier
        self.e_map[executor].add(file)

    def remove(self, file: str, executor: str) -> None:
        holders = self.i_map.get(file)
        if holders is not None:
            holders.pop(executor, None)
            if not holders:
                del self.i_map[file]
        files = self.e_map.get(executor)
        if files is not None:
            files.discard(file)
            if not files:
                del self.e_map[executor]

    def drop_executor(self, executor: str) -> int:
        """Forget every entry for ``executor``; returns entries removed."""
        files = self.e_map.pop(executor, set())
        for f in files:
            holders = self.i_map.get(f)
            if holders is not None:
                holders.pop(executor, None)
                if not holders:
                    del self.i_map[f]
        return len(files)

    # -- queries -------------------------------------------------------------
    def locations(self, file: str) -> Set[str]:
        holders = self.i_map.get(file)
        return set(holders) if holders else set()

    def tier_of(self, file: str, executor: str) -> Optional[str]:
        holders = self.i_map.get(file)
        return holders.get(executor) if holders else None

    def holds(self, file: str, executor: str) -> bool:
        holders = self.i_map.get(file)
        return holders is not None and executor in holders

    def cached_at(self, executor: str) -> Set[str]:
        return self.e_map.get(executor, set())

    def replication_factor(self, file: str) -> int:
        holders = self.i_map.get(file)
        return len(holders) if holders else 0

    def entry_count(self) -> int:
        """Resident (file, executor) records — the memory-footprint metric."""
        return sum(len(h) for h in self.i_map.values())

    # -- access heat (warm-start ranking signal) -----------------------------
    def note_access(self, file: str, n: int = 1,
                    now: Optional[float] = None) -> None:
        self.heat.note(file, n, now)

    def hot_objects(self, k: int,
                    now: Optional[float] = None) -> List[Tuple[str, float]]:
        """Top-``k`` objects by (decayed) heat (heat desc, then name — the
        tie-break keeps warm-start clone sets reproducible across runs)."""
        return self.heat.top(k, now)

    # -- bulk ----------------------------------------------------------------
    def diff_snapshot(
        self, executor: str, snapshot: Iterable[str]
    ) -> Tuple[Set[str], Set[str]]:
        """(added, removed) of ``snapshot`` vs the current view (publish)."""
        snap = set(snapshot)
        current = self.e_map.get(executor, set())
        return snap - current, current - snap
