"""Generic data-aware dispatcher: the paper's five policies over any work.

The two-phase algorithm of Section 3.2 does not care *what* a work item is —
only that it names the data objects it needs (theta(T_i)) and that executors
advertise which objects they cache.  This module hosts the policy engine in
that generic form so it can drive:

  * simulator ``Task``s (``core.scheduler.DataAwareScheduler`` adapter),
  * live serving requests whose "objects" are KV-prefix blocks / adapters /
    shards (``runtime.router.CacheAffinityRouter``).

Policies:
  1. first-available      — ignore data location entirely (baseline; no
                            location info is sent, so every access goes to
                            persistent storage).
  2. first-cache-available— like (1) but ships location info; the paper omits
                            it from evaluation (no advantage in practice); we
                            implement it for completeness.
  3. max-cache-hit        — dispatch to the executor caching the most needed
                            data; if busy, *delay* dispatch until it frees.
  4. max-compute-util     — always dispatch to a free executor, preferring the
                            one with the most needed data.
  5. good-cache-compute   — (3) when CPU utilization >= threshold (paper: 90%
                            design / 80% in the experiments), else (4); plus a
                            maximum-replication-factor heuristic bounding how
                            many cached copies of an object may be created.

Two-phase algorithm (paper pseudocode):
  Phase 1 ``notify``  — work item at the head of the wait queue -> tally
    candidate executors from I_map, sort by cached-object count, notify the
    best FREE one (mark it PENDING); policies (1)/(4) fall back to any free
    executor, (3) delays, (5) delays only above the utilization threshold.
  Phase 2 ``pick_items`` — a notified executor asks for up to ``m`` items;
    the dispatcher scans a window of W queued items scoring the local
    cache-hit fraction, returning 100%-hit items eagerly, else the highest
    scoring; the no-hit fallback depends on the policy exactly as in the
    paper.

Complexity: O(|theta(T_i)| + replicationFactor + min(|Q|, W)) per decision via
hash maps + ordered sets (paper Section 3.2).  A reverse *demand index*
(object -> queued items) accelerates the window scan without changing policy
semantics: candidates are still restricted to the first W queue positions.
"""

from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Set, Tuple

from .index import CacheLocationIndex, CentralizedIndex
from .task import ExecutorState

POLICIES = (
    "first-available",
    "first-cache-available",
    "max-cache-hit",
    "max-compute-util",
    "good-cache-compute",
)


@dataclass
class SchedulerStats:
    decisions: int = 0
    notifications: int = 0
    window_scans: int = 0
    tasks_scanned: int = 0
    perfect_hits: int = 0
    fallback_dispatches: int = 0
    delayed: int = 0
    tier_floor_bypasses: int = 0    # GCC skipped a delay: holders too slow
    batch_drains: int = 0           # notify_batch calls (amortization factor:
    #                                 decisions / batch_drains per single scan)
    # Stale-snapshot accounting for the batched drain: a notify_batch scan
    # decides against a frozen presence/replication snapshot, while the
    # looped serving path admits each assignment's objects *before* the next
    # decision.  Both engines track that admission evolution as an overlay
    # during every batch scan; a decision whose branch differs between the
    # frozen view and the overlay-evolved view is counted exactly once per
    # scan — as `batch_stale_decisions` when the frozen view was used
    # (divergence from looped semantics: counted, never silent) or as
    # `batch_emulated_decisions` when `emulate_batch_admissions` made the
    # evolved view authoritative (parity with the loop restored).
    batch_stale_decisions: int = 0
    batch_emulated_decisions: int = 0

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``dispatch.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self)


class DataAwareDispatcher:
    """Falkon-style dispatcher over a centralized cache-location index.

    Work items are opaque: the dispatcher reads them only through ``key_fn``
    (a hashable identity) and ``objects_fn`` (the data objects the item
    needs).  Subclasses hook dispatch bookkeeping via ``_on_dispatch``.
    """

    def __init__(
        self,
        policy: str = "good-cache-compute",
        window: int = 3200,
        cpu_util_threshold: float = 0.8,
        max_replicas: int = 4,
        utilization_fn: Optional[Callable[[], float]] = None,
        index: Optional[CacheLocationIndex] = None,
        key_fn: Optional[Callable[[Any], Hashable]] = None,
        objects_fn: Optional[Callable[[Any], Sequence[str]]] = None,
        tier_weights: Optional[Dict[str, float]] = None,
        gcc_delay_tier_floor: float = 0.0,
        emulate_batch_admissions: bool = False,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; want one of {POLICIES}")
        self.policy = policy
        self.window = window
        self.cpu_util_threshold = cpu_util_threshold
        self.max_replicas = max_replicas
        self._utilization_fn = utilization_fn or (lambda: 1.0)
        self.index = index if index is not None else CentralizedIndex()
        self._key = key_fn or (lambda item: item.key)
        self._objects = objects_fn or (lambda item: item.objects)
        # Tier-aware scoring (diffusion plane): a cached object counts with
        # the weight of the tier holding it (HBM > DRAM > disk), so phase-1
        # candidate ranking and phase-2 window scoring prefer executors that
        # can serve from faster tiers.  None = every cached copy weighs 1.0
        # (the paper's flat-store behavior, bit-for-bit).
        self.tier_weights = tier_weights
        # GCC tier-aware delay floor: good-cache-compute delays dispatch for
        # a busy holder only when some live copy sits in a tier whose weight
        # is >= this floor.  Waiting for a disk-resident copy is rarely worth
        # it — the swap-in costs about as much as a peer fetch a free
        # executor could start right now.  0.0 disables (paper behavior).
        self.gcc_delay_tier_floor = gcc_delay_tier_floor
        # Batched-drain admission emulation: when True, notify_batch decides
        # each item against the frozen snapshot *plus* the admissions its own
        # earlier assignments would have performed (the looped serving
        # router's synchronous-admission evolution), so a binding replication
        # cap delays duplicates exactly as the loop would instead of
        # silently degrading to bulk-scheduling semantics.  When False the
        # frozen view stays authoritative and any would-be divergence is
        # counted in ``stats.batch_stale_decisions``.
        self.emulate_batch_admissions = emulate_batch_admissions
        # Live only inside notify_batch: object -> executors assigned work
        # naming it this batch that did not already hold it, plus the item
        # keys whose frozen/evolved divergence was already counted.
        self._batch_overlay: Optional[Dict[str, Set[str]]] = None
        self._batch_counted: Set[Hashable] = set()
        # Emulated mid-drain BUSY transitions: the looped serving path marks
        # each assignment BUSY before its next decision, so GCC's
        # utilization input rises by 1/n per assignment — notify_batch
        # replays that evolution here while emulating.
        self._batch_virtual_busy = 0

        # Wait queue Q: FIFO by arrival sequence. OrderedDict gives O(1)
        # head access and O(1) removal from the middle on dispatch.
        self._queue: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._seq_of: Dict[Hashable, int] = {}
        self._next_seq = 0
        # Demand index: object -> queued item keys needing it (window fast path).
        self._demand: Dict[str, Set[Hashable]] = defaultdict(set)
        # E_set: executor registry + free list (FIFO "next free executor").
        self._executors: Dict[str, ExecutorState] = {}
        self._free: "OrderedDict[str, None]" = OrderedDict()
        # Straggler dispatch penalties (robustness plane): executors named
        # here lose cache-affinity *ties* — among free holders at the same
        # maximal score, an unpenalized one wins; a penalized holder is
        # still chosen when it is strictly best or the only live option.
        # Tie resolution only, so an empty map (the default) leaves every
        # decision bit-identical; fed by HeartbeatMonitor.stragglers().
        self.penalties: Dict[str, float] = {}
        # Per-tenant dispatch weights (overload-fairness plane): while the
        # admission controller holds its overload latch, phase-2 pick order
        # prefers higher-credit tenants among items at the same cache score.
        # Score ordering is untouched — weight only reorders equal-score
        # picks — and an empty map (the default, and whenever the overload
        # latch clears) leaves every decision bit-identical.
        self.tenant_weights: Dict[str, float] = {}
        self.stats = SchedulerStats()
        # window-scan memoization: a failed scan stays failed until executor
        # states, the queue prefix, or the index change.
        self._scan_dirty = True
        self._idx_version_seen = -1

    # ---------------------------------------------------------------- queue
    def submit(self, item: Any) -> None:
        key = self._key(item)
        if len(self._queue) <= self.window:
            self._scan_dirty = True   # new item lands inside the window
        self._queue[key] = item
        self._seq_of[key] = self._next_seq
        self._next_seq += 1
        for f in self._objects(item):
            self._demand[f].add(key)

    def queue_length(self) -> int:
        return len(self._queue)

    def queued_items(self) -> List[Any]:
        return list(self._queue.values())

    def peek(self, n: int) -> List[Any]:
        """First ``n`` queued items without copying the whole queue (prefetch)."""
        out: List[Any] = []
        for item in self._queue.values():
            if len(out) >= n:
                break
            out.append(item)
        return out

    def objects_of(self, item: Any) -> Sequence[str]:
        """Data objects a work item needs (public form of the objects_fn)."""
        return self._objects(item)

    def _head(self) -> Optional[Any]:
        return next(iter(self._queue.values())) if self._queue else None

    def _remove_from_queue(self, item: Any) -> None:
        key = self._key(item)
        self._queue.pop(key, None)
        self._seq_of.pop(key, None)
        for f in self._objects(item):
            s = self._demand.get(f)
            if s is not None:
                s.discard(key)
                if not s:
                    del self._demand[f]

    # ------------------------------------------------------------ executors
    def register_executor(self, name: str) -> None:
        self._executors[name] = ExecutorState.FREE
        self._free[name] = None
        self._scan_dirty = True

    def deregister_executor(self, name: str) -> None:
        self._executors.pop(name, None)
        self._free.pop(name, None)
        self.penalties.pop(name, None)
        self.index.drop_executor(name)
        self._scan_dirty = True

    def set_penalties(self, penalties: Dict[str, float]) -> None:
        """Replace the straggler tie-penalty set (see ``self.penalties``)."""
        self.penalties = dict(penalties)
        self._scan_dirty = True

    def set_tenant_weights(self, weights: Dict[str, float]) -> None:
        """Replace the per-tenant pick-order weights (see
        ``self.tenant_weights``); the admission pump sets shares while
        overloaded and clears to {} when the latch releases."""
        self.tenant_weights = dict(weights)
        self._scan_dirty = True

    def _tenant_w(self, item: Any) -> float:
        return self.tenant_weights.get(getattr(item, "tenant", "") or "", 0.0)

    def executor_state(self, name: str) -> ExecutorState:
        return self._executors[name]

    def set_state(self, name: str, state: ExecutorState) -> None:
        prev = self._executors.get(name)
        if prev is None:
            return
        self._executors[name] = state
        self._scan_dirty = True
        if state == ExecutorState.FREE:
            self._free[name] = None
        else:
            self._free.pop(name, None)

    def registered(self) -> int:
        return len(self._executors)

    def free_count(self) -> int:
        return len(self._free)

    def utilization(self) -> float:
        """Busy / registered — the paper's CPU-utilization input to GCC.

        ``_batch_virtual_busy`` (nonzero only inside an emulating
        ``notify_batch``) adds the batch's own assignments, which the looped
        serving path would have marked BUSY before the next decision."""
        n = len(self._executors)
        if n == 0:
            return 1.0
        busy = sum(1 for s in self._executors.values() if s == ExecutorState.BUSY)
        return (busy + self._batch_virtual_busy) / n

    def _weight(self, f: str, e: str) -> float:
        """Tier weight of cached object f at executor e (tier-aware scoring)."""
        t = self.index.tier_of(f, e)
        if t is None:
            return 1.0
        return self.tier_weights.get(t, 1.0)

    def _delay_worthwhile(self, objects: Sequence[str],
                          ov: Optional[Dict[str, Set[str]]] = None) -> bool:
        """GCC + tiers: does any live copy sit in a tier fast enough that
        waiting for its busy holder beats dispatching elsewhere now?

        Flat stores weigh 1.0, so with the floor enabled they always justify
        the delay — only genuinely slow-tier-resident copies bypass it.
        ``ov`` (batch-scan admission overlay) adds the copies this batch's
        earlier assignments would have admitted — at the destination's top
        tier, hence at the maximal tier weight.
        """
        if self.tier_weights is None or self.gcc_delay_tier_floor <= 0.0:
            return True
        for f in objects:
            for e in self.index.locations(f):
                if e in self._executors and \
                        self._weight(f, e) >= self.gcc_delay_tier_floor:
                    return True
        if ov and max(self.tier_weights.values()) >= self.gcc_delay_tier_floor:
            return any(f in ov for f in objects)
        return False

    def _tail_decision(self, objects: Sequence[str], any_live: bool,
                       cache_mode: bool,
                       ov: Optional[Dict[str, Set[str]]]) -> str:
        """Decide an item none of whose live holders is free: "assign" (next
        free executor), "bypass" (assign, with tier-floor-bypass accounting),
        or "delay" — against the index alone (``ov=None``, the frozen
        snapshot) or the index plus a batch scan's emulated-admission
        overlay (the looped path's synchronous-admission evolution)."""
        if ov:
            any_live = any_live or any(f in ov for f in objects)
        if not any_live or not cache_mode:
            # cold object, or max-compute-util / first-cache-available:
            # "send notification to the next free executor".
            return "assign"
        if self.policy == "good-cache-compute":
            rep = max(self.index.replication_factor(f)
                      + (len(ov[f]) if ov and f in ov else 0)
                      for f in objects)
            if rep < self.max_replicas:
                return "assign"
            if not self._delay_worthwhile(objects, ov):
                return "bypass"
        return "delay"

    # -------------------------------------------------------------- phase 1
    def _cache_mode(self) -> bool:
        """True when the policy is currently in cache-preferring mode."""
        if self.policy == "max-cache-hit":
            return True
        if self.policy == "good-cache-compute":
            return self.utilization() >= self.cpu_util_threshold
        return False

    def notify(self) -> Optional[Tuple[str, Any]]:
        """Phase 1 (paper pseudocode): assign the queue-head item T0 to the
        best FREE executor, remove it from the wait queue, and return
        (executor, T0) — the caller delivers the notification after its
        latency.  Returns None when the policy delays dispatch (preferred
        executor busy under max-cache-hit / GCC-at-threshold) or nothing can
        be dispatched.
        """
        head = self._head()
        if head is None or not self._free:
            return None
        self.stats.decisions += 1

        if self.policy == "first-available":
            return self._assign(next(iter(self._free)), head)

        cache_mode = self._cache_mode()
        # Memoized failure: if nothing observable changed since the last
        # fully-failed window scan, the scan would fail again — skip it.
        if (cache_mode and not self._scan_dirty
                and self._idx_version_seen == self.index.version):
            self.stats.delayed += 1
            return None
        # Scan up to W queued items (the paper's scheduling window): an item
        # whose preferred executor is busy is *delayed in place* under
        # max-cache-hit / GCC-above-threshold, and the scan continues — this
        # is what keeps utilization from collapsing behind one hot node.
        scanned = 0
        executors = self._executors
        pen = self.penalties
        for item in self._queue.values():
            if scanned >= self.window:
                break
            scanned += 1
            objects = self._objects(item)
            best_free, any_live = None, False
            if len(objects) == 1 and self.tier_weights is None:
                # fast path (the common workload, flat stores); sorted so
                # choices among equivalent executors are reproducible across
                # processes (the paper's sorted-set index semantics)
                for e in sorted(self.index.locations(objects[0])):
                    st = executors.get(e)
                    if st is None:
                        continue
                    any_live = True
                    if st == ExecutorState.FREE:
                        # Every holder scores 1 here, so "first free holder"
                        # is pure tie-breaking: a penalized straggler yields
                        # to any later unpenalized free holder.
                        if not pen or e not in pen:
                            best_free = e
                            break
                        if best_free is None:
                            best_free = e
            else:
                # tier-aware: an HBM-resident copy outweighs a disk-resident
                # one, so among free holders the fastest-tier one wins.
                weighted = self.tier_weights is not None
                best_cnt = 0.0
                counts: Dict[str, float] = {}
                for f in objects:
                    for e in sorted(self.index.locations(f)):
                        st = executors.get(e)
                        if st is None:
                            continue
                        any_live = True
                        c = counts.get(e, 0.0) + (self._weight(f, e) if weighted else 1.0)
                        counts[e] = c
                        if st == ExecutorState.FREE and c > best_cnt:
                            best_free, best_cnt = e, c
                        elif (pen and st == ExecutorState.FREE
                                and c == best_cnt and best_free is not None
                                and best_free in pen and e not in pen):
                            best_free = e   # straggler loses the tie
            if best_free is not None:
                return self._assign(best_free, item)
            # No live holder is free: the tail decision, evaluated on the
            # frozen index and — inside a batch scan — on the index plus
            # the admission overlay.  A differing branch is counted once per
            # batch; the overlay becomes authoritative only when admission
            # emulation is on (the serving router's batched drain).
            dec = self._tail_decision(objects, any_live, cache_mode, None)
            ov = self._batch_overlay
            if ov:
                eff = self._tail_decision(objects, any_live, cache_mode, ov)
                if eff != dec:
                    key = self._key(item)
                    if key not in self._batch_counted:
                        self._batch_counted.add(key)
                        if self.emulate_batch_admissions:
                            self.stats.batch_emulated_decisions += 1
                        else:
                            self.stats.batch_stale_decisions += 1
                    if self.emulate_batch_admissions:
                        dec = eff
            if dec == "delay":
                self.stats.delayed += 1
                continue  # delay THIS item; keep scanning the window
            if dec == "bypass":
                self.stats.tier_floor_bypasses += 1
            return self._assign(next(iter(self._free)), item)
        self._scan_dirty = False
        self._idx_version_seen = self.index.version
        return None

    def _assign(self, name: str, item: Any) -> Tuple[str, Any]:
        self.set_state(name, ExecutorState.PENDING)
        self.stats.notifications += 1
        self._dispatch_item(item, name)
        return (name, item)

    def notify_batch(self, limit: Optional[int] = None) -> List[Tuple[str, Any]]:
        """Drain phase 1: repeated ``notify()`` until it yields nothing.

        The reference engine simply loops (one full window scan per
        assignment); ``repro.dispatch_vec.VectorizedDispatcher`` overrides
        this with a single-scan batched drain that produces the *identical*
        assignment sequence.  Valid only when nothing else mutates dispatcher
        or index state between the emulated calls — which is how the
        simulator's ``_try_notify``, the dispatch benchmarks, and the
        serving router's batched drain (``CacheAffinityRouter(batch_drain=
        True)``, which defers tier promotions out of the decision path)
        drive it.
        """
        self.stats.batch_drains += 1
        out: List[Tuple[str, Any]] = []
        self._batch_overlay = {}
        self._batch_counted = set()
        # GCC mid-drain utilization flip: the looped path marks each
        # assignment BUSY before the next decision; emulating replays that
        # via _batch_virtual_busy, otherwise every decision taken past the
        # would-be threshold crossing is counted stale — never silent.
        gcc = self.policy == "good-cache-compute"
        n_exec = len(self._executors)
        busy0 = sum(1 for s in self._executors.values()
                    if s == ExecutorState.BUSY)
        try:
            while limit is None or len(out) < limit:
                pair = self.notify()
                if pair is None:
                    break
                if (gcc and not self.emulate_batch_admissions and n_exec
                        and not self._cache_mode()
                        and (busy0 + len(out)) / n_exec
                        >= self.cpu_util_threshold):
                    self.stats.batch_stale_decisions += 1
                out.append(pair)
                if self.emulate_batch_admissions:
                    self._batch_virtual_busy += 1
                self._overlay_record(pair[0], self._objects(pair[1]))
        finally:
            self._batch_overlay = None
            self._batch_counted = set()
            self._batch_virtual_busy = 0
        return out

    def _overlay_record(self, executor: str, objects: Sequence[str]) -> None:
        """Log a batch assignment's would-be admissions: every named object
        the executor does not already hold would land in its store before
        the looped path's next decision."""
        ov = self._batch_overlay
        if ov is None:
            return
        for f in objects:
            if executor not in self.index.locations(f):
                ov.setdefault(f, set()).add(executor)

    # -------------------------------------------------------------- phase 2
    def pick_items(self, executor: str, m: int = 1) -> List[Any]:
        """Phase 2: executor asks for up to ``m`` items (window-scored).

        Returns the dispatched items (already removed from the wait queue);
        an empty list means the executor should return to the free pool
        (max-cache-hit semantics with nothing local).
        """
        if not self._queue:
            self.set_state(executor, ExecutorState.FREE)
            return []
        self.stats.window_scans += 1
        head_seq = self._seq_of[next(iter(self._queue))]
        horizon = head_seq + self.window

        picked: List[Any] = []
        cached = self.index.cached_at(executor)
        scored: List[Tuple[float, int, Any]] = []
        tw = self.tenant_weights
        # Weighted mode collects every perfect hit in traversal order, then
        # picks by (-tenant weight, traversal order): with uniform weights
        # the first m are exactly the items the unweighted early-break path
        # would have dispatched.
        perfect: List[Tuple[float, int, Any]] = []
        if cached:
            # Fast path: only items demanding an object this executor caches
            # can score > 0; restrict to the first W queue positions.
            # sorted iteration: which 100%-hit item is picked first must not
            # depend on set-hash order (keys are sortable in practice: ints
            # for tasks/requests), or reruns of a seeded workload diverge.
            seen: Set[Hashable] = set()
            for f in sorted(cached):
                for key in sorted(self._demand.get(f, ())):
                    if key in seen:
                        continue
                    seen.add(key)
                    seq = self._seq_of.get(key)
                    if seq is None or seq >= horizon:
                        continue
                    item = self._queue[key]
                    objects = self._objects(item)
                    if self.tier_weights is None:
                        hits = sum(1 for tf in objects if tf in cached)
                    else:
                        hits = sum(self._weight(tf, executor)
                                   for tf in objects if tf in cached)
                    frac = hits / len(objects)
                    self.stats.tasks_scanned += 1
                    if frac >= 1.0:
                        if tw:
                            perfect.append((-self._tenant_w(item),
                                            len(perfect), item))
                        else:
                            picked.append(item)
                            if len(picked) >= m:
                                break
                    else:
                        scored.append((frac, seq, item))
                if len(picked) >= m:
                    break
        if tw and perfect:
            perfect.sort(key=lambda p: (p[0], p[1]))
            picked = [it for _, _, it in perfect[:m]]

        for it in picked:
            self.stats.perfect_hits += 1
            self._dispatch_item(it, executor)
        if len(picked) >= m:
            self.set_state(executor, ExecutorState.BUSY)
            return picked

        # Highest-scoring partial hits next (ordered by score then FIFO;
        # tenant weight breaks equal-score ties while overloaded).
        if tw:
            scored.sort(key=lambda s: (-s[0], -self._tenant_w(s[2]), s[1]))
        else:
            scored.sort(key=lambda s: (-s[0], s[1]))
        for frac, _, item in scored:
            if len(picked) >= m:
                break
            if self._key(item) in self._queue:
                self._dispatch_item(item, executor)
                picked.append(item)

        if picked:
            self.set_state(executor, ExecutorState.BUSY)
            return picked

        return self._no_hit_fallback(executor, m)

    def _no_hit_fallback(self, executor: str, m: int) -> List[Any]:
        """Phase-2 tail when the window scan found no cache hits at all:
        the policy-dependent fallback of paper Section 3.2.  Shared with the
        vectorized engine (``repro.dispatch_vec``) so both implementations
        stay decision-identical by construction on this path."""
        picked: List[Any] = []
        cache_mode = self._cache_mode()
        if cache_mode and self.policy == "max-cache-hit":
            # Return executor to the free pool; item waits for its data.
            self.set_state(executor, ExecutorState.FREE)
            return []
        if cache_mode and self.policy == "good-cache-compute":
            # GCC above threshold behaves like MCH *unless* replication
            # headroom allows a new copy (cache-space heuristic) or every
            # live copy is below the tier floor (slow-tier bypass).
            head = self._head()
            rep = max((self.index.replication_factor(f)
                       for f in self._objects(head)), default=0)
            if rep >= self.max_replicas:
                if self._delay_worthwhile(self._objects(head)):
                    self.set_state(executor, ExecutorState.FREE)
                    return []
                self.stats.tier_floor_bypasses += 1
        # first-available / first-cache-available / max-compute-util /
        # GCC otherwise: top m items from the head of the wait queue.
        while len(picked) < m and self._queue:
            item = self._head()
            self._dispatch_item(item, executor)
            picked.append(item)
            self.stats.fallback_dispatches += 1
        self.set_state(executor, ExecutorState.BUSY if picked else ExecutorState.FREE)
        return picked

    def _dispatch_item(self, item: Any, executor: str) -> None:
        self._remove_from_queue(item)
        self._on_dispatch(item, executor)

    def _on_dispatch(self, item: Any, executor: str) -> None:
        """Bookkeeping hook; subclasses mutate the work item here."""

    def provides_location_info(self) -> bool:
        """first-available ships no location info => all accesses go to
        persistent storage (paper Section 3.2)."""
        return self.policy != "first-available"
