"""Peer-to-peer transfer engine: the horizontal axis of data diffusion.

Resolves a tier-stack miss to the *cheapest* source and models the copy with
the paper's bandwidth algebra (``core.store``): candidate sources are the
least-NIC-loaded peer replica holding the object (found through
``CentralizedIndex.locations``) and the shared persistent store; the engine
compares ``copy_time`` under current load and takes the minimum, preferring
a peer on ties — peer cache-to-cache reads are what relieve persistent-store
contention at scale (arXiv:0808.3546's GPFS result).

Two serving-path realities the DES never modeled:

  * **single-flight dedup** — concurrent misses on one object at one
    destination share the in-flight transfer instead of issuing duplicates
    (the second requester pays only the *remaining* time);
  * **bounded concurrency** — at most ``max_inflight`` transfers progress at
    once; an overflow transfer starts when a slot frees (its cost includes
    the queueing delay);
  * **priority classes** — transfers are either *demand* (a live request is
    waiting on the object) or *speculative* (``prefetch`` / ``warmstart``).
    Speculative fetches never queue for a slot (they are refused instead)
    and are capped to ``speculative_slot_frac`` of the pool; a demand fetch
    that finds every slot busy *preempts* the speculative flight that would
    land last rather than queueing behind it.  This is the admission
    control that fixes the p99 regression ``bench_diffusion_tiers`` showed
    near saturation: under load, speculation yields instead of competing
    with demand for the persistent link and the in-flight slots.

Time is virtual and caller-supplied (``now``), like the router: the engine
never sleeps.  Bandwidth load (``omega``) is engaged at fetch and released
lazily by ``drain(now)`` once a transfer's ready time passes — every public
entry point drains first, so load reflects only genuinely in-flight copies.

``payload="real"`` adds the physical plane on top of the model: each
resolved fetch also copies the object's actual bytes out of the chosen
source (the peer store's ``diffusion.payload`` backend, or the engine's
persistent payload map seeded via ``put_persistent``) into the destination
backend at the admitted tier, wall-clock timed into ``self.measured``.  The
modeled ``copy_time`` stays decision-authoritative in both modes — sources,
admissions, and costs are bit-identical, and objects with no registered
bytes degrade to counted placeholder fetches — so ``"modeled"`` remains the
exact DES/dry-run backend and ``"real"`` only adds measurement.
"""

from __future__ import annotations

import random as _random
import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.index import CentralizedIndex
from ..core.store import BandwidthResource, copy_time
from .payload import MeasuredBandwidth
from .tiers import TieredStore

__all__ = ["DEMAND", "Transfer", "TransferEngine", "TransferStats"]

PERSISTENT = "persistent"
DEMAND = "demand"               # priority class; anything else is speculative


@dataclass
class Transfer:
    """One in-flight (or completed) copy into a destination's tier stack."""

    obj: str
    size_bytes: float
    dest: str
    source: str                     # "peer:<replica>" or "persistent"
    start_s: float                  # may exceed request time (slot queueing)
    ready_s: float
    kind: str = DEMAND              # "demand" | "prefetch" | "warmstart"
    shared_with: int = 0            # later requesters that joined this flight

    def remaining_s(self, now: float) -> float:
        return max(0.0, self.ready_s - now)


@dataclass
class TransferStats:
    started: int = 0
    completed: int = 0
    shared: int = 0                 # single-flight dedup joins
    bytes_from_persistent: float = 0.0
    bytes_from_peers: float = 0.0
    peer_fetches: int = 0
    persistent_fetches: int = 0
    queue_wait_s: float = 0.0       # total slot-queueing delay
    peak_inflight: int = 0
    preempted: int = 0              # speculative flights killed by demand
    preempted_bytes: float = 0.0
    refused_speculative: int = 0    # speculative fetches denied admission
    payload_moves: int = 0          # real-mode fetches that moved actual bytes
    payload_bytes_moved: float = 0.0
    placeholder_fetches: int = 0    # real-mode fetches with no bytes to move
    retries: int = 0                # resolution attempts repeated after a fault
    flakes: int = 0                 # transient per-attempt failures absorbed
    timeouts: int = 0               # per-flight deadline violations absorbed
    failovers: int = 0              # source re-resolutions (retry or dead peer)
    dead_dest_cancels: int = 0      # flights killed because the dest crashed
    joiners_failed: int = 0         # single-flight joiners notified of failure
    degraded_to_persistent: int = 0  # retry budget exhausted -> ladder floor

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``transfer.`` when adopted); the
        byte counters surface under their stable wire names
        ``transfer.bytes.peer`` / ``transfer.bytes.persistent``."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, rename={
            "bytes_from_peers": "bytes.peer",
            "bytes_from_persistent": "bytes.persistent",
        })


class TransferEngine:
    """Source selection + transfer accounting over a set of tiered stores."""

    def __init__(
        self,
        index: CentralizedIndex,
        persistent_link: BandwidthResource,
        stores: Optional[Dict[str, TieredStore]] = None,
        max_inflight: int = 8,
        latency_s: float = 0.0,
        use_peers: bool = True,
        speculative_slot_frac: float = 0.5,
        payload: str = "modeled",
        timeout_s: Optional[float] = None,
        max_retries: int = 3,
        retry_backoff_s: float = 0.05,
        retry_jitter_frac: float = 0.0,
        jitter_seed: int = 0,
        chaos: Optional[Any] = None,
    ):
        if payload not in ("modeled", "real"):
            raise ValueError(f"payload must be 'modeled' or 'real': {payload!r}")
        self.index = index
        self.persistent_link = persistent_link
        self.stores: Dict[str, TieredStore] = stores if stores is not None else {}
        self.max_inflight = max(1, int(max_inflight))
        self.latency_s = latency_s
        self.use_peers = use_peers
        # "real": move actual bytes through the stores' payload backends on
        # every resolved fetch (measured below); "modeled" (DES/dry-run):
        # bookkeeping only.  Decisions are identical in both modes.
        self.payload = payload
        self.measured = MeasuredBandwidth()
        self._persistent_payloads: Dict[str, Any] = {}
        # Admission cap for the speculative class (prefetch / warm-start):
        # at most this fraction of the slot pool may carry speculation.
        self.speculative_slot_frac = speculative_slot_frac
        # Robustness plane: a per-flight deadline (``timeout_s``, peers only
        # — persistent is the degradation floor and may always be used), a
        # bounded retry budget with exponential backoff, and an optional
        # ChaosInjector consulted once per resolution attempt.  All four
        # defaults leave resolution single-attempt and bit-identical to the
        # pre-robustness engine.
        self.timeout_s = timeout_s
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = retry_backoff_s
        # Deterministic backoff jitter: each retry step is scaled by a
        # seeded draw in [1 - frac, 1 + frac] so the synchronized retries
        # of a mass failover spread out instead of thundering-herding the
        # one surviving source.  frac = 0.0 (default) allocates no RNG and
        # keeps the exact legacy ladder; the same seed replays the same
        # jitter sequence (determinism pinned by test_diffusion).
        self.retry_jitter_frac = max(0.0, float(retry_jitter_frac))
        self._jitter_rng = (_random.Random(jitter_seed)
                            if self.retry_jitter_frac > 0.0 else None)
        self.chaos = chaos
        self._inflight: Dict[Tuple[str, str], Transfer] = {}
        self._engaged: Dict[Tuple[str, str], List[Tuple[BandwidthResource, float]]] = {}
        self._cancel_listeners: List[Callable[[str, str, str], None]] = []
        self._failure_listeners: List[Callable[[str, str, str, int], None]] = []
        self.stats = TransferStats()
        # Observability hook (repro.obs.TraceBuffer or None): every started
        # flight and real payload move records a structural span.  The
        # router wires this when built with obs; None is a no-op stub.
        self.trace = None

    # -- lifecycle ------------------------------------------------------------
    def register(self, name: str, store: TieredStore) -> None:
        self.stores[name] = store

    def put_persistent(self, obj: str, value: Any) -> None:
        """Seed the persistent store's payload for ``obj`` (real mode): the
        bytes a persistent-source fetch copies into the destination backend."""
        self._persistent_payloads[obj] = value

    def persistent_payload(self, obj: str) -> Optional[Any]:
        return self._persistent_payloads.get(obj)

    def deregister(self, name: str, now: Optional[float] = None) -> None:
        """Clean scale-down exit.  Even a *clean* exit must evacuate the
        flight plane: inbound flights keyed by the dead destination used to
        hold their slot and engaged omega until their ready time drained,
        and flights *sourced* from the departing peer would have completed
        against a store that no longer exists — both leaks, both fixed by
        routing through the shared evacuation path."""
        self._evacuate(name, now)

    def fail_replica(self, name: str, now: float) -> int:
        """Crash exit: same evacuation as ``deregister`` but the affected
        flights are failures, not scale-down bookkeeping — single-flight
        joiners are notified through the failure listeners instead of
        silently losing their transfer.  Returns the number of flights
        touched (cancelled inbound + failed-over outbound)."""
        return self._evacuate(name, now, crash=True)

    def _evacuate(self, name: str, now: Optional[float],
                  crash: bool = False) -> int:
        # Store goes first so _pick_source can no longer resolve to the
        # dead replica while we re-source its outbound flights.
        self.stores.pop(name, None)
        if now is not None:
            self.drain(now)
        affected = 0
        # Inbound: the destination died, so the copy has nowhere to land.
        # cancel() releases the slot and engaged omega without crediting
        # bytes (preserving started == completed + preempted); joiners of
        # the single flight are told it is terminal instead of hanging.
        for key in [k for k in self._inflight if k[0] == name]:
            tr = self._inflight[key]
            kind, shared = tr.kind, tr.shared_with
            self.cancel(*key)
            affected += 1
            if crash:
                self.stats.dead_dest_cancels += 1
            if shared:
                self.stats.joiners_failed += shared
            for fn in self._failure_listeners:
                fn(name, key[1], kind, shared)
        # Outbound: flights reading *from* the dead peer fail over to the
        # next-cheapest surviving source (peer -> peer -> persistent), the
        # graceful-degradation ladder.  The dead source's engaged omega is
        # released uncredited; the new source is engaged and charged from
        # the failure point forward.
        label = f"peer:{name}"
        for key, tr in list(self._inflight.items()):
            if tr.source != label:
                continue
            dst_store = self.stores.get(tr.dest)
            if dst_store is None:
                self.cancel(*key)   # destination is gone too: terminal
                affected += 1
                continue
            for res, _nbytes in self._engaged.pop(key, ()):
                res.end(0.0)
            source, src_res = self._pick_source(tr.obj, tr.size_bytes,
                                                tr.dest, dst_store)
            restart = tr.start_s if now is None else max(now, tr.start_s)
            cost = copy_time(tr.size_bytes, src_res, dst_store.nic,
                             latency_s=self.latency_s)
            src_res.begin()
            dst_store.nic.begin()
            self._engaged[key] = [(src_res, tr.size_bytes),
                                  (dst_store.nic, 0.0)]
            tr.source, tr.start_s, tr.ready_s = source, restart, restart + cost
            self.stats.failovers += 1
            if source == PERSISTENT:
                self.stats.degraded_to_persistent += 1
                self.stats.persistent_fetches += 1
                self.stats.bytes_from_persistent += tr.size_bytes
            else:
                self.stats.peer_fetches += 1
                self.stats.bytes_from_peers += tr.size_bytes
            if self.trace is not None:
                self.trace.record(-1, tr.obj, "failover", restart,
                                  tr.ready_s, tr.dest, "",
                                  (label, source, tr.kind))
            affected += 1
        return affected

    def drain(self, now: float) -> int:
        """Release bandwidth of transfers finished by ``now``; returns count."""
        done = [k for k, tr in self._inflight.items() if tr.ready_s <= now]
        for key in done:
            for res, nbytes in self._engaged.pop(key, ()):
                res.end(nbytes)
            del self._inflight[key]
            self.stats.completed += 1
        return len(done)

    def inflight(self, dest: str, obj: str) -> Optional[Transfer]:
        return self._inflight.get((dest, obj))

    def slots_in_use(self) -> int:
        return len(self._inflight)

    def load_frac(self) -> float:
        """Slot-pool occupancy in [0, 1] — the prefetcher's throttle input.

        Clamped: queued (not-yet-started) flights also live in the inflight
        map, so raw occupancy can exceed the cap while a backlog drains."""
        return min(1.0, len(self._inflight) / self.max_inflight)

    def add_cancel_listener(self, fn: Callable[[str, str, str], None]) -> None:
        """``fn(dest, obj, kind)`` fires when an in-flight copy is preempted."""
        self._cancel_listeners.append(fn)

    def add_failure_listener(self, fn: Callable[[str, str, str, int], None]) -> None:
        """``fn(dest, obj, kind, joiners)`` fires when a flight terminates in
        failure (destination evacuated): every single-flight joiner that was
        riding the transfer learns it is dead instead of waiting forever."""
        self._failure_listeners.append(fn)

    def _speculative_inflight(self) -> int:
        return sum(1 for tr in self._inflight.values() if tr.kind != DEMAND)

    def cancel(self, dest: str, obj: str) -> bool:
        """Abort an in-flight copy: free its bandwidth and withdraw the
        early-admitted placeholder from the destination's tier stack.

        The source and destination-NIC load (omega) engaged at start is
        released here, but no bytes are credited to the resources'
        ``bytes_served`` (that happens only when ``drain`` completes a
        flight).  The engine's ``stats.bytes_from_*`` counted at start stay
        counted — the partial read happened — and ``preempted_bytes``
        tracks the waste."""
        key = (dest, obj)
        tr = self._inflight.pop(key, None)
        if tr is None:
            return False
        for res, _nbytes in self._engaged.pop(key, ()):
            res.end(0.0)            # slot freed; no completed bytes credited
        self.stats.preempted += 1
        self.stats.preempted_bytes += tr.size_bytes
        store = self.stores.get(dest)
        if store is not None and obj in store:
            store.drop(obj)         # also withdraws the index entry
        for fn in self._cancel_listeners:
            fn(dest, obj, tr.kind)
        return True

    def remaining_s(self, dest: str, obj: str, now: float) -> float:
        """Time until a pending copy of obj lands at dest (0 if none/done)."""
        tr = self._inflight.get((dest, obj))
        return tr.remaining_s(now) if tr is not None else 0.0

    # -- the fetch path -------------------------------------------------------
    def fetch(
        self,
        obj: str,
        size_bytes: float,
        dest: str,
        now: float,
        kind: str = DEMAND,
        admit_tier: int = 0,
        allow_queue: Optional[bool] = None,
    ) -> Optional[Transfer]:
        """Resolve a miss on ``obj`` at ``dest``: dedup, pick source, charge.

        The object is admitted into the destination's tier stack immediately
        (bookkeeping — routing must see it) but the returned transfer's
        ``remaining_s(now)`` is the cost the caller still has to pay.

        ``allow_queue`` (default: demand yes, speculative no) decides what
        happens when the slot pool is saturated: queueable fetches start
        when a slot frees; non-queueable speculative fetches are refused
        (``None``).  Warm-start passes ``allow_queue=True`` — a bulk clone
        ordered by the control plane serializes behind the pool rather than
        being dropped — while remaining preemptable by demand.  Demand
        fetches always get a transfer (preempting speculation or queueing).
        """
        self.drain(now)
        return self._fetch_resolved(obj, size_bytes, dest, now, kind,
                                    admit_tier, allow_queue, None)

    def fetch_batch(
        self,
        wants: List[Tuple[str, float, str]],
        now: float,
        kind: str = DEMAND,
        admit_tier: int = 0,
        admit: bool = True,
    ) -> Dict[Tuple[str, str], Optional[Transfer]]:
        """Batched miss admission for a drained assignment batch.

        ``wants`` is ``[(obj, size_bytes, dest), ...]`` — the union of the
        batch's missed objects.  One ``drain`` and one cheapest-source
        resolution pass cover the whole batch: each object's sorted holder
        list is computed once and reused across destinations (the per-call
        re-sort is the hot cost of the looped path), while per-candidate
        viability (store presence, in-flight exclusion, NIC load) stays
        live, so source choices match what sequential ``fetch`` calls would
        have made.  Duplicate ``(dest, obj)`` wants join the single flight
        created by the first (``stats.shared``).  Returns a map keyed by
        ``(dest, obj)``.

        ``admit=False`` skips the destination-store bookkeeping admission:
        the caller places the objects itself (the batched router replays
        admissions in per-request object order so store recency evolves
        exactly as the looped path's would).
        """
        fetch = self.batch_resolver(now, kind=kind)
        out: Dict[Tuple[str, str], Optional[Transfer]] = {}
        for obj, size_bytes, dest in wants:
            out[(dest, obj)] = fetch(obj, size_bytes, dest, admit_tier, admit)
        return out

    def batch_resolver(self, now: float, kind: str = DEMAND):
        """One-pass batched resolution: a single ``drain`` plus a shared
        per-object sorted-candidate cache, returned as a fetch callable the
        caller invokes at each miss's replay position.

        Splitting resolution from the batch pre-pass matters for fidelity:
        a source must be chosen against the store state *at its position in
        the batch* — an earlier admission in the same batch may have
        evicted a peer's only copy, and the live per-candidate checks in
        ``_pick_source`` (store membership, in-flight exclusion, NIC load)
        see that exactly as sequential ``fetch`` calls would.  Only the
        drain and the candidate-list sorts are amortized across the batch.
        """
        self.drain(now)
        loc_cache: Dict[str, List[str]] = {}

        def fetch(obj: str, size_bytes: float, dest: str,
                  admit_tier: int = 0, admit: bool = True
                  ) -> Optional[Transfer]:
            return self._fetch_resolved(obj, size_bytes, dest, now, kind,
                                        admit_tier, None, loc_cache, admit)

        return fetch

    def _fetch_resolved(
        self,
        obj: str,
        size_bytes: float,
        dest: str,
        now: float,
        kind: str,
        admit_tier: int,
        allow_queue: Optional[bool],
        loc_cache: Optional[Dict[str, List[str]]],
        admit: bool = True,
    ) -> Optional[Transfer]:
        """Fetch body after the drain (shared by ``fetch``/``fetch_batch``)."""
        key = (dest, obj)
        existing = self._inflight.get(key)
        if existing is not None:
            # Single-flight: this miss rides the transfer already in the air.
            if kind == DEMAND and existing.kind != DEMAND:
                existing.kind = DEMAND   # a request now waits on it: promote
            existing.shared_with += 1
            self.stats.shared += 1
            return existing

        if allow_queue is None:
            allow_queue = kind == DEMAND
        start = now
        if kind != DEMAND and not allow_queue:
            # Opportunistic speculation (prefetch): never queue for a slot,
            # and never hold more than its fraction of the pool.
            spec_cap = max(1, int(self.max_inflight * self.speculative_slot_frac))
            if (len(self._inflight) >= self.max_inflight
                    or self._speculative_inflight() >= spec_cap):
                self.stats.refused_speculative += 1
                return None
        if kind == DEMAND:
            # Slots full: preempt speculative flights latest-landing-first
            # until a slot frees *now* or none remain.  One cancel is not
            # enough — queued flights keep their issued schedules (callers
            # already hold their cost), so any surviving speculation ahead
            # of this demand would still delay it.  Speculation is cheap to
            # redo; demand never waits behind it.
            while len(self._inflight) >= self.max_inflight:
                victim: Optional[Tuple[str, str]] = None
                victim_ready = -1.0
                for k2, tr2 in self._inflight.items():
                    if tr2.kind != DEMAND and tr2.ready_s > victim_ready:
                        victim, victim_ready = k2, tr2.ready_s
                if victim is None:
                    break
                self.cancel(*victim)
        if len(self._inflight) >= self.max_inflight:
            # Still saturated (only demand flights left): queue — start
            # when enough current flights land to fit under the cap.  The
            # recheck keeps the concurrency bound honest even when the
            # cancelled flights were queued rather than active.
            ready_times = sorted(tr.ready_s for tr in self._inflight.values())
            start = ready_times[len(ready_times) - self.max_inflight]
            self.stats.queue_wait_s += start - now

        dst_store = self.stores[dest]
        source, src_res, cost, backoff = self._resolve_with_retries(
            obj, size_bytes, dest, dst_store, loc_cache, start)
        start += backoff            # faulted attempts delay the real copy
        src_res.begin()
        dst_store.nic.begin()
        tr = Transfer(obj, size_bytes, dest, source, start, start + cost, kind)
        self._inflight[key] = tr
        self._engaged[key] = [(src_res, size_bytes), (dst_store.nic, 0.0)]
        self.stats.started += 1
        self.stats.peak_inflight = max(self.stats.peak_inflight, len(self._inflight))
        if self.trace is not None:
            # Structural span: the modeled copy's time in the air.  Flights
            # have no single owning request (dedup/speculation), so rid=-1.
            self.trace.record(-1, obj, "flight", start, start + cost,
                              dest, "", (source, kind, size_bytes))
        if source == PERSISTENT:
            self.stats.persistent_fetches += 1
            self.stats.bytes_from_persistent += size_bytes
        else:
            self.stats.peer_fetches += 1
            self.stats.bytes_from_peers += size_bytes
        if admit:
            dst_store.admit(obj, size_bytes, start_tier=admit_tier)
        if self.payload == "real":
            self._move_payload(tr, dst_store)
        return tr

    def _resolve_with_retries(
        self, obj: str, size_bytes: float, dest: str, dst_store: TieredStore,
        loc_cache: Optional[Dict[str, List[str]]], start: float,
    ) -> Tuple[str, BandwidthResource, float, float]:
        """Source resolution under the fault plane: returns
        ``(source, src_res, cost, backoff)``.

        Each attempt picks the cheapest source (excluding peers that already
        faulted this resolution) and checks two fault gates: the per-flight
        deadline (``timeout_s`` — a peer whose modeled copy would exceed it
        is treated as timed out; persistent is exempt, it is the ladder
        floor) and the chaos injector's per-attempt verdict.  A faulted
        attempt adds one exponential-backoff step and, when the source was a
        peer, fails over past it (``stats.failovers``).  When the retry
        budget is spent the resolution degrades to persistent
        unconditionally — bounded, never an unserved demand.  With no
        ``timeout_s`` and no chaos this is exactly one attempt with zero
        backoff: bit-identical to the pre-robustness resolution.
        """
        exclude: Optional[set] = None
        backoff = 0.0
        attempt = 0
        while True:
            source, src_res = self._pick_source(obj, size_bytes, dest,
                                                dst_store, loc_cache, exclude)
            cost = copy_time(size_bytes, src_res, dst_store.nic,
                             latency_s=self.latency_s)
            fault: Optional[str] = None
            if (self.timeout_s is not None and source != PERSISTENT
                    and cost > self.timeout_s):
                fault = "timeout"
            elif self.chaos is not None:
                fault = self.chaos.transfer_fault(obj, dest, source, attempt)
            if fault is None:
                return source, src_res, cost, backoff
            if fault == "timeout":
                self.stats.timeouts += 1
            else:
                self.stats.flakes += 1
            if self.trace is not None:
                self.trace.record(-1, obj, "retry", start + backoff,
                                  start + backoff, dest, "",
                                  (source, fault, attempt))
            if attempt >= self.max_retries:
                # Retry budget exhausted: take the degradation floor.
                if source != PERSISTENT:
                    self.stats.degraded_to_persistent += 1
                    source, src_res = PERSISTENT, self.persistent_link
                    cost = copy_time(size_bytes, src_res, dst_store.nic,
                                     latency_s=self.latency_s)
                return source, src_res, cost, backoff
            self.stats.retries += 1
            step = self.retry_backoff_s * (2.0 ** attempt)
            if self._jitter_rng is not None:
                step *= 1.0 + self.retry_jitter_frac * (
                    2.0 * self._jitter_rng.random() - 1.0)
            backoff += step
            if source != PERSISTENT:
                if exclude is None:
                    exclude = set()
                exclude.add(source[len("peer:"):])
                self.stats.failovers += 1
            attempt += 1

    def _move_payload(self, tr: Transfer, dst_store: TieredStore) -> None:
        """Real mode: copy the object's actual bytes from the chosen source
        into the destination's payload backend, wall-clock timed.

        Placeholder-tolerant at every hole — no destination backend, no
        bytes at the source, object not (yet) resident at the destination
        (pass-through, or a batched drain that replays admissions itself) —
        so mixed modeled/real fleets stay legal; the holes are counted
        (``stats.placeholder_fetches``), never silent.  The modeled
        ``copy_time`` already charged on ``tr`` is untouched: measurement
        must not perturb decisions.
        """
        backend = dst_store.payload
        dst_tier = dst_store.tier_of(tr.obj)
        if backend is None or dst_tier is None:
            self.stats.placeholder_fetches += 1
            return
        t0 = _time.perf_counter()
        if tr.source == PERSISTENT:
            src_label, value = PERSISTENT, self._persistent_payloads.get(tr.obj)
        else:
            peer = self.stores.get(tr.source[len("peer:"):])
            pb = peer.payload if peer is not None else None
            src_label = "peer"
            value = pb.get(tr.obj) if pb is not None else None
        if value is None:
            self.stats.placeholder_fetches += 1
            return
        backend.put(tr.obj, value, dst_tier)
        dt = _time.perf_counter() - t0
        nbytes = backend.nbytes(tr.obj)
        self.measured.record(src_label, dst_tier, nbytes, dt)
        self.stats.payload_moves += 1
        self.stats.payload_bytes_moved += nbytes
        if self.trace is not None:
            # Structural span: the *measured* wall time of the real byte
            # move, anchored at the flight's modeled start.
            self.trace.record(-1, tr.obj, "payload", tr.start_s,
                              tr.start_s + dt, tr.dest, "",
                              (src_label, dst_tier, float(nbytes)))

    def _pick_source(
        self, obj: str, size_bytes: float, dest: str, dst_store: TieredStore,
        loc_cache: Optional[Dict[str, List[str]]] = None,
        exclude: Optional[set] = None,
    ) -> Tuple[str, BandwidthResource]:
        """Cheapest of {least-loaded peer NIC, persistent store} by copy_time.

        ``loc_cache`` (batch path) memoizes each object's sorted holder list
        for the duration of one batch; per-candidate checks below stay live,
        and any holder admitted *during* the batch is excluded anyway by the
        in-flight check (its own copy has not landed), exactly as sequential
        fetches would exclude it.  ``exclude`` names peers that already
        faulted during the current resolution (retry failover).
        """
        best_peer: Optional[str] = None
        best_nic: Optional[BandwidthResource] = None
        if self.use_peers:
            # sorted: least-loaded ties break by name, not set-hash order,
            # so runs are reproducible across processes (paper: the index
            # maps are hash maps of *sorted* sets).
            if loc_cache is None:
                candidates = sorted(self.index.locations(obj))
            else:
                candidates = loc_cache.get(obj)
                if candidates is None:
                    candidates = loc_cache[obj] = sorted(self.index.locations(obj))
            for e in candidates:
                if e == dest:
                    continue
                if exclude is not None and e in exclude:
                    continue
                peer = self.stores.get(e)
                if peer is None or obj not in peer:
                    continue
                if (e, obj) in self._inflight:
                    continue                    # peer's own copy not landed yet
                if best_nic is None or peer.nic.omega < best_nic.omega:
                    best_peer, best_nic = e, peer.nic
        if best_nic is not None:
            peer_cost = copy_time(size_bytes, best_nic, dst_store.nic)
            gpfs_cost = copy_time(size_bytes, self.persistent_link, dst_store.nic)
            if peer_cost <= gpfs_cost:          # tie -> peer (spare the GPFS)
                return f"peer:{best_peer}", best_nic
        return PERSISTENT, self.persistent_link
