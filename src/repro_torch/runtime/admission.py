"""Multi-tenant credit-based admission: backpressure and deadline-aware shedding.

Under sustained overload the router's wait queue grows without bound and
one hot tenant's working set evicts everyone else's — the failure mode the
crash-domain plane (``runtime/chaos.py``) does not cover.  This module
makes the serving path degrade *gracefully and fairly* instead:

  * Every ``RoutedRequest`` carries a ``tenant`` label; the controller
    keeps one ``TenantStats`` account per tenant (arrival rate, queue
    depth, hit rate, p99 via the router's ``LatencyReservoir``, tier-byte
    footprint).
  * ``enqueue`` becomes a **backpressure contract**: the verdict is
    ``ACCEPTED`` (dispatched normally), ``DEGRADED`` (admitted into a
    bounded per-tenant queue because the system is overloaded; may be
    delayed or shed), or ``REJECTED`` (the tenant's queue is at its cap).
    Nothing is ever silently dropped: ``served + shed + rejected`` equals
    offered load, per tenant — the accounting identity the admission
    bench asserts.
  * A scalar **credit score** per tenant is computed from its own SLO
    board (the PR-8 substrate): lifetime error-budget remaining, divided
    by penalties for burn-rate excess, alert violations (``fired_count``)
    and the p99/target ratio.  Credits normalize into weighted-DRF
    shares that (a) order load shedding — lowest credit sheds first, and
    within a tenant, requests past their deadline shed before fresh
    ones — (b) bias dispatch pick-item ties (``set_tenant_weights`` on
    both dispatcher engines), and (c) cap per-tenant tier admission
    (``TieredStore.set_tenant_quotas``) so one tenant cannot evict above
    its share.
  * The control loop follows the ``CoherenceBus.adapt`` shape: measure
    (queued depth / capacity) → dead band (enter overload above
    ``overload_enter``, clear only below ``overload_enter * clear_frac``,
    hold between) → multiplicative adjust (the per-tenant queue caps
    scale by ``gain``), bounded (``[min_queue, max_queue]``).

**Strict no-op contract**: while not overloaded the controller passes
every request straight through (``ACCEPTED``) — the router submits to the
dispatcher exactly as with ``admission=None``, so an attached-but-idle
controller is bit-identical (assignment logs and tier contents) to no
controller at all, the same parity bar the chaos and obs planes clear.
The controller consumes no RNG.
"""

from __future__ import annotations

import math
from collections import deque
from enum import Enum
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..obs.slo import SLOBoard, SLOSpec

__all__ = ["AdmissionController", "AdmissionVerdict", "TenantStats"]


class AdmissionVerdict(Enum):
    """The backpressure contract: what ``enqueue`` did with the request."""

    ACCEPTED = "accepted"    # dispatched normally (no overload)
    DEGRADED = "degraded"    # admitted into a bounded tenant queue; may shed
    REJECTED = "rejected"    # tenant queue at cap: refused at the edge


class TenantStats:
    """One tenant's serving account (a registry island per tenant)."""

    __slots__ = ("name", "submitted", "admitted", "degraded", "rejected",
                 "shed", "served", "hits", "misses", "queued", "inflight",
                 "tier_bytes", "credit", "share", "queue_cap", "latency",
                 "_arrivals")

    def __init__(self, name: str, latency_window: int = 512):
        self.name = name
        self.submitted = 0       # offered load: every enqueue attempt
        self.admitted = 0        # ACCEPTED + DEGRADED
        self.degraded = 0
        self.rejected = 0
        self.shed = 0            # admitted then load-shed before dispatch
        self.served = 0          # completed
        self.hits = 0
        self.misses = 0
        self.queued = 0          # gauge: held in this tenant's backpressure queue
        self.inflight = 0        # gauge: admitted, not yet completed or shed
        self.tier_bytes = 0.0    # gauge: resident tier bytes (quota accounting)
        self.credit = 1.0        # gauge: last computed credit score
        self.share = 0.0         # gauge: weighted-DRF share of credits
        self.queue_cap = 0       # gauge: current bounded-queue capacity
        # p99 via the router's reservoir (lazy import: router imports us).
        from .router import LatencyReservoir
        self.latency = LatencyReservoir(maxlen=latency_window)
        self._arrivals: Deque[float] = deque(maxlen=64)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def win_p99_s(self) -> float:
        """p99 over the reservoir's retained window (the credit signal —
        responsive to the current overload episode, not lifetime history)."""
        if not self.latency:
            return 0.0
        xs = sorted(self.latency)
        i = min(len(xs) - 1, max(0, math.ceil(0.99 * len(xs)) - 1))
        return xs[i]

    def arrival_rate_rps(self, now: float) -> float:
        """Arrivals/sec over the retained arrival window."""
        if len(self._arrivals) < 2:
            return 0.0
        span = now - self._arrivals[0]
        return (len(self._arrivals) - 1) / span if span > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        out = {
            "submitted": float(self.submitted),
            "admitted": float(self.admitted),
            "degraded": float(self.degraded),
            "rejected": float(self.rejected),
            "shed": float(self.shed),
            "served": float(self.served),
            "hit_rate": self.hit_rate,
            "queued": float(self.queued),
            "inflight": float(self.inflight),
            "tier_bytes": float(self.tier_bytes),
            "credit": float(self.credit),
            "share": float(self.share),
            "queue_cap": float(self.queue_cap),
        }
        for k, v in self.latency.snapshot().items():
            out[f"latency.{k}"] = v
        return out


class AdmissionController:
    """Credit-based admission, backpressure and deadline-aware shedding.

    The router calls four hooks:

      * ``on_submit(request, now)`` at enqueue — returns the verdict and,
        for ``DEGRADED``, keeps the request in the tenant's bounded queue.
      * ``adapt(now, queued=, capacity=)`` once per tick — the dead-band
        controller; returns the requests shed this round (already removed
        and accounted; the router emits their ``shed`` spans).
      * ``release(now, budget)`` once per tick — drains tenant queues into
        the dispatcher by weighted deficit round-robin over the credit
        shares (no tenant with positive credit starves).
      * ``on_complete(tenant, now, latency_s, hits, misses)`` at finish —
        feeds the tenant's account and its SLO board.
    """

    def __init__(
        self,
        tenants: Sequence[str] = (),
        *,
        slo_specs_by_tenant: Optional[Dict[str, Sequence[SLOSpec]]] = None,
        max_queue: int = 256,
        min_queue: int = 4,
        overload_enter: float = 2.0,
        clear_frac: float = 0.5,
        gain: float = 2.0,
        adapt_interval_s: float = 0.25,
        credit_floor: float = 0.05,
        fire_penalty: float = 0.25,
        default_deadline_s: Optional[float] = None,
        tier_quota_bytes: Optional[Dict[str, float]] = None,
        latency_window: int = 512,
    ):
        self.max_queue = int(max_queue)
        self.min_queue = int(min_queue)
        self.overload_enter = float(overload_enter)
        self.clear_frac = float(clear_frac)
        self.gain = float(gain)
        self.adapt_interval_s = float(adapt_interval_s)
        self.credit_floor = float(credit_floor)
        self.fire_penalty = float(fire_penalty)
        self.default_deadline_s = default_deadline_s
        self.tier_quota_bytes = dict(tier_quota_bytes or {})
        self.latency_window = int(latency_window)

        self.tenants: Dict[str, TenantStats] = {}
        self.boards: Dict[str, SLOBoard] = {}
        self._slo_specs = {t: tuple(specs) for t, specs
                           in (slo_specs_by_tenant or {}).items()}
        self._queues: Dict[str, Deque[Any]] = {}
        self._deficit: Dict[str, float] = {}
        self._object_tenant: Dict[str, str] = {}
        for t in tenants:
            self._ensure(t)

        self.overloaded = False          # dead-band latch
        self._cap_scale = 1.0            # multiplicative, bounded (0..1]
        self._last_adapt = -math.inf
        # controller-level counters (the ``admission.*`` island)
        self.admits = 0
        self.rejects = 0
        self.degrades = 0
        self.sheds = 0
        self.releases = 0
        self.adapts = 0
        self.overload_enters = 0
        self.overload_clears = 0

    # ------------------------------------------------------------- tenants
    def _ensure(self, name: str) -> TenantStats:
        st = self.tenants.get(name)
        if st is None:
            st = TenantStats(name, latency_window=self.latency_window)
            st.queue_cap = self.max_queue
            self.tenants[name] = st
            self._queues[name] = deque()
            self._deficit[name] = 0.0
            specs = self._slo_specs.get(name)
            if specs:
                self.boards[name] = SLOBoard(specs)
            self._reshare()
        return st

    def tenant_of_object(self, obj: str) -> Optional[str]:
        """Object → owning tenant, learned from submitted requests (the
        tier-quota hook's mapping)."""
        return self._object_tenant.get(obj)

    def store_quotas(self) -> Dict[str, float]:
        """Per-tenant resident-byte caps to apply on each replica store."""
        return self.tier_quota_bytes

    def queue_depth(self) -> int:
        """Requests currently held under backpressure (all tenants)."""
        return sum(st.queued for st in self.tenants.values())

    # -------------------------------------------------------------- admit
    def on_submit(self, request: Any, now: float) -> AdmissionVerdict:
        st = self._ensure(getattr(request, "tenant", "") or "default")
        st.submitted += 1
        st._arrivals.append(now)
        for obj in request.objects:
            self._object_tenant.setdefault(obj, st.name)
        if request.deadline_s is None and self.default_deadline_s is not None:
            request.deadline_s = now + self.default_deadline_s
        if not self.overloaded:
            # pass-through: the router dispatches exactly as admission=None
            st.admitted += 1
            st.inflight += 1
            self.admits += 1
            return AdmissionVerdict.ACCEPTED
        if st.queued >= max(self.min_queue, st.queue_cap):
            st.rejected += 1
            self.rejects += 1
            return AdmissionVerdict.REJECTED
        self._queues[st.name].append(request)
        st.queued += 1
        st.admitted += 1
        st.degraded += 1
        st.inflight += 1
        self.degrades += 1
        return AdmissionVerdict.DEGRADED

    # ------------------------------------------------------------ control
    def adapt(self, now: float, *, queued: int, capacity: int) -> List[Any]:
        """Measure → dead band → multiplicative adjust, bounded.

        ``queued`` is the dispatcher's own wait-queue depth; ``capacity``
        the pool's concurrent-dispatch headroom (replicas × pickup batch).
        Returns the requests shed this round, already removed from their
        tenant queues and counted (``tenant.<t>.shed``); the caller owns
        span emission and request-table cleanup.
        """
        if now - self._last_adapt < self.adapt_interval_s:
            return []
        self._last_adapt = now
        self.adapts += 1
        self._refresh_credits(now)
        depth = queued + self.queue_depth()
        load = depth / max(1.0, float(capacity))
        if load >= self.overload_enter:
            if not self.overloaded:
                self.overloaded = True
                self.overload_enters += 1
            self._cap_scale = max(
                self.min_queue / max(1.0, float(self.max_queue)),
                self._cap_scale / self.gain)
        elif load <= self.overload_enter * self.clear_frac:
            if self.overloaded:
                self.overloaded = False
                self.overload_clears += 1
            self._cap_scale = min(1.0, self._cap_scale * self.gain)
        # between the two thresholds: hold (dead band), keep current caps
        self._recap()
        if not self.overloaded:
            return []
        return self._shed(now)

    def _recap(self) -> None:
        """Share-weighted bounded queue caps from the current scale."""
        n = max(1, len(self.tenants))
        for st in self.tenants.values():
            cap = self.max_queue * self._cap_scale * st.share * n
            st.queue_cap = max(self.min_queue,
                               min(self.max_queue, int(cap)))

    def _shed(self, now: float) -> List[Any]:
        """Trim tenant queues to their caps: lowest credit first; within a
        tenant, requests past their deadline before fresh ones."""
        victims: List[Any] = []
        order = sorted(self.tenants.values(),
                       key=lambda s: (s.credit, s.name))
        for st in order:
            q = self._queues[st.name]
            while st.queued > st.queue_cap and q:
                victim = self._pop_victim(q, now)
                st.queued -= 1
                st.inflight -= 1
                st.shed += 1
                self.sheds += 1
                victims.append(victim)
        return victims

    @staticmethod
    def _pop_victim(q: Deque[Any], now: float) -> Any:
        for i, r in enumerate(q):
            if r.deadline_s is not None and r.deadline_s <= now:
                del q[i]
                return r
        return q.pop()       # no expired request: shed the freshest arrival

    def release(self, now: float, budget: int) -> List[Any]:
        """Weighted deficit round-robin drain of the tenant queues.

        Each pass credits every backlogged tenant its share, then releases
        from the highest-deficit one — over time tenant ``t`` receives
        ``share_t`` of the release stream, and any tenant with positive
        credit (the floor guarantees it) is released eventually.
        """
        out: List[Any] = []
        while budget > 0:
            backlogged = [st for st in self.tenants.values() if st.queued]
            if not backlogged:
                break
            for st in backlogged:
                self._deficit[st.name] += st.share
            pick = max(backlogged, key=lambda s: (self._deficit[s.name],
                                                  s.name))
            self._deficit[pick.name] -= 1.0
            req = self._queues[pick.name].popleft()
            pick.queued -= 1
            self.releases += 1
            out.append(req)
            budget -= 1
        if not any(st.queued for st in self.tenants.values()):
            for name in self._deficit:
                self._deficit[name] = 0.0
        return out

    # ------------------------------------------------------------ signals
    def on_complete(self, tenant: str, now: float, latency_s: float,
                    hits: int, misses: int) -> None:
        st = self._ensure(tenant or "default")
        st.served += 1
        st.inflight = max(0, st.inflight - 1)
        st.hits += hits
        st.misses += misses
        st.latency.append(latency_s)
        board = self.boards.get(st.name)
        if board is not None:
            board.on_complete(now, latency_s, hits, misses)

    def _refresh_credits(self, now: float) -> None:
        for st in self.tenants.values():
            st.credit = self._credit(st, now)
        self._reshare()

    def _credit(self, st: TenantStats, now: float) -> float:
        """The QY- credit formula over the tenant's own SLO board:
        remaining error budget, divided by penalties for burn-rate excess,
        alert violations and the p99/target ratio.  Tenants with no board
        hold full credit; the floor keeps every credit positive."""
        board = self.boards.get(st.name)
        if board is None or not board.trackers:
            return 1.0
        trackers = list(board.trackers.values())
        budget = min(tr.budget_remaining for tr in trackers)
        burn = max(tr.burn_rates(now)[0] for tr in trackers)
        fired = sum(tr.fired_count for tr in trackers)
        p99_ratio = 1.0
        lat = board.trackers.get("p99_latency") or next(
            (tr for tr in trackers if tr.spec.kind == "latency"), None)
        if lat is not None and lat.spec.threshold_s > 0:
            p99 = st.win_p99_s()
            p99_ratio = p99 / lat.spec.threshold_s
        credit = budget / ((1.0 + max(0.0, burn - 1.0))
                           * (1.0 + self.fire_penalty * fired)
                           * max(1.0, p99_ratio))
        return max(self.credit_floor, min(1.0, credit))

    def _reshare(self) -> None:
        total = sum(st.credit for st in self.tenants.values())
        for st in self.tenants.values():
            st.share = st.credit / total if total > 0 else 0.0

    def credits(self) -> Dict[str, float]:
        return {name: st.credit for name, st in self.tenants.items()}

    # ---------------------------------------------------------------- obs
    def snapshot(self) -> Dict[str, float]:
        """The ``admission.*`` registry island."""
        return {
            "admits": float(self.admits),
            "rejects": float(self.rejects),
            "degrades": float(self.degrades),
            "sheds": float(self.sheds),
            "releases": float(self.releases),
            "adapts": float(self.adapts),
            "overload_enters": float(self.overload_enters),
            "overload_clears": float(self.overload_clears),
            "overloaded": 1.0 if self.overloaded else 0.0,
            "queued": float(self.queue_depth()),
            "cap_scale": float(self._cap_scale),
            "tenants": float(len(self.tenants)),
        }

    def tenants_snapshot(self) -> Dict[str, float]:
        """The ``tenant.*`` registry island: ``<tenant>.<metric>``."""
        out: Dict[str, float] = {}
        for name, st in self.tenants.items():
            for k, v in st.snapshot().items():
                out[f"{name}.{k}"] = v
        return out
