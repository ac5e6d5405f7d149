"""Cache-affinity serving router: data-diffusion dispatch on the request path.

Each model replica is one of the paper's *executors* with a *transient
store*: its KV-prefix blocks, LoRA adapters, or weight shards are the data
objects, accounted by ``core.cache.Cache`` and published to the
``CentralizedIndex`` so the dispatcher knows who holds what.  Incoming
requests are the work items — a request names the objects it needs
(``RoutedRequest.objects``) and the generic ``DataAwareDispatcher`` routes it
with the paper's five policies, unchanged.  The ``DynamicResourceProvisioner``
watches the wait queue and grows/shrinks the replica pool exactly as Section
3.3 prescribes for executors.

The router is transport-agnostic and clock-agnostic: callers pass ``now``
explicitly (the serving loop passes wall-clock, the routing benchmark passes
virtual time), receive ``Assignment`` batches to execute however they like,
and report completions back via ``complete`` — which triggers the Falkon
pickup path (phase 2) for the freed replica.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.dispatch import POLICIES, DataAwareDispatcher
from ..core.index import CacheLocationIndex, CentralizedIndex
from ..dispatch_vec import VectorizedDispatcher
from ..core.provisioner import DynamicResourceProvisioner, ProvisionRequest
from ..core.store import BandwidthResource
from ..core.task import ExecutorState
from ..diffusion.prefetch import Prefetcher
from ..diffusion.tiers import TieredStore, TierSpec, default_tier_weights
from ..diffusion.transfer import TransferEngine
from ..index.warmstart import WarmStartReport, WarmStartStats, clone_hottest
from ..obs.registry import P2Quantile
from .admission import AdmissionController, AdmissionVerdict
from .chaos import FaultStats
from .fault_tolerance import HeartbeatMonitor

__all__ = ["POLICIES", "AdmissionController", "AdmissionVerdict",
           "Assignment", "CacheAffinityRouter", "LatencyReservoir",
           "ReplicaStore", "RoutedRequest", "RouterStats"]


@dataclass
class RoutedRequest:
    """A unit of serving work and the data objects it wants to find cached."""

    request_id: int
    objects: Tuple[str, ...]            # KV-prefix blocks / adapters / shards
    payload: Any = None                 # opaque to the router
    submit_time_s: float = 0.0
    dispatch_time_s: Optional[float] = None
    finish_time_s: Optional[float] = None
    replica: Optional[str] = None
    hits: int = 0                       # objects found in the replica's store
    misses: int = 0                     # objects fetched/recomputed on demand
    # Where each object was resolved: a tier name ("hbm"/"dram"/...), a
    # transfer source ("peer:<name>"/"persistent"), filled by the router.
    sources: Dict[str, str] = field(default_factory=dict)
    restore_cost_s: float = 0.0         # swap-in + transfer time still to pay
    # Multi-tenant admission plane: the paying tenant ("" = the implicit
    # "default" account) and an optional absolute deadline — under overload
    # the admission controller sheds past-deadline requests before fresh
    # ones (runtime/admission.py).
    tenant: str = ""
    deadline_s: Optional[float] = None

    @property
    def key(self) -> int:
        return self.request_id

    @property
    def response_time_s(self) -> Optional[float]:
        if self.finish_time_s is None:
            return None
        return self.finish_time_s - self.submit_time_s


class ReplicaStore:
    """One replica's transient store: a tier stack + index publication.

    Built on ``diffusion.tiers.TieredStore``: the store holds object *names
    and sizes* only (the replica owns the actual KV tensors); presence per
    tier is mirrored into the centralized index so phase-1 routing sees it,
    mirroring the executor->index update messages of Section 3.1.1.  With a
    single tier this is exactly the flat hit-or-admit store of PR 1; with an
    HBM + host-DRAM stack, eviction from HBM *demotes* the KV prefix to DRAM
    instead of dropping it, so a later "miss" is a cheap swap-in rather than
    a full prefill replay.
    """

    def __init__(
        self,
        name: str,
        capacity_bytes: float,
        index: CacheLocationIndex,
        eviction: str = "lru",
        rng=None,
        on_evict: Optional[Callable[[str, str], None]] = None,
        tier_specs: Optional[Sequence[TierSpec]] = None,
        nic_bw_bytes_per_s: float = float("inf"),
    ):
        self.name = name
        self.index = index
        if tier_specs is None:
            tier_specs = [TierSpec("hbm", capacity_bytes, eviction=eviction)]

        def _dropped(obj: str, size: float) -> None:
            if on_evict is not None:
                on_evict(name, obj)   # let the owner free the real payload

        self.tiers = TieredStore(name, tier_specs, index=index,
                                 nic_bw_bytes_per_s=nic_bw_bytes_per_s,
                                 on_drop=_dropped, rng=rng)

    def __contains__(self, obj: str) -> bool:
        return obj in self.tiers

    def contains(self, obj: str) -> bool:
        return obj in self.tiers

    @property
    def top_tier(self) -> str:
        return self.tiers.top_tier

    def tier_of(self, obj: str) -> Optional[str]:
        return self.tiers.tier_of(obj)

    def access(self, obj: str) -> Optional[str]:
        """Hit test + recency update; returns the tier the object was found
        in (None on miss).  Lower-tier hits promote toward HBM."""
        return self.tiers.access(obj)

    def admit(self, obj: str, size_bytes: float) -> List[str]:
        """On-demand caching: object materialized here; returns full drops."""
        return self.tiers.admit(obj, size_bytes)

    def drop(self, obj: str) -> None:
        self.tiers.drop(obj)

    def publish(self) -> Tuple[int, int]:
        """Full-snapshot re-sync (recovery path after index drift/loss)."""
        return self.index.publish(self.name, self.tiers.contents())


@dataclass
class Assignment:
    """A routed batch: run these requests on this replica, then complete()."""

    replica: str
    requests: List[RoutedRequest]


class LatencyReservoir:
    """Fixed-size ring buffer of latency samples + streaming lifetime stats.

    ``RouterStats.latencies_s`` grew one float per request forever — a leak
    at millions-of-users scale.  The reservoir keeps the most recent
    ``maxlen`` samples; **sorted percentiles are exact within that window
    only** (they forget everything older than ``maxlen`` samples — use
    ``window_percentile_s`` / the ``win_``-prefixed metric names, which say
    so).  The streaming aggregates — ``total`` / ``sum`` / ``min`` /
    ``max`` / ``mean_s`` and the P² quantile estimates surfaced as
    ``est_p50_s`` / ``est_p99_s`` — are lifetime-true: they survive ring
    wraps, so the mean and tail latency of a long-running server are not
    silently truncated to its last 4096 requests.  It is list-like where
    the stats code needs it (append / len / iterate).
    """

    __slots__ = ("maxlen", "_buf", "_next", "total", "sum", "min", "max",
                 "_p2_50", "_p2_99")

    def __init__(self, maxlen: int = 4096):
        self.maxlen = int(maxlen)
        self._buf: List[float] = []
        self._next = 0          # ring write cursor once the buffer is full
        self.total = 0          # lifetime sample count (not window-bounded)
        self.sum = 0.0          # lifetime sum: mean survives ring wraps
        self.min = math.inf     # lifetime extremes
        self.max = -math.inf
        self._p2_50 = P2Quantile(0.50)
        self._p2_99 = P2Quantile(0.99)

    def append(self, x: float) -> None:
        self.total += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        self._p2_50.observe(x)
        self._p2_99.observe(x)
        if len(self._buf) < self.maxlen:
            self._buf.append(x)
        else:
            self._buf[self._next] = x
            self._next = (self._next + 1) % self.maxlen

    @property
    def mean_s(self) -> float:
        """Lifetime mean (every sample ever appended, not just the window)."""
        return self.sum / self.total if self.total else 0.0

    def snapshot(self) -> Dict[str, float]:
        out = {
            "count": float(self.total),
            "sum_s": self.sum,
            "mean_s": self.mean_s,
            "window": float(len(self._buf)),
            "est_p50_s": self._p2_50.value,
            "est_p99_s": self._p2_99.value,
        }
        if self.total:
            out["min_s"] = self.min
            out["max_s"] = self.max
        return out

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[float]:
        return iter(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)


@dataclass
class RouterStats:
    routed: int = 0
    completed: int = 0
    object_hits: int = 0
    object_misses: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    latencies_s: LatencyReservoir = field(default_factory=LatencyReservoir)
    # diffusion-plane accounting
    hits_by_tier: Dict[str, int] = field(default_factory=dict)
    restore_time_s: float = 0.0          # total swap-in + transfer time charged
    bytes_from_persistent: float = 0.0   # flat mode only; engine tracks tiered
    # Batched-drain staleness the dispatcher's admission overlay cannot see:
    # replay-time events where the store's actual evolution diverged from
    # the frozen snapshot the batch was decided on — a hit whose object an
    # earlier admission's eviction cascade dropped, a dup-miss re-dropped
    # before its replay position, or an assumed admission that failed to
    # stick (pass-through object).  Counted, never silent; the dispatcher's
    # own counters live in ``dispatcher.stats.batch_stale_decisions`` /
    # ``batch_emulated_decisions``.
    stale_snapshot_drops: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.object_hits + self.object_misses
        return self.object_hits / total if total else 0.0

    @property
    def mean_latency_s(self) -> float:
        """Lifetime mean response time (survives the reservoir's ring wraps)."""
        return self.latencies_s.mean_s

    def window_percentile_s(self, pct: float) -> float:
        """Percentile over the reservoir's retained window ONLY.

        Exact for the most recent ``latencies_s.maxlen`` samples and blind
        to everything older — a *window* p99, not a lifetime p99.  Callers
        printing it should label it ``win_p99`` (the benches do); for a
        lifetime tail that survives ring wraps, read the reservoir's P²
        estimates (``latency.est_p50_s`` / ``latency.est_p99_s``).
        """
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        i = min(len(xs) - 1, max(0, math.ceil(pct / 100.0 * len(xs)) - 1))
        return xs[i]

    # Back-compat name; same window-only semantics as window_percentile_s.
    latency_percentile_s = window_percentile_s

    @property
    def p50_s(self) -> float:
        return self.window_percentile_s(50.0)

    @property
    def p99_s(self) -> float:
        return self.window_percentile_s(99.0)

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``router.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        out = stats_snapshot(self, props=("hit_rate", "mean_latency_s"))
        for k, v in self.latencies_s.snapshot().items():
            out[f"latency.{k}"] = v
        out["latency.win_p50_s"] = self.window_percentile_s(50.0)
        out["latency.win_p99_s"] = self.window_percentile_s(99.0)
        return out


class CacheAffinityRouter:
    """Routes requests to replicas with the paper's data-aware policies.

    Host integration points:
      * ``spawn_replica(name)``  — DRP scaled up: build the actual replica
        (load weights, warm compile) before it starts receiving work.
      * ``stop_replica(name)``   — DRP idle-released the replica.
    Both callbacks are optional; pure-accounting users (benchmarks, tests)
    can drive the router without a model behind it.
    """

    def __init__(
        self,
        policy: str = "good-cache-compute",
        *,
        window: int = 256,
        cpu_util_threshold: float = 0.8,
        max_object_replicas: int = 4,
        replica_capacity_bytes: float = float("inf"),
        eviction: str = "lru",
        object_size_fn: Callable[[str], float] = lambda obj: 1.0,
        index: Optional[CacheLocationIndex] = None,
        provisioner: Optional[DynamicResourceProvisioner] = None,
        spawn_replica: Optional[Callable[[str], None]] = None,
        stop_replica: Optional[Callable[[str], None]] = None,
        on_object_evicted: Optional[Callable[[str, str], None]] = None,
        pickup_batch: int = 1,
        gcc_delay_tier_floor: float = 0.0,
        # ---- tiered data-diffusion plane (None = flat PR-1 behavior) ----
        tier_specs: Optional[Sequence[TierSpec]] = None,
        tier_weights: Optional[Dict[str, float]] = None,
        persistent_bw_bytes_per_s: float = float("inf"),
        nic_bw_bytes_per_s: float = float("inf"),
        transfer_max_inflight: int = 8,
        use_peer_transfer: bool = True,
        prefetch_depth: int = 0,
        # ---- payload plane: "real" makes the transfer engine copy actual
        # bytes through the stores' payload backends (built per replica by
        # payload_factory(name)); "modeled" keeps bookkeeping-only transfers.
        # Decisions are bit-identical in both modes.  ----
        transfer_payload: str = "modeled",
        payload_factory: Optional[Callable[[str], Any]] = None,
        # ---- replica warm-start (index plane): clone this many of the
        # hottest index objects into each DRP-provisioned replica ----
        warmstart_objects: int = 0,
        warmstart_admit_tier: int = 1,
        # Objects at or above this (decayed) heat bypass warmstart_admit_tier
        # and clone straight into HBM (tier 0); None disables.
        warmstart_hbm_heat: Optional[float] = None,
        # ---- dispatch engine: "reference" (pure-Python golden semantics)
        # or "vectorized" (repro.dispatch_vec — same decisions, array-backed
        # scoring).  With ``batch_drain=False`` the router loops per-decision
        # ``notify()``; with ``batch_drain=True`` it drains every free
        # replica from one ``notify_batch()`` scan against a frozen presence
        # snapshot (tier promotions deferred to a per-batch delta, missed
        # objects admitted through one batched transfer resolution) ----
        dispatcher_impl: str = "reference",
        batch_drain: bool = False,
        # Decision-parity escape hatch: record "request_id->replica" for
        # every started request so seeded streams can assert batched ≡
        # looped assignment sequences (bench_serve_batch gates on it).
        log_assignments: bool = False,
        # ---- observability plane (repro.obs): None (default) is the no-op
        # stub path — no spans are allocated and no metric work runs.  An
        # Observability instance adopts every stats island into its
        # registry and records the per-request span chain (dispatch ->
        # transfer -> completion, batch drains as structural spans) into
        # its trace ring.  Decisions are identical either way.  ----
        obs: Optional[Any] = None,
        # ---- robustness plane (failure domain).  All default OFF: with no
        # timeout, no chaos injector, and no heartbeat monitor the serving
        # path is bit-identical to the pre-robustness router (the chaos
        # parity bench gates on it).
        #   transfer_timeout_s     — per-flight peer-copy deadline; a peer
        #       source whose copy_time exceeds it is treated as dead and the
        #       fetch retries against the next-cheapest source.
        #   transfer_max_retries   — retry budget per fetch before the
        #       resolution degrades unconditionally to persistent storage.
        #   chaos                  — runtime.chaos.ChaosInjector; strict
        #       no-op while its schedule is idle.
        #   heartbeat_timeout_s    — enables the HeartbeatMonitor liveness
        #       source (None = no monitor); missed beats crash the replica
        #       through fail_replica, EWMA stragglers lose dispatch ties.
        transfer_timeout_s: Optional[float] = None,
        transfer_max_retries: int = 3,
        transfer_retry_backoff_s: float = 0.05,
        #   transfer_retry_jitter_s — deterministic (seeded) jitter fraction
        #       on the retry backoff ladder so a mass failover's synchronized
        #       retries don't thundering-herd one surviving source; 0.0
        #       (default) keeps the exact legacy ladder.
        transfer_retry_jitter_frac: float = 0.0,
        transfer_jitter_seed: int = 0,
        chaos: Optional[Any] = None,
        heartbeat_timeout_s: Optional[float] = None,
        straggler_factor: float = 2.0,
        # ---- overload robustness plane (multi-tenant admission).  None
        # (default) is a strict no-op: enqueue dispatches exactly as before
        # and returns ACCEPTED unconditionally.  An AdmissionController
        # turns enqueue into the backpressure contract (ACCEPTED / DEGRADED
        # / REJECTED), sheds deadline-expired and over-share work under
        # overload (lowest credit first), biases pick-item dispatch ties by
        # tenant share, and caps per-tenant tier bytes on every store.
        admission: Optional[AdmissionController] = None,
    ):
        self.index = index if index is not None else CentralizedIndex()
        self.tier_specs = list(tier_specs) if tier_specs is not None else None
        if tier_weights is None and self.tier_specs is not None:
            tier_weights = default_tier_weights(self.tier_specs)
        if dispatcher_impl not in ("reference", "vectorized"):
            raise ValueError(f"unknown dispatcher_impl {dispatcher_impl!r}")
        engine_cls = (VectorizedDispatcher if dispatcher_impl == "vectorized"
                      else DataAwareDispatcher)
        self.dispatcher = engine_cls(
            policy=policy,
            window=window,
            cpu_util_threshold=cpu_util_threshold,
            max_replicas=max_object_replicas,
            index=self.index,
            tier_weights=tier_weights,
            gcc_delay_tier_floor=gcc_delay_tier_floor,
            # Batched drains decide against a frozen snapshot; the looped
            # path admits each assignment's objects before the next
            # decision.  Emulating that admission evolution inside the scan
            # keeps batched ≡ looped bit-exact even when the replication
            # cap binds mid-burst (stats.batch_emulated_decisions counts
            # every decision the overlay corrected).
            emulate_batch_admissions=batch_drain,
        )
        self.replica_capacity_bytes = replica_capacity_bytes
        self.eviction = eviction
        self.object_size_fn = object_size_fn
        self.drp = provisioner
        self.admission = admission
        self._payload_factory = payload_factory
        self._spawn = spawn_replica
        self._stop = stop_replica
        self._on_object_evicted = on_object_evicted
        self.pickup_batch = pickup_batch
        self.nic_bw_bytes_per_s = nic_bw_bytes_per_s
        self.stores: Dict[str, ReplicaStore] = {}
        # The transfer engine + prefetcher exist only in tiered mode; the
        # flat path keeps PR-1's zero-cost admit (no bandwidth model).
        self.engine: Optional[TransferEngine] = None
        self.prefetcher: Optional[Prefetcher] = None
        if self.tier_specs is not None:
            self.persistent_link = BandwidthResource(
                "persistent.link", persistent_bw_bytes_per_s)
            self.engine = TransferEngine(
                self.index, self.persistent_link,
                max_inflight=transfer_max_inflight, use_peers=use_peer_transfer,
                payload=transfer_payload,
                timeout_s=transfer_timeout_s,
                max_retries=transfer_max_retries,
                retry_backoff_s=transfer_retry_backoff_s,
                retry_jitter_frac=transfer_retry_jitter_frac,
                jitter_seed=transfer_jitter_seed,
                chaos=chaos)
            if prefetch_depth > 0:
                self.prefetcher = Prefetcher(self.engine, object_size_fn)
        self.prefetch_depth = prefetch_depth
        self.warmstart_objects = warmstart_objects
        self.warmstart_admit_tier = warmstart_admit_tier
        self.warmstart_hbm_heat = warmstart_hbm_heat
        self.warmstart = WarmStartStats()
        self.batch_drain = batch_drain
        self.assignment_log: Optional[List[str]] = [] if log_assignments else None
        self._requests: Dict[int, RoutedRequest] = {}   # in flight, by id
        self._idle_since: Dict[str, Optional[float]] = {}
        self._pending_provisions: List[ProvisionRequest] = []
        self._next_replica = 0
        self.stats = RouterStats()
        # Failure-domain accounting island.  Always allocated (counters are
        # cheap); the chaos injector, when attached, adopts it so injection
        # and recovery counters land in one ``faults.*`` snapshot.
        self.faults = FaultStats()
        self.chaos = chaos
        if chaos is not None:
            chaos.bind(self.faults)
            if hasattr(self.index, "rpc_loss"):
                # Sharded coherence wire: chaos may drop update RPCs.
                self.index.rpc_loss = chaos.rpc_lost
        self.monitor: Optional[HeartbeatMonitor] = (
            HeartbeatMonitor(heartbeat_timeout_s, straggler_factor)
            if heartbeat_timeout_s is not None else None)
        # Poisoned copies awaiting re-fetch: recovery is deferred to tick()
        # so a corruption detected mid-read never mutates the store it was
        # detected inside of (re-entrancy hazard).
        self._corrupt_refetch: List[Tuple[str, str]] = []
        # Observability stub path: hooks test `self._trace is not None` /
        # `self._perf is not None` once each — with obs=None nothing is
        # allocated or computed on the hot path (tests/test_obs.py asserts
        # the disabled path records zero spans).
        self.obs = obs
        self._trace = obs.trace if obs is not None else None
        self._perf = obs.perf if obs is not None else None
        self._slo = getattr(obs, "slo", None) if obs is not None else None
        if obs is not None:
            self._register_obs_sources(obs)

    def _register_obs_sources(self, obs: Any) -> None:
        """Adopt every stats island this router owns into the obs registry.

        Each island stays authoritative (the registry reads ``snapshot()``
        lazily at collect time); prefixes are the stable plane names
        ``docs/metrics.md`` catalogues."""
        reg = obs.registry
        reg.register_source("router", self.stats)
        reg.register_source("dispatch", self.dispatcher.stats)
        reg.register_source("warmstart", self.warmstart)
        reg.register_source("faults", self.faults)
        if self.engine is not None:
            reg.register_source("transfer", self.engine.stats)
            self.engine.trace = self._trace     # flight/payload spans
        if self.prefetcher is not None:
            reg.register_source("prefetch", self.prefetcher.stats)
        bus = getattr(self.index, "bus", None)
        if bus is not None and hasattr(bus, "stats"):
            reg.register_source("coherence", bus.stats)
        reg.register_callable("tiers", self._tiers_snapshot)
        if self.admission is not None:
            reg.register_source("admission", self.admission)
            reg.register_callable("tenant", self._tenant_snapshot)

    def _tiers_snapshot(self) -> Dict[str, float]:
        """Fleet aggregate of every replica store's per-tier counters."""
        out: Dict[str, float] = {}
        for store in self.stores.values():
            for k, v in store.tiers.snapshot().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _tenant_snapshot(self) -> Dict[str, float]:
        """The ``tenant.*`` island: per-tenant accounts, with resident
        tier bytes refreshed from the stores' quota accounting (lazy —
        snapshot-time only, nothing on the request path)."""
        adm = self.admission
        totals: Dict[str, float] = {}
        for store in self.stores.values():
            for t, b in store.tiers.tenant_bytes.items():
                totals[t] = totals.get(t, 0.0) + b
        for name, st in adm.tenants.items():
            st.tier_bytes = totals.get(name, 0.0)
        return adm.tenants_snapshot()

    @property
    def policy(self) -> str:
        return self.dispatcher.policy

    # ------------------------------------------------------------- replicas
    def add_replica(
        self,
        name: Optional[str] = None,
        capacity_bytes: Optional[float] = None,
        eviction: Optional[str] = None,
        now: Optional[float] = None,
    ) -> str:
        if name is None:
            name = f"replica{self._next_replica}"
            self._next_replica += 1
        self.stores[name] = ReplicaStore(
            name,
            capacity_bytes if capacity_bytes is not None else self.replica_capacity_bytes,
            self.index,
            eviction=eviction or self.eviction,
            on_evict=self._on_object_evicted,
            tier_specs=self.tier_specs,
            nic_bw_bytes_per_s=self.nic_bw_bytes_per_s,
        )
        if self._payload_factory is not None:
            backend = self._payload_factory(name)
            if hasattr(backend, "on_corruption"):
                # Degrade-don't-die: a poisoned spill chunk drops the copy
                # and queues a re-fetch instead of failing the request.
                backend.on_corruption = (
                    lambda obj, _n=name: self._note_corruption(_n, obj))
            self.stores[name].tiers.attach_payload(backend)
        if self.admission is not None:
            quotas = self.admission.store_quotas()
            if quotas:
                # One tenant's working set cannot evict above its share:
                # the store refuses placements past the tenant's byte cap.
                self.stores[name].tiers.set_tenant_quotas(
                    quotas, self.admission.tenant_of_object)
        if self.engine is not None:
            self.engine.register(name, self.stores[name].tiers)
        if self.monitor is not None:
            self.monitor.register(name, now)
        self.dispatcher.register_executor(name)
        # idle clock starts at first observation (None), NOT at 0.0 — under
        # wall-clock time a 0.0 stamp would make a fresh replica look idle
        # since the epoch and releasable on the very next tick.
        self._idle_since[name] = None
        return name

    def remove_replica(self, name: str) -> None:
        self.dispatcher.deregister_executor(name)   # drops its index entries
        if self.engine is not None:
            self.engine.deregister(name)
        if self.monitor is not None:
            self.monitor.forget(name)
        if self.chaos is not None:
            self.chaos.forget(name)
        self.stores.pop(name, None)
        self._idle_since.pop(name, None)

    def fail_replica(self, name: str, now: Optional[float] = None
                     ) -> List[RoutedRequest]:
        """Replica crash — distinct from ``remove_replica`` (graceful
        scale-down, which assumes the replica drained its work first).

        Crash semantics, in order:
          1. every in-flight request dispatched to the dead replica is
             orphaned: reset to undispatched state and re-submitted exactly
             once (the ``_finish`` guard drops any stale completion the dead
             replica might still report, so accounting stays at-most-once);
          2. the index quarantines immediately — live entries drop *and*
             queued coherence ops naming the dead executor are purged, so a
             delayed "add" can never resurrect a claim on a crashed store;
          3. the transfer engine evacuates: inbound flights cancel (slots/ω
             released, single-flight joiners notified of terminal failure),
             outbound flights fail over to the next-cheapest source;
          4. the DRP back-fills the lost capacity 1:1 (the replacement
             warm-starts from surviving peers via the usual scale-up path).

        Returns the orphaned requests (already re-queued).
        """
        now = time.monotonic() if now is None else now
        if name not in self.stores:
            return []
        self.faults.replicas_failed += 1
        if self.monitor is not None:
            self.monitor.forget(name)
        if self.chaos is not None:
            self.chaos.forget(name)
        orphans = [r for r in self._requests.values()
                   if r.replica == name and r.finish_time_s is None
                   and r.dispatch_time_s is not None]
        # Quarantine before deregister: entry count is observable only while
        # the executor's map still exists.
        self.faults.index_entries_quarantined += len(self.index.cached_at(name))
        quarantine = getattr(self.index, "quarantine_executor", None)
        if quarantine is not None:
            self.faults.bus_ops_purged += quarantine(name)
        self.dispatcher.deregister_executor(name)   # idempotent second drop
        if self.engine is not None:
            self.engine.fail_replica(name, now)
        self.stores.pop(name, None)
        self._idle_since.pop(name, None)
        if self._stop is not None:
            self._stop(name)
        for r in orphans:
            self.faults.requests_requeued += 1
            if self._slo is not None:
                self._slo.record_failure(now)   # availability burn
            # Reset to pre-dispatch state; the hit/miss work done on the
            # dead replica is lost and will be re-done (and re-counted)
            # wherever the request lands next.
            r.replica = None
            r.dispatch_time_s = None
            r.hits = 0
            r.misses = 0
            r.sources = {}
            r.restore_cost_s = 0.0
            self.dispatcher.submit(r)
        if self._trace is not None:
            self._trace.record(-1, name, "failure", now, now, name, "",
                               (len(orphans),))
        if self.drp is not None:
            self.drp.registered = max(0, self.drp.registered - 1)
            req = self.drp.request(1, now)     # 1:1 capacity back-fill
            if req is not None:
                self._pending_provisions.append(req)
                self.faults.backfills_requested += 1
        return orphans

    # ------------------------------------------------- liveness / heartbeats
    def record_heartbeat(self, name: str, step_time_s: Optional[float] = None,
                         now: Optional[float] = None) -> None:
        """Feed the liveness source; ``step_time_s`` drives EWMA straggler
        detection (a straggling replica stops winning cache-affinity ties)."""
        if self.monitor is not None:
            self.monitor.heartbeat(
                name, step_time_s,
                time.monotonic() if now is None else now)

    def check_liveness(self, now: Optional[float] = None) -> List[str]:
        """Crash replicas whose heartbeat lapsed; refresh straggler
        penalties.  Returns the names failed this call."""
        if self.monitor is None:
            return []
        now = time.monotonic() if now is None else now
        lost = [n for n in self.monitor.check(now) if n in self.stores]
        for name in lost:
            self.faults.heartbeat_losses += 1
            self.fail_replica(name, now)
        strag = {n: 1.0 for n in self.monitor.stragglers()
                 if n in self.stores}
        if strag != self.dispatcher.penalties:
            self.dispatcher.set_penalties(strag)
        self.faults.straggler_penalties = len(strag)
        return lost

    # ------------------------------------------------- corruption / brown-out
    def _note_corruption(self, replica: str, obj: str) -> None:
        """Payload backend detected a poisoned spill chunk (sha256 mismatch)
        while reading ``obj``.  Recovery is deferred to the next tick: drop
        the copy, quarantine its index entry, re-fetch from a clean source."""
        self.faults.payload_corruptions_recovered += 1
        self._corrupt_refetch.append((replica, obj))

    def _drain_corrupt_refetch(self, now: float) -> None:
        pending, self._corrupt_refetch = self._corrupt_refetch, []
        for replica, obj in pending:
            store = self.stores.get(replica)
            if store is None:
                continue                    # replica died meanwhile
            if obj in store:
                store.drop(obj)             # withdraws the index entry too
            if self.engine is not None:
                self.engine.fetch(obj, self.object_size_fn(obj), replica,
                                  now, allow_queue=True)
                self.faults.refetches_issued += 1

    def _browned_out(self, now: float) -> bool:
        """Failure-storm brown-out: when the availability SLO's fast burn
        rate fires, shed speculative traffic (prefetch warms, scale-up
        warm-starts) so recovery bandwidth goes to demand fetches."""
        if self._slo is None:
            return False
        tracker = self._slo.trackers.get("availability")
        if tracker is None:
            return False
        fast, _slow = tracker.burn_rates(now)
        active = fast >= tracker.spec.fire_burn
        self.faults.brownout_active = 1 if active else 0
        return active

    def replicas(self) -> List[str]:
        return list(self.stores)

    # --------------------------------------------------------------- submit
    def enqueue(self, request: RoutedRequest,
                now: Optional[float] = None) -> AdmissionVerdict:
        """Queue a request without running the drain — the batch-drain entry
        point: callers enqueue a burst, then ``tick()`` once so the whole
        burst is decided in a single window scan.

        Returns the admission verdict (the backpressure contract).  With no
        admission controller attached the verdict is ``ACCEPTED``
        unconditionally and the path is bit-identical to the pre-admission
        router.  ``REJECTED`` requests are refused at the edge — counted on
        the tenant's account and traced as a ``shed`` span, never silently
        dropped."""
        now = time.monotonic() if now is None else now
        if request.submit_time_s == 0.0:
            request.submit_time_s = now
        verdict = AdmissionVerdict.ACCEPTED
        if self.admission is not None:
            verdict = self.admission.on_submit(request, now)
            if verdict is AdmissionVerdict.REJECTED:
                self._shed_span(request, now, "rejected")
                return verdict
        self._requests[request.request_id] = request
        if verdict is AdmissionVerdict.ACCEPTED:
            self.dispatcher.submit(request)
        # DEGRADED: admitted into the controller's bounded tenant queue;
        # tick()'s admission pump releases it by credit share (or sheds it).
        if self.drp is not None:
            depth = self.dispatcher.queue_length()
            if self.admission is not None:
                depth += self.admission.queue_depth()
            req = self.drp.on_queue_change(now, depth)
            if req is not None:
                self._pending_provisions.append(req)
        return verdict

    def submit(self, request: RoutedRequest, now: Optional[float] = None) -> List[Assignment]:
        """Enqueue a request; returns any assignments routable right away."""
        now = time.monotonic() if now is None else now
        self.enqueue(request, now)
        return self.tick(now)

    def queue_length(self) -> int:
        return self.dispatcher.queue_length()

    def pending_admission(self) -> int:
        """Requests held under backpressure in tenant queues (0 without an
        admission controller — or whenever it is not overloaded)."""
        return self.admission.queue_depth() if self.admission is not None else 0

    # ----------------------------------------------------------- main pump
    def tick(self, now: Optional[float] = None) -> List[Assignment]:
        """Drive elasticity + phase-1 routing; returns new assignments."""
        now = time.monotonic() if now is None else now
        if self.engine is not None:
            self.engine.drain(now)      # release bandwidth of landed copies
        if self._corrupt_refetch:
            self._drain_corrupt_refetch(now)
        self._complete_provisions(now)
        if self.admission is not None:
            self._admission_pump(now)
        self._maybe_release(now)
        out = self._drain_notify(now)
        if self._perf is not None:
            # Pool-utilization sample for the live resource integral
            # (perf.resource_hours / perf.utilization), taken *after* the
            # drain so the burst just assigned counts: non-free replicas
            # (BUSY or PENDING-notified) are in use.
            n = self.dispatcher.registered()
            self._perf.on_sample(now, float(n),
                                 float(n - self.dispatcher.free_count()))
        return out

    def _shed_span(self, request: RoutedRequest, now: float,
                   reason: str) -> None:
        """Trace a shed/rejected request: wall time from submit to the shed
        decision, so the critical-path analyzer can attribute rejected-vs-
        served time.  Request-attributed (never sampled out)."""
        if self._trace is not None:
            t0 = request.submit_time_s or now
            self._trace.record(request.request_id, "shed", "shed",
                               t0, now, "", "",
                               (request.tenant or "default", reason))

    def _admission_pump(self, now: float) -> None:
        """Overload control loop, once per tick: adapt (dead-band credit
        controller), shed its victims, release queued work into the
        dispatcher by credit share, refresh tenant dispatch-tie weights."""
        adm = self.admission
        capacity = max(1, len(self.stores)) * max(1, self.pickup_batch)
        victims = adm.adapt(now, queued=self.dispatcher.queue_length(),
                            capacity=capacity)
        for r in victims:
            self._requests.pop(r.request_id, None)
            self._shed_span(r, now, "shed")
        if adm.queue_depth() > 0:
            if adm.overloaded:
                # keep the dispatcher fed to ~2x pool headroom; the rest
                # waits under backpressure in the tenant queues
                budget = max(0, 2 * capacity - self.dispatcher.queue_length())
            else:
                budget = adm.queue_depth()   # overload cleared: drain fully
            for r in adm.release(now, budget):
                self.dispatcher.submit(r)
        # Tenant-weighted pick-item ties engage only while overloaded (and
        # clear after), so a controller that never saw overload leaves the
        # dispatch sequence bit-identical to admission=None.
        if adm.overloaded and len(adm.tenants) > 1:
            weights = {n: st.share for n, st in adm.tenants.items()}
            if weights != self.dispatcher.tenant_weights:
                self.dispatcher.set_tenant_weights(weights)
        elif self.dispatcher.tenant_weights:
            self.dispatcher.set_tenant_weights({})

    def _drain_notify(self, now: float) -> List[Assignment]:
        if self.batch_drain:
            return self._drain_batched(now)
        out: List[Assignment] = []
        while True:
            pair = self.dispatcher.notify()
            if pair is None:
                return out
            replica, request = pair
            out.append(self._start(replica, [request], now))

    def _drain_batched(self, now: float) -> List[Assignment]:
        """Single-scan batched drain (the serving batch plane).

        ``notify_batch`` decides every assignable (replica, request) pair
        from one window scan over a frozen presence snapshot — nothing
        mutates dispatcher or index state between the emulated per-decision
        calls, which is exactly the precondition the vectorized engine's
        batched drain documents.  The batch is then *executed*: hits are
        accounted with tier promotions deferred into each store's delta log,
        misses are collected and admitted through one batched transfer
        resolution, and the promotion delta is applied once at the end.  The
        outer loop re-scans after applying (mirroring the looped path's
        terminal failed ``notify()``), so anything the batch's effects made
        assignable still goes out this tick.
        """
        out: List[Assignment] = []
        while True:
            pairs = self.dispatcher.notify_batch()
            if not pairs:
                return out
            for store in self.stores.values():
                store.tiers.defer_promotions()
            try:
                sink: List[Tuple] = []
                for replica, request in pairs:
                    out.append(self._start(replica, [request], now,
                                           miss_sink=sink))
                self._replay_batch(pairs, sink, now)
                trace = self._trace
                if trace is not None:
                    # Dispatch spans are finalized *after* the replay so the
                    # hit/miss attribution reflects stale-snapshot
                    # conversions — identical to what the looped path
                    # records at decision time (parity-asserted).
                    for replica, request in pairs:
                        srcs = request.sources
                        # Insertion-ordered; parity_digest canonicalizes
                        # (sorting here would tax every request to make a
                        # snapshot-time comparison cheaper).
                        trace.record(
                            request.request_id, "dispatch", "dispatch",
                            now, now, replica, "request",
                            (request.hits, request.misses,
                             tuple(srcs.items()) if srcs else ()))
                    # Structural: the whole wave was one window scan.
                    trace.record(-1, "drain", "drain", now, now,
                                 detail=(len(pairs),))
            finally:
                applied = 0
                for store in self.stores.values():
                    applied += store.tiers.apply_promotions()
                if applied and self._trace is not None:
                    # Structural: the coalesced tier-promotion replay.
                    # Drains that promoted nothing record nothing — an
                    # empty replay is not an event.
                    self._trace.record(-1, "promote_replay", "promote",
                                       now, now, detail=(applied,))

    def _replay_batch(self, pairs: List[Tuple[str, RoutedRequest]],
                      sink: List[Tuple], now: float) -> None:
        """Execute a drained batch's store mutations in looped order.

        Each assignment's entries replay in per-request object order —
        promotion here, admission there — so cache recency (and therefore
        every future eviction victim) evolves exactly as the looped
        per-decision path's would.  Source resolution happens *at the
        replay position* through one shared batch resolver (one drain,
        candidate sorts amortized), so an admission earlier in the batch
        that evicted a peer's copy is seen exactly as sequential fetches
        would see it.  A "hit" entry whose object an earlier admission's
        eviction cascade dropped off the stack is converted back to the
        miss the looped path would have taken (its recorded tier/cost
        accounting is reversed exactly).  first-available records nothing
        in the sink, so its replay is a no-op by construction.
        """
        resolve = None
        by_replica: Dict[str, List[Tuple]] = {}
        for replica, obj, kind, tier, amount in sink:
            by_replica.setdefault(replica, []).append((obj, kind, tier, amount))

        def admit_miss(request: RoutedRequest, store: ReplicaStore,
                       replica: str, obj: str, size: float) -> None:
            nonlocal resolve
            if resolve is None:
                resolve = self.engine.batch_resolver(now)
            tr = resolve(obj, size, replica, admit=False)
            request.sources[obj] = tr.source
            cost = tr.remaining_s(now)
            request.restore_cost_s += cost
            self.stats.restore_time_s += cost
            if self._trace is not None:
                self._trace.record(request.request_id, obj, "transfer",
                                   now, now + cost, replica, "dispatch",
                                   (tr.source,))
            store.admit(obj, tr.size_bytes)
            if obj not in store.tiers:
                # Pass-through (fits no tier): the scan's admission overlay
                # assumed this copy would exist — count the staleness.
                self.stats.stale_snapshot_drops += 1

        for replica, request in pairs:
            store = self.stores[replica]
            for obj, kind, tier, amount in by_replica.get(replica, ()):
                if kind == "hit":
                    if obj in store.tiers:
                        store.tiers.apply_promotion(obj)
                        continue
                    # Cascade-dropped before its replay position: reverse
                    # the hit accounting and take the looped path's miss.
                    self.stats.stale_snapshot_drops += 1
                    request.hits -= 1
                    self.stats.object_hits -= 1
                    self.stats.hits_by_tier[tier] -= 1
                    if self.stats.hits_by_tier[tier] == 0:
                        del self.stats.hits_by_tier[tier]   # as looped never
                        #                                     created the key
                    request.restore_cost_s -= amount
                    self.stats.restore_time_s -= amount
                    request.misses += 1
                    self.stats.object_misses += 1
                    admit_miss(request, store, replica, obj,
                               self.object_size_fn(obj))
                elif kind == "miss":        # counted at decision time
                    admit_miss(request, store, replica, obj, amount)
                else:                       # dupmiss: second occurrence of a
                    # just-admitted object — a top-tier hit paying the
                    # transfer's remaining time (unless a cascade dropped
                    # it again in between, then it is a fresh miss).
                    found = store.access(obj)
                    if found is None:
                        self.stats.stale_snapshot_drops += 1
                        request.hits -= 1
                        self.stats.object_hits -= 1
                        request.misses += 1
                        self.stats.object_misses += 1
                        admit_miss(request, store, replica, obj, amount)
                        continue
                    self.stats.hits_by_tier[found] = \
                        self.stats.hits_by_tier.get(found, 0) + 1
                    request.sources[obj] = found
                    cost = self.engine.remaining_s(replica, obj, now)
                    request.restore_cost_s += cost
                    self.stats.restore_time_s += cost
                    if self._trace is not None and found != store.top_tier \
                            and cost > 0.0:
                        # Mirror of the looped path's lower-tier-hit span.
                        self._trace.record(request.request_id, obj,
                                           "promote", now, now + cost,
                                           replica, "dispatch", (found,))
        # Prefetch warms run after the replay (the looped path warms at the
        # end of each _start, i.e. after that request's own admissions) —
        # per-store mutation order is preserved.  In batch mode the warm
        # targets the post-batch queue: the whole burst was already
        # decided, so speculation goes to work actually still waiting.
        if self.prefetcher is not None:
            if pairs and self._browned_out(now) \
                    and self.dispatcher.queue_length() > 0:
                self.faults.brownout_sheds += 1
            else:
                for replica, _request in pairs:
                    if self.dispatcher.queue_length() == 0:
                        break
                    for item in self.dispatcher.peek(self.prefetch_depth):
                        self.prefetcher.warm(
                            replica, self.dispatcher.objects_of(item), now)

    def _start(self, replica: str, requests: List[RoutedRequest], now: float,
               miss_sink: Optional[List[Tuple]] = None,
               ) -> Assignment:
        """Start ``requests`` on ``replica`` (hit/miss accounting + data
        movement).  With ``miss_sink`` (the batched drain), every cached-path
        object position appends a replay entry ``(replica, obj, kind, tier,
        amount)`` — kind "hit" (tier found, cost charged), "miss" (amount =
        size), or "dupmiss" (same object's second occurrence riding the
        first's admission) — and the store-mutating half (admissions, source
        resolution, promotion application) is deferred to the caller's
        ordered replay."""
        self.dispatcher.set_state(replica, ExecutorState.BUSY)
        store = self.stores[replica]
        use_cache = self.dispatcher.provides_location_info()
        trace = self._trace
        for request in requests:
            request.replica = replica
            request.dispatch_time_s = now
            self.stats.routed += 1
            if self.assignment_log is not None:
                self.assignment_log.append(f"{request.request_id}->{replica}")
            sunk: set = set()       # objects this request already miss-sank
            for obj in request.objects:
                # Access-heat feed: the warm-start plane ranks clone
                # candidates by these per-object counters (decayed toward
                # the *current* hot set when the index has a heat half-life).
                self.index.note_access(obj, now=now)
                if not use_cache:
                    # first-available: every access replays from persistent
                    # storage and nothing is kept.
                    request.misses += 1
                    self.stats.object_misses += 1
                    self.stats.bytes_from_persistent += self.object_size_fn(obj)
                    if trace is not None:
                        trace.record(request.request_id, obj, "transfer",
                                     now, now, replica, "dispatch",
                                     ("persistent",))
                    continue
                # Intent logged by a *previous* access of this request (the
                # epoch holds at most this one request's intents): checked
                # before access(), which may log one for obj itself.
                pre_intent = miss_sink is not None and store.tiers.has_intent(obj)
                tier = store.access(obj)
                if tier is not None:
                    if pre_intent and tier != store.top_tier:
                        # Second hit on an object whose first hit (earlier
                        # in this request) logged a promote intent: the
                        # looped path already relocated it, so this access
                        # would have found it at the top tier for free.
                        tier = store.top_tier
                    request.hits += 1
                    self.stats.object_hits += 1
                    self.stats.hits_by_tier[tier] = \
                        self.stats.hits_by_tier.get(tier, 0) + 1
                    request.sources[obj] = tier
                    cost = self._hit_cost(store, replica, obj, tier, now)
                    request.restore_cost_s += cost
                    if trace is not None and tier != store.top_tier and cost > 0.0:
                        # Lower-tier hit: the swap-in toward HBM is the
                        # analyzer's "promote" segment (request-attributed,
                        # never sampled out; identical in both drain modes
                        # since cost is computed pre-replay).
                        trace.record(request.request_id, obj, "promote",
                                     now, now + cost, replica, "dispatch",
                                     (tier,))
                    if miss_sink is not None and self.engine is not None:
                        # flat mode (no engine) admits inline, so its hits
                        # can never be invalidated by a deferred admission
                        # — only the tiered path records hit entries.
                        miss_sink.append((replica, obj, "hit", tier, cost))
                elif miss_sink is not None and obj in sunk:
                    # Batched drain, same object twice in one request: the
                    # looped path would hit the copy its first miss just
                    # admitted — count the hit now; tier/source/cost are
                    # filled by the replay once the admission lands.
                    request.hits += 1
                    self.stats.object_hits += 1
                    size = self.object_size_fn(obj)
                    miss_sink.append((replica, obj, "dupmiss", None, size))
                else:
                    # miss: diffuse the object in — cheapest of peer NIC vs
                    # persistent store (tiered mode), or PR-1's zero-cost
                    # admit (flat mode).
                    request.misses += 1
                    self.stats.object_misses += 1
                    size = self.object_size_fn(obj)
                    if self.engine is not None and miss_sink is not None:
                        # batched drain: defer to the one-pass union
                        # resolution + ordered replay in _drain_batched
                        # (sources/cost filled after every decision of the
                        # batch is made).
                        sunk.add(obj)
                        miss_sink.append((replica, obj, "miss", None, size))
                    elif self.engine is not None:
                        tr = self.engine.fetch(obj, size, replica, now)
                        request.sources[obj] = tr.source
                        cost = tr.remaining_s(now)
                        request.restore_cost_s += cost
                        if trace is not None:
                            trace.record(request.request_id, obj, "transfer",
                                         now, now + cost, replica,
                                         "dispatch", (tr.source,))
                    else:
                        request.sources[obj] = "persistent"
                        self.stats.bytes_from_persistent += size
                        store.admit(obj, size)
                        if trace is not None:
                            trace.record(request.request_id, obj, "transfer",
                                         now, now, replica, "dispatch",
                                         ("persistent",))
            self.stats.restore_time_s += request.restore_cost_s
            if trace is not None and miss_sink is None:
                # Looped/pickup path: the decision is final here.  The
                # batched drain records its dispatch spans after the replay
                # instead, once stale-snapshot conversions are resolved —
                # both modes carry identical attribution (parity-asserted).
                srcs = request.sources
                trace.record(request.request_id, "dispatch", "dispatch",
                             now, now, replica, "request",
                             (request.hits, request.misses,
                              tuple(srcs.items()) if srcs else ()))
        # Warm this replica for the next queued work while it computes: the
        # transfer overlaps the batch it was just assigned (prefetch plane).
        # In the batched drain (miss_sink set) the warm is deferred to after
        # the batch replay so speculative admissions cannot interleave ahead
        # of the batch's own deferred store mutations.
        if self.prefetcher is not None and miss_sink is None \
                and self.dispatcher.queue_length() > 0:
            if self._browned_out(now):
                self.faults.brownout_sheds += 1
            else:
                for item in self.dispatcher.peek(self.prefetch_depth):
                    self.prefetcher.warm(replica,
                                         self.dispatcher.objects_of(item), now)
        return Assignment(replica, requests)

    def _hit_cost(self, store: ReplicaStore, replica: str, obj: str,
                  tier: str, now: float) -> float:
        """Swap-in cost of a hit: 0 at the top tier; lower tiers pay a read
        at the tier's bandwidth; an object whose transfer is still in flight
        (admitted early by the engine) pays the remaining transfer time."""
        if self.prefetcher is not None:
            self.prefetcher.on_access(replica, obj, now)
        pending = self.engine.remaining_s(replica, obj, now) if self.engine else 0.0
        if tier == store.top_tier:
            return pending
        bw = store.tiers.tier_bw(tier)
        swap = self.object_size_fn(obj) / max(bw.available(), 1e-9)
        return max(pending, swap)

    def warm_start(self, name: str, now: Optional[float] = None) -> WarmStartReport:
        """Bulk-clone the hottest index objects into replica ``name``.

        Runs automatically on DRP scale-up when ``warmstart_objects > 0``;
        callable directly for manually added replicas.  Clones ride the
        transfer engine's *speculative* priority class, so live demand
        fetches preempt them instead of queueing behind the warm-up."""
        now = time.monotonic() if now is None else now
        report = clone_hottest(
            self.index,
            self.stores[name].tiers,
            name,
            self.object_size_fn,
            now,
            max_objects=self.warmstart_objects,
            engine=self.engine,
            admit_tier=self.warmstart_admit_tier,
            hbm_heat_threshold=self.warmstart_hbm_heat,
        )
        self.warmstart.merge(report)
        return report

    def persistent_bytes_read(self) -> float:
        """Total bytes pulled from the persistent store (both modes)."""
        if self.engine is not None:
            return self.engine.stats.bytes_from_persistent + self.stats.bytes_from_persistent
        return self.stats.bytes_from_persistent

    # ------------------------------------------------------------- complete
    def _finish(self, request: RoutedRequest, now: float) -> Optional[str]:
        """Completion bookkeeping; returns the freed replica (if still ours)."""
        if request.dispatch_time_s is None or request.finish_time_s is not None:
            # At-most-once: a crashed replica reporting a completion for a
            # request that was already requeued (dispatch_time_s reset by
            # fail_replica) — or a double complete() — must not double-count.
            # The requeued request completes wherever it was re-dispatched.
            self.faults.stale_completions_dropped += 1
            return None
        request.finish_time_s = now
        self._requests.pop(request.request_id, None)
        self.stats.completed += 1
        if request.response_time_s is not None:
            self.stats.latencies_s.append(request.response_time_s)
            if self._slo is not None:
                self._slo.on_complete(now, request.response_time_s,
                                      request.hits, request.misses)
            if self.admission is not None:
                self.admission.on_complete(request.tenant or "default", now,
                                           request.response_time_s,
                                           request.hits, request.misses)
        replica = request.replica
        if self._trace is not None:
            # Root span: submit -> finish, closing the request's causal chain.
            self._trace.record(request.request_id, "request", "request",
                               request.submit_time_s, now, replica or "",
                               "", (request.hits, request.misses))
        if self._perf is not None and request.dispatch_time_s is not None:
            self._perf.on_complete(now, now - request.dispatch_time_s,
                                   request.hits, request.misses)
        if replica in self.stores:
            self.dispatcher.set_state(replica, ExecutorState.FREE)
            self._idle_since[replica] = now
            return replica
        return None

    def _pickup(self, replica: str, now: float) -> Optional[Assignment]:
        """Falkon pickup: a freed replica asks for window-scored work."""
        if replica in self.stores and self.dispatcher.queue_length() > 0 \
                and self.dispatcher.executor_state(replica) == ExecutorState.FREE:
            self.dispatcher.set_state(replica, ExecutorState.PENDING)
            picked = self.dispatcher.pick_items(replica, m=self.pickup_batch)
            if picked:
                return self._start(replica, picked, now)
        return None

    def complete(self, request: RoutedRequest, now: Optional[float] = None) -> List[Assignment]:
        """Replica finished a request: free it and run the pickup path."""
        now = time.monotonic() if now is None else now
        replica = self._finish(request, now)
        assignments = self.tick(now)
        if replica is not None:
            picked = self._pickup(replica, now)
            if picked is not None:
                assignments.append(picked)
        return assignments

    def complete_batch(self, requests: Sequence[RoutedRequest],
                       now: Optional[float] = None) -> List[Assignment]:
        """Batched completion: free a whole wave of finished replicas, then
        run *one* drain and one pickup pass.

        The per-request ``complete`` runs a full phase-1 drain per
        completion — at serving rates that is the dominant scheduling cost
        (N completions = N window scans).  Completing the wave together
        amortizes it to a single drain (single-scan with ``batch_drain``),
        then offers phase-2 pickups to the replicas phase 1 left free, in
        completion order.  Decisions match per-request completion whenever
        the drain's decisions are insensitive to the completion
        interleaving (the batch-plane contract; bench_serve_batch asserts
        it on its seeded streams).
        """
        now = time.monotonic() if now is None else now
        freed = [r for r in (self._finish(req, now) for req in requests)
                 if r is not None]
        assignments = self.tick(now)
        for replica in freed:
            picked = self._pickup(replica, now)
            if picked is not None:
                assignments.append(picked)
        return assignments

    # ----------------------------------------------------------- elasticity
    def _complete_provisions(self, now: float) -> None:
        if self.drp is None:
            return
        due = [r for r in self._pending_provisions if r.ready_time_s <= now]
        for req in due:
            self._pending_provisions.remove(req)
            self.drp.complete(req)
            for _ in range(req.nodes):
                name = self.add_replica(now=now)
                self.stats.scale_ups += 1
                if self._spawn is not None:
                    self._spawn(name)
                if self.warmstart_objects > 0:
                    # Scale-up happened because load is high — exactly when a
                    # cold replica's miss streak hurts most.  Clone the
                    # hottest peer-held objects in before it takes work —
                    # unless a failure storm browned us out, in which case
                    # the bandwidth belongs to demand recovery.
                    if self._browned_out(now):
                        self.faults.brownout_sheds += 1
                    else:
                        self.warm_start(name, now)

    def _maybe_release(self, now: float) -> None:
        if self.drp is None or self.dispatcher.queue_length() > 0:
            return
        if self.admission is not None:
            # Admitted (non-shed) demand still waiting under backpressure
            # keeps its capacity: a valley right after a shed episode must
            # not over-shrink the pool.  Feed the DRP's demand floor and
            # skip release entirely while tenant queues are backlogged.
            pending = self.admission.queue_depth()
            self.drp.demand_floor = math.ceil(
                pending / max(1.0, self.drp.tasks_per_node_target))
            if pending > 0:
                return
        for name in list(self.stores):
            if self.dispatcher.executor_state(name) != ExecutorState.FREE:
                continue
            if len(self.stores) <= self.drp.min_nodes:
                return
            idle_since = self._idle_since.get(name)
            if idle_since is None:
                self._idle_since[name] = now   # first sighting: clock starts
                continue
            if self.drp.should_release(idle_since, now):
                self.drp.release(1)
                self.stats.scale_downs += 1
                if self._stop is not None:
                    self._stop(name)
                self.remove_replica(name)
