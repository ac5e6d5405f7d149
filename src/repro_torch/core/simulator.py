"""Discrete-event simulator of the data-diffusion system (paper Section 5).

Runs the *real* scheduler (`core/scheduler.py`), index, caches, and
provisioner components against an event-driven model of the hardware: a
persistent store with a contended aggregate link (GPFS), per-node transient
stores (local disk + NIC for peer reads), executors (one per CPU, 2 per
node), and GRAM4-like allocation latency.  The paper itself planned this DES
("we also plan to do a thorough validation of the model through
discrete-event simulations") — here it doubles as the reproduction vehicle
for Figures 4–15 and the calibration source for the abstract model (Fig 2).

Hardware profiles:
  * ``teragrid_profile``  — ANL/UC TeraGrid calibration: GPFS aggregate
    ~4.55 Gb/s contended ceiling (measured plateau 4.4 Gb/s in Fig 4), node
    local reads ~1.6 Gb/s (page-cache-assisted; peak aggregate 100 Gb/s over
    64 nodes, Fig 12), 1 Gb/s NIC, 2 executors/node, 30–60 s allocation.
  * ``tpu_pod_profile``   — the TPU adaptation: object store 100 GB/s
    aggregate, host DRAM cache reads 40 GB/s, 25 GB/s DCN NIC, 4 hosts/alloc,
    10 s elastic-rescale latency. Used by the beyond-paper scale study.
"""

from __future__ import annotations

import heapq
import math
import random as _random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from typing import Union

from ..diffusion.tiers import TieredStore, TierSpec
from ..obs.registry import nearest_rank_index
from .index import CentralizedIndex, ShardedIndex
from .provisioner import DynamicResourceProvisioner, ProvisionRequest
from .scheduler import make_scheduler
from .store import BandwidthResource, PersistentStore, TransientStore
from .task import ExecutorState, Task, TaskState
from .workload import Workload

GBIT = 1e9 / 8.0  # bytes/s per Gb/s


@dataclass
class HardwareProfile:
    name: str
    executors_per_node: int = 2
    persistent_bw_bytes: float = 4.55 * GBIT       # GPFS aggregate ceiling
    disk_bw_bytes: float = 1.6 * GBIT              # per-node local cache read
    nic_bw_bytes: float = 1.0 * GBIT               # per-node peer-transfer NIC
    dispatch_latency_s: float = 0.002              # service<->executor RTT leg
    delivery_time_s: float = 0.0005                # result delivery D_T
    # Per-policy dispatcher decision cost (from paper Fig 3 throughputs).
    decision_cost_s: Dict[str, float] = field(
        default_factory=lambda: {
            "first-available": 1.0 / 2981,
            "first-cache-available": 1.0 / 1800,
            "max-cache-hit": 1.0 / 1322,
            "max-compute-util": 1.0 / 1666,
            "good-cache-compute": 1.0 / 1600,
        }
    )


def teragrid_profile() -> HardwareProfile:
    return HardwareProfile(name="teragrid")


def tpu_pod_profile() -> HardwareProfile:
    return HardwareProfile(
        name="tpu-pod",
        executors_per_node=4,                  # chips per host acting as lanes
        persistent_bw_bytes=100e9,             # object-store aggregate
        disk_bw_bytes=40e9,                    # host DRAM shard cache
        nic_bw_bytes=25e9,                     # DCN peer transfer
        dispatch_latency_s=0.0002,
        delivery_time_s=0.0001,
    )


@dataclass
class SimConfig:
    policy: str = "good-cache-compute"
    cache_size_per_node_bytes: float = 4 * 1024**3
    max_nodes: int = 64
    min_nodes: int = 0
    eviction: str = "lru"
    window: int = 3200
    cpu_util_threshold: float = 0.8
    max_replicas: int = 4
    provisioner_policy: str = "watermark"
    tasks_per_node_target: float = 32.0
    coherence_delay_s: float = 5.0   # loose index coherence (paper Sec 3.1.1)
    allocation_latency_s: Tuple[float, float] = (30.0, 60.0)
    idle_release_s: float = 120.0
    static_nodes: Optional[int] = None      # static provisioning (no DRP)
    pickup_batch: int = 1                   # m tasks per pickup
    sample_dt_s: float = 10.0
    seed: int = 0
    # fault injection: (time_s, node_index) pairs -> node fails at time
    failures: Tuple[Tuple[float, int], ...] = ()
    # Optional tier hierarchy (diffusion plane): when set, each node runs a
    # TieredStore (promote-on-access / demote-on-evict) instead of the flat
    # TransientStore, and byte throughput is accounted *per tier* rather
    # than in the single "local" bucket.  ``cache_size_per_node_bytes`` is
    # ignored in that case — capacities come from the specs.
    tiers: Optional[Tuple[TierSpec, ...]] = None
    # Sharded cache-location index plane: > 0 runs the scheduler over a
    # ShardedIndex with that many consistent-hash shards (batched per-shard
    # coherence); 0 keeps the paper's flat CentralizedIndex.  Dispatch
    # decisions are identical either way (bench_index_scale asserts it) —
    # the knob exists so DES studies can measure the coherence/scan planes.
    index_shards: int = 0
    # Coherence heartbeat quantization (sharded plane only): update messages
    # landing inside one window ride a single batched delta application.
    # > 0 trades index staleness for batch amortization — the DES's
    # stale-claim counters quantify the dispatch-quality cost (the paper's
    # Sec 3.1.1 loose-coherence argument, measured).
    coherence_batch_window_s: float = 0.0
    # Coherence window auto-tuning (closes the sweep's loop): at every
    # sample tick the bus adapts ``batch_window_s`` from the stale-claim
    # rate measured since the previous adaptation — shrink when dispatch
    # quality suffers, widen toward ``coherence_autotune_max_window_s``
    # when claims are comfortably under ``coherence_autotune_target``.
    coherence_autotune: bool = False
    coherence_autotune_target: float = 0.02
    coherence_autotune_max_window_s: float = 10.0
    # Array-backed dispatch plane (repro.dispatch_vec): decision-identical
    # to the reference scheduler — asserted by tests and the
    # bench_dispatch_vec smoke gate — but batched: phase 1 drains all free
    # executors from one window scan, scores come from incrementally
    # maintained demand x presence matrices.
    vectorized_dispatch: bool = False


@dataclass
class Node:
    name: str
    store: Union[TransientStore, TieredStore]
    executors: List[str]
    idle_since: float = 0.0
    lost: bool = False


@dataclass
class TimePoint:
    t: float
    queue_len: int
    nodes: int
    busy: int
    registered_execs: int
    throughput_bytes: Dict[str, float]      # bucket bytes by source
    ideal_bytes: float                      # arrival_rate * file_size * dt
    cpu_util: float


@dataclass
class SimResult:
    config: SimConfig
    profile: HardwareProfile
    workload_name: str
    wet_s: float                            # workload execution time
    ideal_wet_s: float
    tasks_done: int
    hits_local: int
    hits_remote: int
    misses: int
    cpu_time_hours: float                   # integral of registered executors
    avg_response_s: float
    peak_queue: int
    series: List[TimePoint]
    bytes_by_source: Dict[str, float]
    interval_completion: Dict[int, float]   # arrival-interval -> last done t
    avg_cpu_util: float
    scheduler_decisions: int
    stale_claims: int = 0                   # index overstated locality
    misdirected: int = 0                    # locality promised, none found
    # Batch-drain decisions whose branch would differ had each dispatch's
    # admissions landed synchronously (the serving router's looped
    # semantics): quantifies how far the DES's frozen-snapshot bulk drains
    # sit from per-decision scheduling.  Counted, never silent.
    batch_stale_decisions: int = 0

    # -- derived metrics (paper Section 5.2.x definitions) -------------------
    @property
    def efficiency(self) -> float:
        return self.ideal_wet_s / self.wet_s if self.wet_s > 0 else 0.0

    @property
    def hit_rate_local(self) -> float:
        tot = self.hits_local + self.hits_remote + self.misses
        return self.hits_local / tot if tot else 0.0

    @property
    def hit_rate_remote(self) -> float:
        tot = self.hits_local + self.hits_remote + self.misses
        return self.hits_remote / tot if tot else 0.0

    @property
    def miss_rate(self) -> float:
        tot = self.hits_local + self.hits_remote + self.misses
        return self.misses / tot if tot else 0.0

    @property
    def avg_throughput_gbps(self) -> float:
        total = sum(self.bytes_by_source.values())
        return total * 8 / 1e9 / self.wet_s if self.wet_s > 0 else 0.0

    def peak_throughput_gbps(self, pct: float = 0.99) -> float:
        rates = sorted(
            sum(tp.throughput_bytes.values()) * 8 / 1e9 / max(1e-9, self.config.sample_dt_s)
            for tp in self.series
        )
        if not rates:
            return 0.0
        # Nearest-rank percentile: ceil(pct*n)-1, clamped.  The old
        # int(pct*n) was one rank too high whenever pct*n landed on an
        # integer (p50 of 2 samples picked the max) — exactly the
        # small-sample regime short DES runs produce.
        return rates[nearest_rank_index(pct, len(rates))]

    def speedup_vs(self, baseline_wet_s: float) -> float:
        return baseline_wet_s / self.wet_s if self.wet_s > 0 else 0.0

    def performance_index_raw(self, baseline_wet_s: float) -> float:
        sp = self.speedup_vs(baseline_wet_s)
        return sp / self.cpu_time_hours if self.cpu_time_hours > 0 else 0.0

    def slowdown_by_interval(self, interval_s: float = 60.0) -> Dict[int, float]:
        """SL per arrival interval: completion span / ideal span (>=1)."""
        out = {}
        for i, t_done in sorted(self.interval_completion.items()):
            start = i * interval_s
            out[i] = max(1.0, (t_done - start) / interval_s)
        return out


class Simulator:
    """Event-driven executor of a Workload under a SimConfig + profile."""

    # event kinds ordered deterministically via a sequence counter
    def __init__(self, workload: Workload, config: SimConfig,
                 profile: HardwareProfile, obs=None, chaos=None):
        self.wl = workload
        self.cfg = config
        self.hw = profile
        self.now = 0.0
        self._events: List[Tuple[float, int, str, object]] = []
        self._eseq = 0
        self._rng = _random.Random(config.seed)

        self.gpfs = PersistentStore("gpfs", profile.persistent_bw_bytes)
        for obj in workload.objects:
            self.gpfs.add(obj)
        self.obj_size = {o.name: o.size_bytes for o in workload.objects}

        if config.index_shards > 0:
            self.index = ShardedIndex(
                shards=config.index_shards,
                coherence_delay_s=config.coherence_delay_s,
                batch_window_s=config.coherence_batch_window_s,
            )
        else:
            self.index = CentralizedIndex(coherence_delay_s=config.coherence_delay_s)
        self.sched = make_scheduler(
            vectorized=config.vectorized_dispatch,
            policy=config.policy,
            window=config.window,
            cpu_util_threshold=config.cpu_util_threshold,
            max_replicas=config.max_replicas,
            index=self.index,
        )
        self.drp = DynamicResourceProvisioner(
            max_nodes=config.max_nodes,
            min_nodes=config.min_nodes,
            policy=config.provisioner_policy,
            tasks_per_node_target=config.tasks_per_node_target,
            allocation_latency_s=config.allocation_latency_s,
            idle_release_s=config.idle_release_s,
            seed=config.seed,
        )

        self.nodes: Dict[str, Node] = {}
        self.exec_node: Dict[str, str] = {}
        self._node_counter = 0
        # accounting
        self.hits_local = 0
        self.hits_remote = 0
        self.misses = 0
        # Coherence-quality counters: a *stale claim* is a task whose index
        # view at execution time promised more local objects than the store
        # actually held (loose coherence overstating locality); a
        # *misdirected dispatch* is the worst case — locality promised,
        # nothing local at all.  Both rise with coherence_batch_window_s.
        self.stale_claims = 0
        self.misdirected = 0
        self._adapt_last_claims = 0
        self._adapt_last_done = 0
        self.done = 0
        self.peak_queue = 0
        self.exec_seconds = 0.0
        self._last_acct_t = 0.0
        self._responses_sum = 0.0
        # Per-source byte buckets: one per tier when a hierarchy is
        # configured, else the paper's flat "local" bucket; "remote" (peer
        # NIC) and "gpfs" (persistent) always exist.
        cache_buckets = (
            [t.name for t in config.tiers] if config.tiers else ["local"]
        )
        self.bytes_by_source = {k: 0.0 for k in cache_buckets + ["remote", "gpfs"]}
        self._bucket_bytes = dict(self.bytes_by_source)
        self._busy_util_integral = 0.0
        self._series: List[TimePoint] = []
        self.interval_completion: Dict[int, float] = {}
        self._failures = sorted(config.failures)
        # Chaos plane (runtime.chaos.ChaosInjector): crash times and
        # straggle episodes are pre-drawn from the injector's seeded RNG at
        # construction, so the event schedule is deterministic and an
        # attached-but-idle injector leaves the run bit-identical (no RNG
        # draws, no events).
        self.chaos = chaos
        self._sim_straggles: Dict[int, Tuple[float, float]] = {}
        if chaos is not None and not chaos.idle:
            horizon = max(1.0, workload.ideal_span_s)
            self._failures = sorted(
                self._failures
                + chaos.draw_sim_crashes(config.max_nodes, horizon))
            self._sim_straggles = chaos.draw_sim_straggles(
                config.max_nodes, horizon)
        # Observability plane (repro.obs): when wired, every sample tick
        # publishes the DES's live state as gauges in the same dotted
        # namespace the serving path uses (perf.*, coherence.stale_claims)
        # and records a structural "sample" span — so sim-vs-live curves
        # overlay without any renaming.  None (default) is a no-op stub.
        self.obs = obs
        self._obs_trace = obs.trace if obs is not None else None
        if obs is not None:
            obs.registry.register_source("dispatch", self.sched.stats)
            bus = getattr(self.index, "bus", None)
            if bus is not None and hasattr(bus, "stats"):
                obs.registry.register_source("coherence_bus", bus.stats)
            if chaos is not None:
                obs.registry.register_source("faults", chaos.stats)

    # ----------------------------------------------------------- event infra
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self._events, (t, self._eseq, kind, payload))
        self._eseq += 1

    def _maybe_adapt_coherence(self) -> None:
        """Feed the measured stale-claim rate back into the coherence bus
        (``CoherenceBus.adapt``) — the auto-tuning loop the sweep in
        ``bench_diffusion_tiers`` quantified the tradeoff for."""
        if not self.cfg.coherence_autotune or not hasattr(self.index, "bus"):
            return
        done_d = self.done - self._adapt_last_done
        if done_d < 20:
            return              # too few completions for a stable rate
        rate = (self.stale_claims - self._adapt_last_claims) / done_d
        self.index.bus.adapt(
            rate,
            target_rate=self.cfg.coherence_autotune_target,
            max_window_s=self.cfg.coherence_autotune_max_window_s,
        )
        self._adapt_last_claims = self.stale_claims
        self._adapt_last_done = self.done

    def _account(self, t: float) -> None:
        """Integrate executor-seconds and utilization up to time t."""
        dt = t - self._last_acct_t
        if dt > 0:
            n = self.sched.registered()
            self.exec_seconds += n * dt
            self._busy_util_integral += self.sched.utilization() * n * dt
            self._last_acct_t = t

    # ------------------------------------------------------------------- run
    def run(self) -> SimResult:
        for task in self.wl.tasks:
            self._push(task.submit_time_s, "arrive", task)
        for (t, node_idx) in self._failures:
            self._push(t, "fail_node", node_idx)
        if self.cfg.static_nodes:
            self._add_nodes(self.cfg.static_nodes)
            self.drp.registered = self.cfg.static_nodes
        next_sample = 0.0
        total = len(self.wl.tasks)
        while self._events and self.done < total:
            t, _, kind, payload = heapq.heappop(self._events)
            # emit samples for every bucket boundary crossed
            while next_sample <= t:
                self._sample(next_sample)
                self._maybe_adapt_coherence()
                next_sample += self.cfg.sample_dt_s
            self._account(t)
            self.now = t
            self.index.apply_updates(t)   # loose coherence drain
            getattr(self, f"_on_{kind}")(payload)
        self._sample(self.now)
        return self._result()

    # ---------------------------------------------------------------- events
    def _on_arrive(self, task: Task) -> None:
        self.sched.submit(task)
        self.peak_queue = max(self.peak_queue, self.sched.queue_length())
        if not self.cfg.static_nodes:
            req = self.drp.on_queue_change(self.now, self.sched.queue_length())
            if req is not None:
                self._push(req.ready_time_s, "provision_ready", req)
        self._try_notify()

    def _on_provision_ready(self, req: ProvisionRequest) -> None:
        n = self.drp.complete(req)
        self._add_nodes(n)
        self._try_notify()

    def _add_nodes(self, n: int) -> None:
        for _ in range(n):
            name = f"n{self._node_counter:04d}"
            self._node_counter += 1
            if self.cfg.tiers:
                # Tiered diffusion plane: index updates still flow through
                # the simulator's loose-coherence queue, so the store itself
                # is index-less here.
                store = TieredStore(
                    name, self.cfg.tiers, index=None,
                    nic_bw_bytes_per_s=self.hw.nic_bw_bytes,
                )
            else:
                store = TransientStore(
                    name,
                    self.cfg.cache_size_per_node_bytes,
                    self.hw.disk_bw_bytes,
                    self.hw.nic_bw_bytes,
                    eviction=self.cfg.eviction,
                )
            executors = [f"{name}.e{i}" for i in range(self.hw.executors_per_node)]
            self.nodes[name] = Node(name, store, executors, idle_since=self.now)
            for e in executors:
                self.exec_node[e] = name
                self.sched.register_executor(e)

    def _on_fail_node(self, node_idx: int) -> None:
        """Fault injection: node dies; running tasks replay (paper's replay
        policy); cached data is lost; index entries dropped."""
        name = f"n{node_idx:04d}"
        node = self.nodes.get(name)
        if node is None or node.lost:
            return
        node.lost = True
        for e in node.executors:
            self.sched.deregister_executor(e)
        self.drp.registered = max(0, self.drp.registered - 1)
        if not self.cfg.static_nodes:
            req = self.drp.on_queue_change(self.now, max(1, self.sched.queue_length()))
            if req is not None:
                self._push(req.ready_time_s, "provision_ready", req)

    def _try_notify(self) -> None:
        # Batched phase-1 drain: nothing mutates scheduler/index state
        # between assignments here, which is exactly the notify_batch
        # contract — the reference engine loops notify() internally, the
        # vectorized engine drains every free executor from a single scan.
        for executor, task in self.sched.notify_batch():
            self._push(self.now + self.hw.dispatch_latency_s, "exec_tasks",
                       (executor, [task]))

    def _on_pickup(self, executor: str) -> None:
        """Executor pull path (after task completion): window-scored batch."""
        if executor not in self.exec_node or self.exec_node[executor] not in self.nodes:
            return  # executor lost between notify and pickup
        tasks = self.sched.pick_tasks(executor, m=self.cfg.pickup_batch)
        if not tasks:
            self._try_notify()
            return
        self._on_exec_tasks((executor, tasks))

    def _on_exec_tasks(self, payload) -> None:
        executor, tasks = payload
        node = self.nodes.get(self.exec_node.get(executor, ""), None)
        if node is None or node.lost:
            for task in tasks:  # replay policy: node died before execution
                self.sched.requeue(task)
            self._try_notify()
            return
        self.sched.set_state(executor, ExecutorState.BUSY)
        t_start = self.now
        engaged: List[Tuple[BandwidthResource, float]] = []
        total_time = 0.0
        for task in tasks:
            task.dispatch_time_s = self.now
            task.state = TaskState.RUNNING
            dur, eng = self._service_time(task, node)
            total_time += dur
            engaged.extend(eng)
        for res, nbytes in engaged:
            res.begin()
        self._push(t_start + total_time, "tasks_done", (executor, tasks, engaged))

    def _service_time(
        self, task: Task, node: Node
    ) -> Tuple[float, List[Tuple[BandwidthResource, float]]]:
        """Dispatch + data access + compute + delivery for one task."""
        hw, cfg = self.hw, self.cfg
        o = (
            hw.decision_cost_s.get(cfg.policy, 0.0006)
            + 2 * hw.dispatch_latency_s
            + hw.delivery_time_s
        )
        data_t = 0.0
        engaged: List[Tuple[BandwidthResource, float]] = []
        use_cache = cfg.policy != "first-available"
        tiered = bool(cfg.tiers)
        claimed = self.index.cache_hits(task.files, task.executor) \
            if use_cache and task.executor else 0
        local_before = task.hits_local
        for f in task.files:
            size = self.obj_size[f]
            if use_cache and tiered:
                # tier-resolved hit: charge the read at the *found* tier's
                # bandwidth (the access itself promotes the object upward).
                tier = node.store.access(f)
                if tier is not None:
                    bwres = node.store.tier_bw(tier)
                    data_t += size / max(bwres.available(), 1e-9)
                    engaged.append((bwres, size))
                    task.hits_local += 1
                    self.hits_local += 1
                    self._bucket_bytes[tier] += size
                    continue
            elif use_cache and node.store.cache.access(f):
                rate = node.store.disk.available()
                data_t += size / max(rate, 1e-9)
                engaged.append((node.store.disk, size))
                task.hits_local += 1
                self.hits_local += 1
                self._bucket_bytes["local"] += size
                continue
            src_node = self._find_peer(f, exclude=node.name) if use_cache else None
            if src_node is not None:
                rate = min(src_node.store.nic.available(), node.store.nic.available())
                data_t += size / max(rate, 1e-9)
                engaged.append((src_node.store.nic, size))
                engaged.append((node.store.nic, 0.0))
                task.hits_remote += 1
                self.hits_remote += 1
                self._bucket_bytes["remote"] += size
            else:
                rate = self.gpfs.link.available()
                data_t += size / max(rate, 1e-9)
                engaged.append((self.gpfs.link, size))
                task.misses += 1
                self.misses += 1
                self._bucket_bytes["gpfs"] += size
            if use_cache:
                self._insert_cached(node, f, size)
        actual_local = task.hits_local - local_before
        if claimed > actual_local:
            self.stale_claims += 1
            if actual_local == 0:
                self.misdirected += 1
        compute_t = task.compute_time_s
        if self._sim_straggles:
            ep = self._sim_straggles.get(int(node.name[1:]))
            if ep is not None and ep[0] <= self.now < ep[1]:
                # Straggle episode: degraded service (slow node), not death.
                compute_t *= self.chaos.schedule.straggle_factor
        return o + data_t + compute_t, engaged

    def _find_peer(self, f: str, exclude: str) -> Optional[Node]:
        """Least-NIC-loaded live node holding f (per the data fetch policy)."""
        best: Optional[Node] = None
        best_load = None
        for e in sorted(self.index.locations(f)):   # ties by name: reproducible
            nname = self.exec_node.get(e)
            if nname is None or nname == exclude:
                continue
            nd = self.nodes.get(nname)
            if nd is None or nd.lost:
                continue
            if best is None or nd.store.nic.omega < best_load:
                best, best_load = nd, nd.store.nic.omega
        return best

    def _insert_cached(self, node: Node, f: str, size: float) -> None:
        """Cache insert; index updates flow via loose-coherence messages.

        Tiered stores only withdraw presence when an object falls off the
        *bottom* tier (demotion keeps it node-resident and index-visible).
        """
        if self.cfg.tiers:
            dropped = node.store.admit(f, size)
            placed = f in node.store
        else:
            dropped = node.store.cache.insert(f, size)
            placed = f in node.store.cache
        for ev in dropped:
            for e in node.executors:
                self.index.enqueue_update(self.now, "remove", ev, e)
        if placed:
            for e in node.executors:
                self.index.enqueue_update(self.now, "add", f, e)

    def _on_tasks_done(self, payload) -> None:
        executor, tasks, engaged = payload
        for res, nbytes in engaged:
            res.end(nbytes)
        for task in tasks:
            task.finish_time_s = self.now
            task.state = TaskState.DONE
            self.done += 1
            self._responses_sum += task.response_time_s
            interval = int(task.submit_time_s // self.wl.interval_duration_s)
            self.interval_completion[interval] = max(
                self.interval_completion.get(interval, 0.0), self.now
            )
        node = self.nodes.get(self.exec_node.get(executor, ""), None)
        if node is None or node.lost:
            return
        self.sched.set_state(executor, ExecutorState.FREE)
        node.idle_since = self.now
        # Executor immediately asks for more work (Falkon pickup path).
        if self.sched.queue_length() > 0:
            self.sched.set_state(executor, ExecutorState.PENDING)
            self._push(self.now + self.hw.dispatch_latency_s, "pickup", executor)
        else:
            self._maybe_release(node)
        self._try_notify()

    def _maybe_release(self, node: Node) -> None:
        if self.cfg.static_nodes or self.cfg.idle_release_s <= 0:
            return
        self._push(self.now + self.cfg.idle_release_s + 1e-6, "idle_check", node.name)

    def _on_idle_check(self, node_name: str) -> None:
        node = self.nodes.get(node_name)
        if node is None or node.lost:
            return
        all_free = all(
            self.sched.executor_state(e) == ExecutorState.FREE
            for e in node.executors
            if e in self.sched._executors
        )
        if (
            all_free
            and self.sched.queue_length() == 0
            and self.drp.should_release(node.idle_since, self.now)
        ):
            node.lost = True
            for e in node.executors:
                self.sched.deregister_executor(e)
            self.drp.release(1)

    # --------------------------------------------------------------- metrics
    def _arrival_rate_at(self, t: float) -> float:
        i = int(t // self.wl.interval_duration_s)
        rates = self.wl.interval_rates
        if not rates:
            return 0.0
        return rates[min(i, len(rates) - 1)] if t <= self.wl.ideal_span_s else 0.0

    def _sample(self, t: float) -> None:
        self._account(t)
        file_size = self.wl.objects[0].size_bytes if self.wl.objects else 0.0
        live_nodes = sum(1 for nd in self.nodes.values() if not nd.lost)
        self._series.append(
            TimePoint(
                t=t,
                queue_len=self.sched.queue_length(),
                nodes=live_nodes,
                busy=sum(
                    1
                    for s in self.sched._executors.values()
                    if s == ExecutorState.BUSY
                ),
                registered_execs=self.sched.registered(),
                throughput_bytes=dict(self._bucket_bytes),
                ideal_bytes=self._arrival_rate_at(t) * file_size * self.cfg.sample_dt_s,
                cpu_util=self.sched.utilization(),
            )
        )
        for k in self._bucket_bytes:
            self.bytes_by_source[k] += self._bucket_bytes[k]
            self._bucket_bytes[k] = 0.0
        if self.obs is not None:
            tp = self._series[-1]
            reg = self.obs.registry
            dt = max(1e-9, self.cfg.sample_dt_s)
            reg.gauge("perf.throughput_gbps").set(
                sum(tp.throughput_bytes.values()) * 8 / 1e9 / dt)
            reg.gauge("perf.utilization").set(tp.cpu_util)
            reg.gauge("perf.queue_len").set(float(tp.queue_len))
            reg.gauge("perf.nodes").set(float(tp.nodes))
            reg.gauge("perf.completed").set(float(self.done))
            reg.gauge("coherence.stale_claims").set(float(self.stale_claims))
            reg.gauge("coherence.misdirected").set(float(self.misdirected))
            if self._obs_trace is not None:
                self._obs_trace.record(-1, "sample", "sample", t, t,
                                       detail=(tp.queue_len, tp.nodes))

    def _result(self) -> SimResult:
        self._account(self.now)
        avg_util = (
            self._busy_util_integral / self.exec_seconds if self.exec_seconds > 0 else 0.0
        )
        return SimResult(
            config=self.cfg,
            profile=self.hw,
            workload_name=self.wl.name,
            wet_s=self.now,
            ideal_wet_s=self.wl.ideal_span_s,
            tasks_done=self.done,
            hits_local=self.hits_local,
            hits_remote=self.hits_remote,
            misses=self.misses,
            cpu_time_hours=self.exec_seconds / 3600.0,
            avg_response_s=self._responses_sum / max(1, self.done),
            peak_queue=self.peak_queue,
            series=self._series,
            bytes_by_source=dict(self.bytes_by_source),
            interval_completion=dict(self.interval_completion),
            avg_cpu_util=avg_util,
            scheduler_decisions=self.sched.stats.decisions,
            stale_claims=self.stale_claims,
            misdirected=self.misdirected,
            batch_stale_decisions=self.sched.stats.batch_stale_decisions,
        )


def run_experiment(
    workload: Workload, config: SimConfig,
    profile: Optional[HardwareProfile] = None, obs=None, chaos=None,
) -> SimResult:
    return Simulator(workload, config, profile or teragrid_profile(),
                     obs=obs, chaos=chaos).run()
