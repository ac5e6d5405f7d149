"""Deterministic chaos plane: seeded fault injection for the serving path.

The paper's recovery story assumes executors *leave cleanly* (DRP
scale-down plus the task-replay policy).  This module supplies the failures
that assumption hides: replica crashes, stragglers, transfer flakes and
timeouts, payload corruption under ``RealPayload``'s sha256 check, and
shard-RPC loss — all drawn from one private seeded RNG so a chaos run is
exactly reproducible from ``(FaultSchedule, seed)``.

Contract (the same shape as ``obs=None``): the injector is *strictly
inert* unless a fault actually fires.

  * The injector owns its own ``random.Random(seed)`` — probing it never
    perturbs any system RNG, so an attached injector cannot shift seeded
    workload draws.
  * Every probe guards on its rate *before* touching the RNG: an idle
    schedule (all rates zero) consumes nothing and returns "no fault"
    everywhere, so a fault-free run with the plane attached is
    bit-identical to a run without it (``bench_chaos`` asserts this on
    assignment logs + tier contents, the same way the obs plane is
    parity-gated).

Consumers:

  * ``DiffusionServer(chaos=...)`` calls ``begin_step`` once per serving
    step and applies the returned crash/straggle verdicts through
    ``CacheAffinityRouter.fail_replica`` and the heartbeat feed;
  * ``TransferEngine(chaos=...)`` consults ``transfer_fault`` per fetch
    attempt inside its retry/backoff loop;
  * ``ShardedIndex`` RPC loss is applied by the router's coherence feed
    (``rpc_lost`` drops an ``enqueue_update`` on the floor, counted);
  * ``Simulator(chaos=...)`` pre-draws crash events and straggle windows
    over the workload horizon (``draw_sim_crashes`` / ``draw_sim_straggles``)
    so the DES event heap stays the only clock.

``FaultStats`` is the ``faults.*`` metrics island (``docs/metrics.md``):
the router owns one instance covering the *recovery* side; ``bind``-ing an
injector to it lands the injection counters in the same island.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["ChaosInjector", "FaultSchedule", "FaultStats", "flip_spill_byte"]


@dataclass
class FaultStats:
    """The ``faults.*`` island: injection on one side, recovery on the other.

    Zero-valued when no chaos plane is attached (the router always owns an
    instance; registering it costs one lazy ``snapshot()`` per collect).
    """

    # -- injection (ChaosInjector) -------------------------------------------
    crashes_injected: int = 0
    straggles_injected: int = 0
    transfer_faults_injected: int = 0
    corruptions_injected: int = 0
    rpc_losses_injected: int = 0
    spikes_injected: int = 0            # arrival-spike episodes begun
    spike_active: int = 0               # gauge: spike episode in progress
    # -- recovery (router / payload plane) -----------------------------------
    replicas_failed: int = 0            # fail_replica invocations
    requests_requeued: int = 0          # orphans re-enqueued exactly once
    stale_completions_dropped: int = 0  # dead replica "completed" a requeued req
    index_entries_quarantined: int = 0  # live entries dropped at crash time
    bus_ops_purged: int = 0             # queued coherence ops naming the dead
    backfills_requested: int = 0        # DRP 1:1 crash back-fills
    payload_corruptions_recovered: int = 0
    refetches_issued: int = 0           # persistent re-fetches of poisoned KV
    heartbeat_losses: int = 0           # liveness-declared (vs injected) deaths
    straggler_penalties: int = 0        # gauge: replicas currently penalized
    brownout_sheds: int = 0             # speculative work refused under storm
    brownout_active: int = 0            # gauge: availability burn latch

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (prefixed ``faults.`` when adopted)."""
        from ..obs.registry import stats_snapshot
        return stats_snapshot(self, rename={
            "payload_corruptions_recovered": "payload.corruptions_recovered",
        })


@dataclass(frozen=True)
class FaultSchedule:
    """Declarative fault mix; all-zero (the default) is strictly inert."""

    crash_rate: float = 0.0         # P(crash) per replica per step; the DES
    #                                 reads it as a per-node hazard (1/s)
    max_crashes: int = 0            # lifetime kill budget
    min_survivors: int = 1          # never kill below this many replicas
    straggle_rate: float = 0.0      # P(slow-down onset) per replica per step
    straggle_factor: float = 4.0    # service-time multiplier while straggling
    straggle_steps: int = 8         # how long a straggle episode lasts
    flake_rate: float = 0.0         # P(transient failure) per fetch attempt
    timeout_rate: float = 0.0       # P(injected timeout) per fetch attempt
    corrupt_rate: float = 0.0       # P(one spill bit-flip) per step
    rpc_loss_rate: float = 0.0      # P(dropped shard update) per enqueue
    spike_rate: float = 0.0         # P(arrival-spike onset) per step
    spike_multiplier: float = 2.0   # offered-load multiplier while spiking
    spike_steps: int = 3            # how long a spike episode lasts
    start_step: int = 0             # steps of grace before chaos begins

    @property
    def idle(self) -> bool:
        return (self.crash_rate <= 0.0 and self.straggle_rate <= 0.0
                and self.flake_rate <= 0.0 and self.timeout_rate <= 0.0
                and self.corrupt_rate <= 0.0 and self.rpc_loss_rate <= 0.0
                and self.spike_rate <= 0.0)

    @classmethod
    def serving_default(cls) -> "FaultSchedule":
        """The ``repro.launch.serve --chaos SEED`` mix: every fault class
        fires within a short smoke run, severity bounded so the run can
        still prove recovery (zero lost requests, SLO intact)."""
        return cls(crash_rate=0.04, max_crashes=2, min_survivors=1,
                   straggle_rate=0.05, straggle_factor=3.0, straggle_steps=4,
                   flake_rate=0.15, timeout_rate=0.05,
                   corrupt_rate=0.25, rpc_loss_rate=0.05, start_step=2)

    @classmethod
    def overload_default(cls) -> "FaultSchedule":
        """The multi-tenant overload mix (``--chaos SEED --tenants N``):
        arrival spikes drive the admission plane past its overload latch
        while a light fault mix keeps the recovery path honest.  Kept
        separate from ``serving_default`` so the single-tenant chaos smoke's
        seeded draws stay pinned."""
        return cls(straggle_rate=0.04, straggle_factor=2.0, straggle_steps=3,
                   flake_rate=0.10, timeout_rate=0.03,
                   spike_rate=0.25, spike_multiplier=2.0, spike_steps=3,
                   start_step=2)


class ChaosInjector:
    """Seeded fault source; one instance drives a whole serving run.

    Each probe draws from the injector's private RNG only when its rate is
    nonzero, and mutates nothing outside the injector — injection *verdicts*
    are applied by the caller (router/engine/server), never here.
    """

    def __init__(self, schedule: Optional[FaultSchedule] = None, seed: int = 0):
        self.schedule = schedule if schedule is not None else FaultSchedule()
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.stats = FaultStats()
        self._step = 0
        self._crashed = 0
        self._straggling: Dict[str, int] = {}   # name -> steps remaining
        self._spike_left = 0                    # arrival-spike steps remaining

    @property
    def idle(self) -> bool:
        return self.schedule.idle

    def bind(self, stats: FaultStats) -> None:
        """Adopt an external ``faults.*`` island (the router's), preserving
        any injections already counted."""
        for f in ("crashes_injected", "straggles_injected",
                  "transfer_faults_injected", "corruptions_injected",
                  "rpc_losses_injected", "spikes_injected"):
            setattr(stats, f, getattr(stats, f) + getattr(self.stats, f))
        self.stats = stats

    # -- step-driven plane (DiffusionServer) ----------------------------------
    def begin_step(self, alive: Sequence[str]) -> Tuple[List[str], List[str]]:
        """Advance one serving step: returns (crash victims, new stragglers).

        ``alive`` is the current replica set; victims respect the kill
        budget and the survivor floor.  Iteration is over the *sorted*
        names so a given seed kills the same replicas regardless of dict
        order.
        """
        s = self.schedule
        self._step += 1
        for name in list(self._straggling):
            self._straggling[name] -= 1
            if self._straggling[name] <= 0:
                del self._straggling[name]
        if self._spike_left > 0:
            self._spike_left -= 1
            if self._spike_left == 0:
                self.stats.spike_active = 0
        if self._step <= s.start_step:
            return [], []
        # Arrival-spike onset (overload plane): rate guard BEFORE the RNG so
        # spike-free schedules draw nothing extra from a pinned seed.
        if (s.spike_rate > 0.0 and self._spike_left == 0
                and self.rng.random() < s.spike_rate):
            self._spike_left = s.spike_steps
            self.stats.spikes_injected += 1
            self.stats.spike_active = 1
        names = sorted(alive)
        victims: List[str] = []
        if s.crash_rate > 0.0 and self._crashed < s.max_crashes:
            for name in names:
                if len(names) - len(victims) <= s.min_survivors:
                    break
                if self._crashed + len(victims) >= s.max_crashes:
                    break
                if self.rng.random() < s.crash_rate:
                    victims.append(name)
            self._crashed += len(victims)
            self.stats.crashes_injected += len(victims)
        fresh: List[str] = []
        if s.straggle_rate > 0.0:
            for name in names:
                if name in self._straggling or name in victims:
                    continue
                if self.rng.random() < s.straggle_rate:
                    self._straggling[name] = s.straggle_steps
                    fresh.append(name)
            self.stats.straggles_injected += len(fresh)
        return victims, fresh

    def arrival_multiplier(self) -> float:
        """Offered-load multiplier for the current step (1.0 = no spike).

        Pure read — the episode state advances in ``begin_step``, so probing
        here any number of times never touches the RNG."""
        if self._spike_left > 0:
            return self.schedule.spike_multiplier
        return 1.0

    def service_factor(self, name: str) -> float:
        """Current service-time multiplier for a replica (1.0 = healthy)."""
        if name in self._straggling:
            return self.schedule.straggle_factor
        return 1.0

    def forget(self, name: str) -> None:
        """Replica left the fleet: clear any active straggle episode."""
        self._straggling.pop(name, None)

    # -- transfer plane (TransferEngine) --------------------------------------
    def transfer_fault(self, obj: str, dest: str, source: str,
                       attempt: int) -> Optional[str]:
        """Per-attempt verdict: None (clean), "flake", or "timeout"."""
        s = self.schedule
        if s.flake_rate <= 0.0 and s.timeout_rate <= 0.0:
            return None
        r = self.rng.random()
        if r < s.timeout_rate:
            self.stats.transfer_faults_injected += 1
            return "timeout"
        if r < s.timeout_rate + s.flake_rate:
            self.stats.transfer_faults_injected += 1
            return "flake"
        return None

    # -- index plane (coherence RPC loss) -------------------------------------
    def rpc_lost(self) -> bool:
        s = self.schedule
        if s.rpc_loss_rate <= 0.0:
            return False
        if self.rng.random() < s.rpc_loss_rate:
            self.stats.rpc_losses_injected += 1
            return True
        return False

    # -- payload plane ---------------------------------------------------------
    def corruption_victim(self, objs: Sequence[str]) -> Optional[str]:
        """Pick a spilled object to bit-flip this step (None = no fault).

        The caller (server step) passes the disk-resident objects and
        applies the flip via ``flip_spill_byte``; selection is over the
        sorted names so the victim is seed-stable.
        """
        s = self.schedule
        if s.corrupt_rate <= 0.0 or not objs or self._step <= s.start_step:
            return None
        if self.rng.random() >= s.corrupt_rate:
            return None
        names = sorted(objs)
        obj = names[self.rng.randrange(len(names))]
        self.stats.corruptions_injected += 1
        return obj

    # -- DES plane (Simulator) -------------------------------------------------
    def draw_sim_crashes(self, n_nodes: int,
                         horizon_s: float) -> List[Tuple[float, int]]:
        """Pre-draw crash events for the DES: ``crash_rate`` is a per-node
        hazard (1/s); each node's death time is an exponential draw, kept
        when it lands inside the horizon (budget + survivor floor apply)."""
        s = self.schedule
        if s.crash_rate <= 0.0 or s.max_crashes <= 0:
            return []
        out: List[Tuple[float, int]] = []
        for idx in range(n_nodes):
            if len(out) >= s.max_crashes or n_nodes - len(out) <= s.min_survivors:
                break
            t = self.rng.expovariate(s.crash_rate)
            if t < horizon_s:
                out.append((t, idx))
        self._crashed += len(out)
        self.stats.crashes_injected += len(out)
        return sorted(out)

    def draw_sim_straggles(self, n_nodes: int, horizon_s: float,
                           ) -> Dict[int, Tuple[float, float]]:
        """Pre-draw straggle windows for the DES: node -> (start, end); the
        slow-down factor is ``schedule.straggle_factor`` throughout."""
        s = self.schedule
        if s.straggle_rate <= 0.0:
            return {}
        out: Dict[int, Tuple[float, float]] = {}
        for idx in range(n_nodes):
            t = self.rng.expovariate(s.straggle_rate)
            if t < horizon_s:
                out[idx] = (t, t + float(s.straggle_steps))
        self.stats.straggles_injected += len(out)
        return out


def flip_spill_byte(backend: Any, obj: str) -> bool:
    """Flip one byte of ``obj``'s first on-disk spill chunk (RealPayload).

    Returns True when a byte was flipped — the next verified read of the
    chunk fails its sha256 check, which is exactly the corruption class the
    recovery path (``corrupt_mode="recover"``) must absorb.  Objects with
    no spilled leaves (not disk-resident, or a non-Real backend) are left
    untouched (False).
    """
    leaves = getattr(backend, "_leaves", {}).get(obj)
    if not leaves:
        return False
    for leaf in leaves:
        chunks = getattr(leaf, "chunks", None)
        if not chunks:
            continue
        path, _digest = chunks[0]
        try:
            with open(path, "r+b") as f:
                first = f.read(1)
                if not first:
                    continue
                f.seek(0)
                f.write(bytes([first[0] ^ 0xFF]))
            return True
        except OSError:
            continue
    return False
