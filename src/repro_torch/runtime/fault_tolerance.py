"""Fault tolerance: heartbeats, failure injection, replay, elastic restart.

The executor-state machine is shared with the DES (``core``); here it is
driven by wall-clock heartbeats.  The recovery ladder mirrors the paper's
replay policy upward:

  task level    — timed-out / failed tasks re-dispatch (replay policy);
  worker level  — missed heartbeats mark the worker LOST, its cache entries
                  drop from the index, the DRP back-fills capacity;
  job level     — the train loop restarts from the latest committed
                  checkpoint onto the surviving mesh (elastic restore).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..core.provisioner import DynamicResourceProvisioner
from ..core.scheduler import DataAwareScheduler


@dataclass
class WorkerHealth:
    name: str
    last_heartbeat: float
    step_times: List[float] = field(default_factory=list)
    lost: bool = False

    def ewma_step_time(self, alpha: float = 0.3) -> float:
        if not self.step_times:
            return 0.0
        v = self.step_times[0]
        for t in self.step_times[1:]:
            v = alpha * t + (1 - alpha) * v
        return v


class HeartbeatMonitor:
    """Tracks worker liveness + straggler status from reported step times."""

    def __init__(self, timeout_s: float = 5.0, straggler_factor: float = 2.0):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.workers: Dict[str, WorkerHealth] = {}
        self._lock = threading.Lock()

    def register(self, name: str, now: Optional[float] = None) -> None:
        with self._lock:
            self.workers[name] = WorkerHealth(name, now if now is not None else time.time())

    def heartbeat(self, name: str, step_time_s: Optional[float] = None,
                  now: Optional[float] = None) -> None:
        with self._lock:
            w = self.workers.get(name)
            if w is None:
                return
            w.last_heartbeat = now if now is not None else time.time()
            if step_time_s is not None:
                w.step_times.append(step_time_s)
                if len(w.step_times) > 64:
                    w.step_times.pop(0)

    def check(self, now: Optional[float] = None) -> List[str]:
        """Returns newly-lost worker names (missed heartbeat)."""
        now = now if now is not None else time.time()
        lost = []
        with self._lock:
            for w in self.workers.values():
                if not w.lost and now - w.last_heartbeat > self.timeout_s:
                    w.lost = True
                    lost.append(w.name)
        return lost

    def stragglers(self) -> List[str]:
        """Workers whose EWMA step time exceeds factor x median."""
        with self._lock:
            times = {n: w.ewma_step_time() for n, w in self.workers.items()
                     if not w.lost and w.step_times}
        if len(times) < 2:
            return []
        med = sorted(times.values())[len(times) // 2]
        if med <= 0:
            return []
        return [n for n, t in times.items() if t > self.straggler_factor * med]

    def forget(self, name: str) -> None:
        """Worker left the fleet (crash or scale-down): stop tracking it so
        its stale EWMA cannot skew the straggler median and a re-registered
        namesake starts with a clean window."""
        with self._lock:
            self.workers.pop(name, None)

    def alive(self) -> List[str]:
        with self._lock:
            return [n for n, w in self.workers.items() if not w.lost]


class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    def __init__(self, schedule: Dict[int, List[str]]):
        self.schedule = dict(schedule)  # step -> worker names to kill

    def maybe_fail(self, step: int) -> List[str]:
        return self.schedule.pop(step, [])


@dataclass
class RecoveryActions:
    lost_workers: List[str]
    redispatch_tasks: int
    restart_from_step: Optional[int]
    provision_requested: int


def recover(
    monitor: HeartbeatMonitor,
    scheduler: Optional[DataAwareScheduler],
    provisioner: Optional[DynamicResourceProvisioner],
    *,
    latest_ckpt_step: Optional[int],
    lost: List[str],
    now: float = 0.0,
) -> RecoveryActions:
    """The worker-level recovery ladder (pure function for testability)."""
    redispatched = 0
    requested = 0
    for name in lost:
        if scheduler is not None:
            scheduler.deregister_executor(name)
    if provisioner is not None and lost:
        provisioner.registered = max(0, provisioner.registered - len(lost))
        req = provisioner.request(len(lost), now)  # 1:1 back-fill
        requested = req.nodes if req else 0
    return RecoveryActions(
        lost_workers=lost,
        redispatch_tasks=redispatched,
        restart_from_step=latest_ckpt_step if lost else None,
        provision_requested=requested,
    )
