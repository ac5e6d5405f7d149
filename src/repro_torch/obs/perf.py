"""The paper's evaluation metrics, computed live on the serving path.

The DES already derives the paper's Section-5.2 metrics offline
(``SimResult.performance_index_raw`` / ``speedup_vs`` / per-interval
throughput and utilization series); the live router had none of them.
``PerfMeter`` is the sliding-window reducer that closes the gap: the router
feeds it one event per completion and one sample per tick, and it maintains

  * **per-interval rows** — ``perf.throughput_rps``, ``perf.utilization``,
    ``perf.hit_rate``, ``perf.completed`` per fixed interval (the live
    analogue of the DES's ``TimePoint`` series — same names via
    ``sim_perf_rows``, so sim-vs-live curves overlay directly);
  * **lifetime aggregates** — ``perf.speedup``, ``perf.performance_index``,
    ``perf.resource_hours``, ``perf.utilization``.

Live definitions (documented in ``docs/metrics.md``):

  * ``baseline_service_s`` — mean service time of the requests that got
    *nothing* from the cache plane (all objects missed: the live analogue
    of the paper's first-available baseline, measured in-band).  A caller
    with a calibrated baseline passes it explicitly instead.
  * ``speedup`` — ``baseline_service_s * completed / busy_seconds``: the
    work accomplished, priced in baseline cost, over the replica-busy time
    actually spent.  1.0 when caching contributes nothing, >1 as hits
    replace full-cost service.  (The DES's ``speedup_vs`` divides two
    measured makespans; live serving has no second run, so the baseline is
    priced per-request.)
  * ``performance_index`` — ``speedup / resource_hours`` with
    ``resource_hours`` the integral of registered replicas over time: the
    DES's ``performance_index_raw`` (speedup per CPU-hour), identically
    named and unit-compatible.

``sim_perf_rows`` / ``sim_perf_summary`` project a finished ``SimResult``
into the same dotted namespace, and ``Simulator(obs=...)`` publishes the
live DES sample gauges under it while running.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from .registry import nearest_rank_index  # noqa: F401  (re-export: rank home)

__all__ = ["PerfMeter", "sim_perf_rows", "sim_perf_summary"]


class PerfMeter:
    """Sliding-interval reducer over completion events + utilization samples.

    Time is caller-supplied (virtual or wall, like the router); events may
    arrive with non-decreasing ``now``.  All hot-path methods are O(1).
    """

    def __init__(
        self,
        interval_s: float = 1.0,
        baseline_service_s: Optional[float] = None,
        max_intervals: int = 1024,
    ):
        self.interval_s = float(interval_s)
        self._inv_interval = 1.0 / self.interval_s
        self._fixed_baseline = baseline_service_s
        self.rows: deque = deque(maxlen=max_intervals)   # closed interval rows
        self._interval: Optional[int] = None             # open interval index
        # open-interval accumulators
        self._i_completed = 0
        self._i_hits = 0
        self._i_misses = 0
        self._i_busy_integral = 0.0      # busy-replica-seconds in interval
        self._i_replica_integral = 0.0   # registered-replica-seconds in interval
        # lifetime accumulators
        self.completed = 0
        self.hits = 0
        self.misses = 0
        self.busy_seconds = 0.0          # sum of per-request service time
        self._baseline_sum = 0.0         # all-miss request service times
        self._baseline_n = 0
        # resource integral (from samples)
        self._last_sample_t: Optional[float] = None
        self._last_replicas = 0.0
        self._last_busy = 0.0
        self.replica_seconds = 0.0
        self.busy_replica_seconds = 0.0

    # -- hot path ------------------------------------------------------------
    def on_complete(self, now: float, service_s: float, hits: int, misses: int) -> None:
        """One finished request: ``service_s`` is dispatch->finish time."""
        self._roll(now)
        self._i_completed += 1
        self._i_hits += hits
        self._i_misses += misses
        self.completed += 1
        self.hits += hits
        self.misses += misses
        self.busy_seconds += service_s
        if misses and not hits and self._fixed_baseline is None:
            # A request the cache plane did nothing for: the measured
            # baseline cost of serving without data diffusion.
            self._baseline_sum += service_s
            self._baseline_n += 1

    def on_sample(self, now: float, replicas: float, busy: float) -> None:
        """Pool utilization sample: ``busy`` replicas of ``replicas`` total."""
        self._roll(now)
        last = self._last_sample_t
        if last is not None and now > last:
            dt = now - last
            self.replica_seconds += self._last_replicas * dt
            self.busy_replica_seconds += self._last_busy * dt
            self._i_replica_integral += self._last_replicas * dt
            self._i_busy_integral += self._last_busy * dt
        self._last_sample_t = now
        self._last_replicas = replicas
        self._last_busy = busy

    # -- interval bookkeeping ------------------------------------------------
    def _roll(self, now: float) -> None:
        i = int(now * self._inv_interval)
        if i == self._interval:        # hot path: same open interval
            return
        if self._interval is None:
            self._interval = i
            return
        while self._interval < i:
            self._close_interval()
            self._interval += 1

    def _close_interval(self) -> None:
        util = (self._i_busy_integral / self._i_replica_integral
                if self._i_replica_integral > 0 else 0.0)
        accesses = self._i_hits + self._i_misses
        self.rows.append({
            "t": self._interval * self.interval_s,
            "perf.throughput_rps": self._i_completed / self.interval_s,
            "perf.utilization": util,
            "perf.hit_rate": self._i_hits / accesses if accesses else 0.0,
            "perf.completed": float(self._i_completed),
        })
        self._i_completed = self._i_hits = self._i_misses = 0
        self._i_busy_integral = self._i_replica_integral = 0.0

    # -- derived -------------------------------------------------------------
    @property
    def baseline_service_s(self) -> float:
        if self._fixed_baseline is not None:
            return self._fixed_baseline
        if self._baseline_n:
            return self._baseline_sum / self._baseline_n
        return 0.0

    @property
    def speedup(self) -> float:
        base = self.baseline_service_s
        if base <= 0.0 or self.busy_seconds <= 0.0:
            return 1.0
        return base * self.completed / self.busy_seconds

    @property
    def resource_hours(self) -> float:
        return self.replica_seconds / 3600.0

    @property
    def performance_index(self) -> float:
        rh = self.resource_hours
        return self.speedup / rh if rh > 0 else 0.0

    @property
    def utilization(self) -> float:
        return (self.busy_replica_seconds / self.replica_seconds
                if self.replica_seconds > 0 else 0.0)

    def interval_rows(self) -> List[Dict[str, float]]:
        """Closed per-interval rows, oldest first (bounded window)."""
        return list(self.rows)

    def snapshot(self) -> Dict[str, float]:
        """Registry-source view (lifetime aggregates; prefixed ``perf.``)."""
        elapsed_rows = len(self.rows)
        return {
            "performance_index": self.performance_index,
            "speedup": self.speedup,
            "utilization": self.utilization,
            "resource_hours": self.resource_hours,
            "completed": float(self.completed),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "busy_seconds": self.busy_seconds,
            "baseline_service_s": self.baseline_service_s,
            "baseline_samples": float(self._baseline_n),
            "intervals": float(elapsed_rows),
        }


# -- DES projection (shared names) -------------------------------------------
def sim_perf_rows(result: Any) -> List[Dict[str, float]]:
    """Per-interval rows from a ``SimResult`` series, in the live namespace.

    Key-compatible with ``PerfMeter.interval_rows`` where semantics match
    (``perf.utilization``) and explicitly unit-suffixed where they differ
    (the DES measures byte throughput: ``perf.throughput_gbps``).
    """
    dt = max(1e-9, result.config.sample_dt_s)
    rows = []
    for tp in result.series:
        rows.append({
            "t": tp.t,
            "perf.throughput_gbps": sum(tp.throughput_bytes.values()) * 8 / 1e9 / dt,
            "perf.utilization": tp.cpu_util,
            "perf.queue_len": float(tp.queue_len),
            "perf.nodes": float(tp.nodes),
        })
    return rows


def sim_perf_summary(result: Any, baseline_wet_s: Optional[float] = None) -> Dict[str, float]:
    """Lifetime aggregates from a ``SimResult``, in the live namespace."""
    out = {
        "perf.utilization": result.avg_cpu_util,
        "perf.throughput_gbps": result.avg_throughput_gbps,
        "perf.resource_hours": result.cpu_time_hours,
        "perf.completed": float(result.tasks_done),
        "perf.hit_rate": result.hit_rate_local + result.hit_rate_remote,
    }
    if baseline_wet_s is not None:
        out["perf.speedup"] = result.speedup_vs(baseline_wet_s)
        out["perf.performance_index"] = result.performance_index_raw(baseline_wet_s)
    return out
