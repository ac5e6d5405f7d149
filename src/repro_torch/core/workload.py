"""Workload generators (paper Sections 5.1/5.2 and Fig 2 locality sweeps).

The provisioning workload (Section 5.2): 10K files x 10MB; each task reads one
file chosen uniformly at random and computes for 10ms; arrival ramp

    A_i = min(ceil(A_{i-1} * 1.3), 1000),  A_0 = 1,  0 <= i < 24,

60 s per interval, 250K tasks total, spanning 1415 s of submissions (the
paper's ideal workload execution time).

The scheduler microbenchmark workload (Section 5.1): 250K tasks over 10K
1-byte files, uniform random.

The astronomy-style locality workloads (Fig 2): data locality ell means each
file is accessed by ell tasks (ell = 1, 1.38, 30 in the paper).
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from .store import DataObject
from .task import Task


@dataclass
class Workload:
    name: str
    objects: List[DataObject]
    tasks: List[Task]
    interval_rates: List[float]
    interval_duration_s: float

    @property
    def working_set_bytes(self) -> float:
        return sum(o.size_bytes for o in self.objects)

    @property
    def ideal_span_s(self) -> float:
        """Time to submit all tasks at the ramp rates = ideal WET (infinite
        resources, zero overhead — paper: 1415 s for the 5.2 workload)."""
        remaining = len(self.tasks)
        t = 0.0
        for rate in self.interval_rates:
            per = rate * self.interval_duration_s
            if per >= remaining:
                t += remaining / rate
                return t
            remaining -= per
            t += self.interval_duration_s
        if remaining > 0 and self.interval_rates:
            t += remaining / self.interval_rates[-1]
        return t


def paper_ramp_rates(
    a0: float = 1.0, factor: float = 1.3, cap: float = 1000.0, intervals: int = 24
) -> List[float]:
    """A_i = min(ceil(A_{i-1} * 1.3), 1000) for 24 intervals (Section 5.2)."""
    rates, a = [], a0
    for _ in range(intervals):
        rates.append(a)
        a = min(math.ceil(a * factor), cap)
    return rates


def _arrival_times(num_tasks: int, rates: List[float], interval_s: float) -> List[float]:
    """Deterministic evenly-spaced arrivals within each rate interval."""
    times: List[float] = []
    t0 = 0.0
    for rate in rates:
        n = int(round(rate * interval_s))
        for j in range(n):
            if len(times) >= num_tasks:
                return times
            times.append(t0 + j / rate)
        t0 += interval_s
    # Tail: continue at the final rate until all tasks are submitted.
    rate = rates[-1] if rates else 1.0
    while len(times) < num_tasks:
        times.append(t0)
        t0 += 1.0 / rate
    return times


def provisioning_workload(
    num_tasks: int = 250_000,
    num_files: int = 10_000,
    file_size_bytes: float = 10 * 1024 * 1024,
    compute_time_s: float = 0.010,
    seed: int = 42,
    rates: Optional[List[float]] = None,
    interval_duration_s: float = 60.0,
) -> Workload:
    """The Section 5.2 data-intensive workload (I/O:compute = 10MB:10ms)."""
    rng = _random.Random(seed)
    objects = [DataObject(f"f{i:06d}", file_size_bytes) for i in range(num_files)]
    rates = rates if rates is not None else paper_ramp_rates()
    times = _arrival_times(num_tasks, rates, interval_duration_s)
    tasks = [
        Task(
            task_id=i,
            files=(objects[rng.randrange(num_files)].name,),
            compute_time_s=compute_time_s,
            submit_time_s=times[i],
        )
        for i in range(num_tasks)
    ]
    return Workload("provisioning-5.2", objects, tasks, list(rates), interval_duration_s)


def scheduler_microbench_workload(
    num_tasks: int = 250_000, num_files: int = 10_000, seed: int = 7
) -> Workload:
    """Section 5.1: 1-byte files isolate scheduling cost from I/O."""
    wl = provisioning_workload(
        num_tasks=num_tasks,
        num_files=num_files,
        file_size_bytes=1.0,
        compute_time_s=0.0,
        seed=seed,
    )
    wl.name = "scheduler-5.1"
    return wl


def locality_workload(
    locality: float,
    num_tasks: int,
    file_size_bytes: float = 2 * 1024 * 1024,
    compute_time_s: float = 0.1,
    arrival_rate: float = 100.0,
    seed: int = 3,
) -> Workload:
    """Fig-2-style workload: each file accessed ~``locality`` times.

    locality=1: 1-1 task/file mapping (working set == total I/O);
    locality=30: each file feeds 30 tasks (high reuse).
    """
    rng = _random.Random(seed)
    num_files = max(1, int(round(num_tasks / locality)))
    objects = [DataObject(f"l{i:06d}", file_size_bytes) for i in range(num_files)]
    # Exactly ceil(locality) tasks per file in expectation, shuffled order.
    assignments = [i % num_files for i in range(num_tasks)]
    rng.shuffle(assignments)
    tasks = [
        Task(
            task_id=i,
            files=(objects[assignments[i]].name,),
            compute_time_s=compute_time_s,
            submit_time_s=i / arrival_rate,
        )
        for i in range(num_tasks)
    ]
    return Workload(
        f"locality-{locality}", objects, tasks, [arrival_rate], num_tasks / arrival_rate
    )
