"""Named workload presets from the paper (Section 5) and the scale study.

Usage:  from repro.configs.paper_workloads import WORKLOADS
        wl = WORKLOADS["provisioning-5.2"]()
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.workload import (
    Workload,
    locality_workload,
    provisioning_workload,
    scheduler_microbench_workload,
)

GB = 1024 ** 3
MB = 1024 ** 2


def _astro_locality(locality: float, num_tasks: int = 20_000) -> Workload:
    """Fig-2 astronomy-style workload: 2MB objects, ~100ms analysis tasks."""
    return locality_workload(locality, num_tasks, file_size_bytes=2 * MB,
                             compute_time_s=0.1, arrival_rate=200.0)


WORKLOADS: Dict[str, Callable[[], Workload]] = {
    # Section 5.2: 250K tasks, 10K x 10MB files, ramp 1 -> 1000 tasks/s.
    "provisioning-5.2": lambda: provisioning_workload(num_tasks=250_000),
    "provisioning-5.2-small": lambda: provisioning_workload(num_tasks=25_000),
    # Section 5.1: 1-byte files isolate scheduler cost.
    "scheduler-5.1": lambda: scheduler_microbench_workload(),
    # Fig 2 locality sweep points.
    "astro-locality-1": lambda: _astro_locality(1.0),
    "astro-locality-1.38": lambda: _astro_locality(1.38),
    "astro-locality-30": lambda: _astro_locality(30.0),
    # Beyond paper: TPU-cluster shard-processing (bench_scale.py geometry).
    "tpu-shards": lambda: provisioning_workload(
        num_tasks=40_000, num_files=2_000, file_size_bytes=256 * MB,
        compute_time_s=0.5, rates=[10, 50, 100, 250, 500, 1000, 1500, 2000],
        interval_duration_s=5.0),
}
