"""Quickstart of the port: data diffusion in 60 lines (the reference's
``examples/quickstart.py``).

Runs the paper's Section-5.2 workload (scaled down) through the DES under
first-available (no caching; GPFS-only) vs good-cache-compute (data
diffusion), then cross-checks the abstract model's prediction (Section 4).
The DES is the port's verbatim copy of the reference's ``core``: no device,
and the same lines as the reference prints.

  python -m repro_torch.examples.quickstart
"""

import argparse

from ..core import (
    ModelInputs,
    SimConfig,
    provisioning_workload,
    run_experiment,
    teragrid_profile,
    workload_execution_time_with_overheads,
)

GB = 1024 ** 3


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

    # 1. The workload: tasks read 10MB files (10ms compute), arrivals ramp 1->1000/s.
    wl = provisioning_workload(num_tasks=25_000)
    print(f"workload: {len(wl.tasks)} tasks, {len(wl.objects)} x 10MB files, "
          f"ideal span {wl.ideal_span_s:.0f}s")

    # 2. Baseline: no data diffusion (every access hits the shared file system).
    fa = run_experiment(wl, SimConfig(policy="first-available", max_nodes=64))
    print(f"\nfirst-available (GPFS only): WET={fa.wet_s:.0f}s "
          f"eff={fa.efficiency:.2f} resp={fa.avg_response_s:.1f}s "
          f"cpu={fa.cpu_time_hours:.0f}h")

    # 3. Data diffusion: dynamic provisioning + caching + data-aware scheduling.
    dd = run_experiment(wl, SimConfig(policy="good-cache-compute",
                                      cache_size_per_node_bytes=4 * GB, max_nodes=64))
    print(f"good-cache-compute (diffusion): WET={dd.wet_s:.0f}s "
          f"eff={dd.efficiency:.2f} hit={dd.hit_rate_local:.0%} "
          f"resp={dd.avg_response_s:.1f}s cpu={dd.cpu_time_hours:.0f}h")
    pi_gain = (dd.performance_index_raw(fa.wet_s)
               / max(fa.performance_index_raw(fa.wet_s), 1e-12))
    print(f"speedup {dd.speedup_vs(fa.wet_s):.2f}x | response-time gain "
          f"{fa.avg_response_s / max(dd.avg_response_s, 1e-9):.0f}x | "
          f"PI gain {pi_gain:.0f}x")

    # 4. The abstract model (paper Section 4) predicts the diffusion run:
    hw = teragrid_profile()
    m = ModelInputs(
        num_tasks=len(wl.tasks),
        arrival_rate=len(wl.tasks) / wl.ideal_span_s,
        avg_compute_s=0.010,
        dispatch_overhead_s=hw.decision_cost_s["good-cache-compute"]
        + 2 * hw.dispatch_latency_s + hw.delivery_time_s,
        num_executors=64 * hw.executors_per_node,
        object_size_bytes=wl.objects[0].size_bytes,
        hit_rate_local=dd.hit_rate_local,
        hit_rate_remote=dd.hit_rate_remote,
        local_bw=hw.disk_bw_bytes / hw.executors_per_node,
        remote_bw=hw.nic_bw_bytes,
        persistent_bw=hw.persistent_bw_bytes / 32,
    )
    pred = workload_execution_time_with_overheads(m)
    print(f"\nabstract model: predicted WET={pred:.0f}s, measured {dd.wet_s:.0f}s "
          f"(error {abs(pred - dd.wet_s) / dd.wet_s:.0%})")
    return {"first-available": fa, "good-cache-compute": dd, "predicted_wet_s": pred}


if __name__ == "__main__":
    main()
