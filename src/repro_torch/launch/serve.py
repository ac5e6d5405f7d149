"""Serving launcher of the port: cache-affinity-routed replica pool on torch.

  python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --policy good-cache-compute --requests 64

Same flags and output lines as the reference launcher, plus ``--device``
(default ``cuda``; ``--device cpu --reduced`` runs the plain kernel versions).
With ``--dispatcher vectorized`` the dispatcher's scoring also runs on
``--device`` each drain epoch, and a ``scores:`` line reports it.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_arch
from ..runtime.serve_loop import DiffusionServer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="good-cache-compute",
                    choices=("first-available", "first-cache-available",
                             "max-cache-hit", "max-compute-util",
                             "good-cache-compute"))
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--max-sessions", type=int, default=8,
                    help="per-replica session-slot capacity (transient store)")
    ap.add_argument("--host-cache-sessions", type=int, default=0,
                    help="host-DRAM tier slots: HBM evictions demote there "
                         "and swap back in instead of replaying the prefill")
    ap.add_argument("--eviction", default="lru",
                    choices=("random", "fifo", "lru", "lfu"))
    ap.add_argument("--dispatcher", default="reference",
                    choices=("reference", "vectorized"),
                    help="dispatch engine: pure-Python reference or the "
                         "array-backed vectorized plane (same decisions)")
    ap.add_argument("--batch-drain", action="store_true",
                    help="serving batch plane: decide each submitted burst "
                         "in one single-scan notify_batch drain (deferred "
                         "tier promotions, batched transfer admission)")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="requests submitted per burst before step() when "
                         "--batch-drain is on (1 = per-request, the loop)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--cache-cap", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--metrics-dir", default=None,
                    help="enable the observability plane and write metrics "
                         "snapshots (metrics.json: live perf.performance_"
                         "index / perf.speedup / per-interval utilization "
                         "rows over every stats island), the span trace "
                         "(trace.jsonl), and a Chrome-trace/Perfetto "
                         "document (trace_chrome.json) into this directory")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="with --metrics-dir: also write an interim snapshot "
                         "every N served requests (0 = final only)")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="with --metrics-dir: record batch-level structural "
                         "spans 1-in-N (request-attributed spans are always "
                         "recorded, so attribution is unaffected)")
    ap.add_argument("--slo", default="",
                    help="with --metrics-dir: declare SLOs, e.g. "
                         "'p99_ms=50:hit_rate=0.8:avail=0.999' — tracked "
                         "live (error budget + multi-window burn alerts) "
                         "and reported as slo.* metrics")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded fault injection (robustness plane): replica "
                         "crashes, stragglers, transfer flakes/timeouts, and "
                         "KV-spill corruption at the serving-default mix; "
                         "the run reports faults.* recovery counters")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="multi-tenant admission plane: sessions map onto N "
                         "tenants (t0..tN-1) with credit-based backpressure, "
                         "deadline-aware load shedding and per-tenant tier "
                         "quotas; with --chaos the overload fault mix "
                         "(arrival spikes) replaces the serving default")
    ap.add_argument("--slo-per-tenant", default="",
                    help="with --tenants: per-tenant SLOs feeding the credit "
                         "formula, same grammar as --slo (every tenant gets "
                         "its own board)")
    ap.add_argument("--tenant-quota-frac", type=float, default=0.5,
                    help="with --tenants: per-tenant resident-session quota "
                         "as a fraction of --max-sessions per replica "
                         "(0 disables the tier quota)")
    ap.add_argument("--heartbeat-timeout", type=float, default=None,
                    help="enable the heartbeat liveness plane: lapsed beats "
                         "crash the replica, EWMA stragglers lose dispatch "
                         "ties (seconds; implied 10.0 with --chaos)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the model runs on (cuda = the card "
                         "with the CUDA kernels; cpu = their plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    obs = None
    if args.metrics_dir is not None:
        from ..obs import Observability, parse_slo_specs
        obs = Observability(perf_interval_s=1.0,
                            trace_sample=args.trace_sample,
                            slo_specs=parse_slo_specs(args.slo))
    chaos = None
    heartbeat_timeout = args.heartbeat_timeout
    if args.chaos is not None:
        from ..runtime.chaos import ChaosInjector, FaultSchedule
        # With tenants the overload mix (arrival spikes + light faults)
        # drives the admission plane; single-tenant keeps the pinned
        # serving-default chaos smoke draws untouched.
        schedule = (FaultSchedule.overload_default() if args.tenants > 0
                    else FaultSchedule.serving_default())
        chaos = ChaosInjector(schedule, seed=args.chaos)
        if heartbeat_timeout is None:
            heartbeat_timeout = 10.0
    srv = DiffusionServer(cfg, policy=args.policy, max_replicas=args.replicas,
                          min_replicas=args.min_replicas, cache_cap=args.cache_cap,
                          max_sessions=args.max_sessions,
                          host_cache_sessions=args.host_cache_sessions,
                          eviction=args.eviction,
                          dispatcher_impl=args.dispatcher,
                          batch_drain=args.batch_drain,
                          obs=obs, chaos=chaos,
                          heartbeat_timeout_s=heartbeat_timeout,
                          tenants=args.tenants,
                          slo_per_tenant=args.slo_per_tenant,
                          tenant_quota_frac=args.tenant_quota_frac,
                          device=args.device)
    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, cfg.vocab_size, size=(16,))
               for i in range(args.sessions)}
    sids = list(prompts)
    burst = max(1, args.batch_size) if args.batch_drain else 1
    served = 0
    for i in range(args.requests):
        # Chaos arrival spikes multiply the offered load for the step: the
        # extra submissions are what drive the admission plane into its
        # overload latch (1.0 outside an episode — identical stream).
        for _ in range(max(1, round(srv.arrival_multiplier()))):
            sid = sids[int(rng.integers(0, len(sids)))]
            srv.submit(sid, prompts[sid], max_new_tokens=args.new_tokens)
        if (i + 1) % burst == 0 or i + 1 == args.requests:
            served += srv.step()
            if (obs is not None and args.metrics_every > 0
                    and served // args.metrics_every
                    > (served - burst) // args.metrics_every):
                obs.write_snapshot(args.metrics_dir,
                                   tag=f"r{served:06d}")
    s, r = srv.stats, srv.router.stats
    print(f"served={s.served} prefix_hit={s.hit_rate:.0%} prefills={s.prefills} "
          f"swap_ins={s.swap_ins} decode_steps={s.decode_steps} "
          f"replicas={len(srv.replicas)} scale_ups={r.scale_ups} "
          f"avg_response={s.avg_response_s * 1e3:.1f}ms "
          # window-only percentiles (exact over the latency reservoir's
          # most recent samples, blind to older ones) — labeled as such.
          f"win_p50={r.p50_s * 1e3:.1f}ms win_p99={r.p99_s * 1e3:.1f}ms")
    if srv.score_mirror is not None:
        sc = srv.score_stats
        print(f"scores: epochs={sc.epochs} rows_rescored={sc.rows_rescored} "
              f"rank_k_keys={sc.rank_k_keys} "
              f"mirror_flushes={srv.score_mirror.stats.flushes}")
    if srv.admission is not None:
        adm = srv.admission
        a = adm.snapshot()
        print(f"admission: admits={int(a['admits'])} "
              f"degrades={int(a['degrades'])} sheds={int(a['sheds'])} "
              f"rejects={int(a['rejects'])} "
              f"overload_enters={int(a['overload_enters'])} "
              f"spikes={int(srv.router.faults.spikes_injected)}")
        for name in sorted(adm.tenants):
            st = adm.tenants[name]
            print(f"tenant {name}: offered={st.submitted} served={st.served} "
                  f"shed={st.shed} rejected={st.rejected} "
                  f"credit={st.credit:.2f} share={st.share:.2f} "
                  f"win_p99={st.win_p99_s() * 1e3:.1f}ms "
                  f"hit_rate={st.hit_rate:.0%}")
    if chaos is not None:
        f = srv.router.faults
        lost = len(srv.router._requests) + srv.router.queue_length()
        print(f"chaos: crashed={f.replicas_failed} "
              f"requeued={f.requests_requeued} "
              f"stale_dropped={f.stale_completions_dropped} "
              f"quarantined={f.index_entries_quarantined} "
              f"backfills={f.backfills_requested} "
              f"corruptions_recovered={f.payload_corruptions_recovered} "
              f"lost_requests={lost}")
    if obs is not None:
        paths = obs.write_snapshot(args.metrics_dir)
        m = obs.collect_all()
        print(f"perf_index={m.get('perf.performance_index', 0.0):.3g} "
              f"speedup={m.get('perf.speedup', 0.0):.3f} "
              f"utilization={m.get('perf.utilization', 0.0):.2f} "
              f"spans={int(m.get('trace.recorded', 0))}")
        # Dominant blame segment from the critical-path decomposition.
        fracs = {k.split(".")[2]: v for k, v in m.items()
                 if k.startswith("analyze.crit.") and k.endswith(".frac")}
        if fracs:
            top = max(fracs, key=lambda s: fracs[s])
            print(f"crit_path: top={top} ({fracs[top]:.0%}) "
                  + " ".join(f"{s}={fracs[s]:.2f}"
                             for s in sorted(fracs) if fracs[s] > 0))
        if obs.slo is not None:
            firing = obs.slo.firing()
            parts = []
            for name, tr in sorted(obs.slo.trackers.items()):
                snap = tr.snapshot()
                parts.append(f"{name}: budget={snap['budget_remaining']:.0%} "
                             f"burn={snap['burn_fast']:.2f}/{snap['burn_slow']:.2f}")
            print(f"slo: {'FIRING ' + ','.join(firing) if firing else 'ok'} "
                  + "; ".join(parts))
        print(f"metrics -> {paths['metrics']}")
        print(f"trace   -> {paths['trace_chrome']}")
        print(f"crit    -> {paths['crit_path']}")


if __name__ == "__main__":
    main()
