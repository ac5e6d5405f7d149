"""Elastic scaling + failover in the port: the DRP grows the worker pool
under backlog, shrinks it when idle, and the heartbeat monitor + checkpoint
restart handle a worker loss — the paper's dynamic-resource-provisioning
loop around a real training job (the reference's
``examples/elastic_failover.py``).  Reduced gemma3-1b trains through the
port's ``Trainer`` on the card; the controller, monitor and recovery are
the port's verbatim copies.

  python -m repro_torch.examples.elastic_failover                 # on the card
  python -m repro_torch.examples.elastic_failover --device cpu
"""

import argparse
import tempfile

from ..checkpoint import latest_checkpoint
from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..core import DynamicResourceProvisioner, ModelInputs
from ..runtime import ElasticController, TrainConfig, Trainer
from ..runtime.fault_tolerance import HeartbeatMonitor, recover


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_arch("gemma3-1b").reduced()
    shape = ShapeConfig("t", "train", 64, 4)
    out = {}

    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainConfig(total_steps=40, log_every=20, checkpoint_every=10,
                           checkpoint_dir=d, num_hosts=2)
        trainer = Trainer(cfg, shape, tcfg, device=args.device)

        drp = DynamicResourceProvisioner(max_nodes=6, min_nodes=1,
                                         allocation_latency_s=(0, 0),
                                         policy="watermark", tasks_per_node_target=4)
        drp.registered = 2

        events = []

        def rebuild(n_hosts: int) -> None:
            cur = trainer.pipeline.num_hosts()
            for i in range(cur, n_hosts):
                trainer.pipeline.add_host(f"host{i}")
            events.append(n_hosts)

        ctl = ElasticController(drp, checkpoint_fn=lambda: None, restore_fn=rebuild,
                                min_hosts=1, cooldown_s=0.0)

        # Phase 1: backlog spike -> scale up (paper: wait-queue-triggered DRP)
        ev = ctl.maybe_scale(backlog=20, current=2)
        print(f"scale-up event: {ev.from_hosts} -> {ev.to_hosts} hosts ({ev.reason})")
        out["scale_up"] = (ev.from_hosts, ev.to_hosts, ev.reason)

        # Abstract-model-guided sizing (Section 4.3 optimizer)
        m = ModelInputs(num_tasks=10_000, arrival_rate=50.0, avg_compute_s=0.05,
                        dispatch_overhead_s=0.005, num_executors=4,
                        object_size_bytes=1 << 20, hit_rate_local=0.8,
                        hit_rate_remote=0.1, local_bw=2e8, remote_bw=1.25e8,
                        persistent_bw=5e7)
        out["sizing"] = ctl.plan_with_model(m)
        print(f"model-guided sizing: |T| = {out['sizing']} executors")

        # Phase 2: train through a failure, recover from checkpoint
        res = trainer.run(start_fresh=True)
        mon = HeartbeatMonitor(timeout_s=0.5)
        mon.register("host1", now=0.0)
        lost = mon.check(now=10.0)
        act = recover(mon, trainer.pipeline.sched, drp,
                      latest_ckpt_step=latest_checkpoint(d), lost=lost, now=10.0)
        print(f"failure recovery: lost={act.lost_workers} "
              f"restart_from={act.restart_from_step} "
              f"drp_backfill={act.provision_requested} node(s)")
        out["recovery"] = (list(act.lost_workers), act.restart_from_step,
                           act.provision_requested)

        # Phase 3: idle -> scale down
        ev = ctl.maybe_scale(backlog=0, current=trainer.pipeline.num_hosts())
        out["scale_down"] = None
        if ev:
            print(f"scale-down event: {ev.from_hosts} -> {ev.to_hosts} ({ev.reason})")
            out["scale_down"] = (ev.from_hosts, ev.to_hosts, ev.reason)
        print(f"\ntrained {res.steps_run} steps, final loss {res.final_loss:.3f}; "
              f"elastic events: {events}")
    out.update(events=events, steps_run=res.steps_run, losses=list(res.losses),
               final_loss=res.final_loss)
    return out


if __name__ == "__main__":
    main()
