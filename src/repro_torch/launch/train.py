"""Training launcher of the port.

  python -m repro_torch.launch.train --arch internlm2-1.8b --seq 256 --batch 8
  python -m repro_torch.launch.train --arch internlm2-1.8b --reduced --steps 3 --device cpu
  python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --steps 2 --mesh host
  torchrun --nproc-per-node 4 --master-port 29533 -m repro_torch.launch.train --arch ... --mesh host

The reference launcher's flags and defaults, plus ``--device`` (default
``cuda``): the diffusion-scheduled data pipeline, the train step, async
checkpoints and heartbeat/straggler monitoring.  ``--reduced`` swaps in the
architecture's smoke-test dims.  ``--mesh host`` trains sharded over a
("data", "model") mesh of every rank of the process group (``torchrun``'s,
or a world of one this launcher starts: NCCL on the card, gloo on the
CPU): params FSDP x tensor-parallel, batches on 'data', and every MoE layer
through ``moe_ffn_sharded``.  Before the reference's ``done:`` line, a
``train:`` line gives each step's loss, grad norm and wall ms as JSON, with
the device, the mesh's [data, model] sizes and, on CUDA, the peak memory
allocated and the fused AdamW kernels' launches (``adamw_launches``).  With several ranks, rank 0 prints.  Give ``torchrun`` a fixed
``--master-port``: with 0 it hands its workers port 0, which the launcher
refuses.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..kernels.adamw.ops import adamw_fused
from ..models.sharding import ShardCtx
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import TrainConfig, Trainer
from .mesh import init_process_group, make_ctx, make_host_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        epilog="Under torchrun, pass a fixed --master-port (e.g. 29533): "
               "torchrun --master-port 0 hands its workers MASTER_PORT=0, not "
               "the port its store bound, and --mesh host refuses it.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-test dims (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--mesh", default="none", choices=("none", "host"),
                    help="'none' (single device) | 'host' (every rank of the "
                         "process group)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    device = torch.device(args.device)
    started = False
    ctx = ShardCtx()
    if args.mesh == "host":
        started = init_process_group(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        ctx = make_ctx(make_host_mesh())
    try:
        _train(args, cfg, shape, device, ctx)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, shape, device, ctx: ShardCtx) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(
        cfg, shape,
        TrainConfig(total_steps=args.steps, log_every=max(1, args.steps // 10),
                    checkpoint_every=max(10, args.steps // 4),
                    checkpoint_dir=args.ckpt_dir, num_hosts=args.hosts,
                    opt=AdamWConfig(lr=args.lr)),
        device=device, ctx=ctx,
    )
    res = trainer.run()
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    report = {"arch": cfg.name, "device": str(device), "mesh": [ctx.dp, ctx.tp],
              "seq": args.seq, "batch": args.batch, "losses": res.losses,
              "grad_norms": res.grad_norms,
              "step_ms": [s * 1e3 for s in res.step_s]}
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        report["adamw_launches"] = adamw_fused.launches
    print("train: " + json.dumps(report))
    print(f"done: {res.steps_run} steps, final loss {res.final_loss:.4f}, "
          f"pipeline hit-rate {res.pipeline_hit_rate:.0%}, wall {res.wall_s:.0f}s")


if __name__ == "__main__":
    main()
