"""End-to-end training driver of the port: ~100M-parameter llama-style
model fed by the diffusion-scheduled data pipeline, with async checkpoints
and a mid-run failure + restart (the reference's ``examples/train_100m.py``).

  python -m repro_torch.examples.train_100m                      # ~100M, 300 steps, on the card
  python -m repro_torch.examples.train_100m --tiny --device cpu  # reduced dims, 60 steps
"""

import argparse
import dataclasses
import tempfile

import numpy as np

from ..configs import get_arch
from ..configs.base import ArchConfig, ShapeConfig
from ..optim import AdamWConfig
from ..runtime import FailureInjector, TrainConfig, Trainer


def model_100m() -> ArchConfig:
    """~100M dense decoder (llama3 family topology)."""
    return dataclasses.replace(
        get_arch("llama3-8b"),
        name="llama3-100m",
        num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
        d_ff=2048, vocab_size=32_000, head_dim=64,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = model_100m().reduced()
        shape = ShapeConfig("train", "train", 128, 4)
        steps = args.steps or 60
    else:
        cfg = model_100m()
        shape = ShapeConfig("train", "train", 256, 4)
        steps = args.steps or 300
    print(f"model: {cfg.param_count() / 1e6:.0f}M params | seq {shape.seq_len} "
          f"batch {shape.global_batch} | {steps} steps | device {args.device}")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            cfg, shape,
            TrainConfig(total_steps=steps, log_every=max(10, steps // 10),
                        checkpoint_every=max(20, steps // 5),
                        checkpoint_dir=ckpt_dir, num_hosts=4,
                        opt=AdamWConfig(lr=1e-3)),
            failure_injector=FailureInjector({steps // 2: ["host3"]}),
            device=args.device,
        )
        res = trainer.run(start_fresh=True)
        print(f"\nloss {np.mean(res.losses[:5]):.3f} -> {np.mean(res.losses[-5:]):.3f} "
              f"| pipeline hit-rate {res.pipeline_hit_rate:.0%} "
              f"| restarts (failure recovery): {res.restarts} "
              f"| wall {res.wall_s:.0f}s")
        assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]), "no learning?"
        print("OK: loss decreased through a worker failure + checkpoint restart.")


if __name__ == "__main__":
    main()
