"""Training loop of the port: diffusion data pipeline + train step +
checkpoints + heartbeats/straggler watch + failure injection and restart.

A port of the reference's ``runtime/train_loop.py``: the step is
``models.make_train_step`` (a plain function, no ``jit``), state is drawn
on ``device`` (the card unless the caller asks for ``"cpu"``), and
checkpoints go through the port's ``AsyncCheckpointer`` in the reference's
on-disk format, ``{"params", "opt"}`` with ``opt.step`` included.  Under a
mesh (``ctx``) the params are placed by ``tree_shardings``, the optimizer
state by ``opt_state_specs`` and each batch by ``batch_specs``, as DTensors
(every rank draws the same params and batch, then keeps its shards), and a
checkpoint restores under the current mesh.  The
failure-injection and restart logic is the reference's.  The result also
carries each step's grad norm and wall time (host clock after the step's
loss reached the host, which waits for the device).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, latest_checkpoint, restore_checkpoint
from ..configs.base import ArchConfig, ShapeConfig
from ..data.pipeline import DiffusionDataPipeline, PipelineConfig
from ..models import init_opt_state, init_params, make_train_step
from ..launch.shardings import batch_specs, opt_state_specs, with_shardings
from ..models.encdec import text_len
from ..models.sharding import ShardCtx, full, map_specs, tree_param_specs
from ..optim.adamw import AdamWConfig
from .fault_tolerance import FailureInjector, HeartbeatMonitor


@dataclass
class TrainConfig:
    total_steps: int = 200
    log_every: int = 20
    checkpoint_every: int = 50
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    num_hosts: int = 4
    microbatches: int = 1


@dataclass
class TrainResult:
    steps_run: int
    final_loss: float
    losses: List[float]
    restarts: int
    pipeline_hit_rate: float
    wall_s: float
    grad_norms: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        tcfg: TrainConfig,
        pipeline: Optional[DiffusionDataPipeline] = None,
        failure_injector: Optional[FailureInjector] = None,
        device="cuda",
        ctx: ShardCtx = ShardCtx(),
    ):
        self.cfg, self.shape, self.tcfg, self.ctx = cfg, shape, tcfg, ctx
        self.device = torch.device(device)
        self.pipeline = pipeline or DiffusionDataPipeline(
            PipelineConfig(
                vocab_size=cfg.vocab_size,
                seq_len=shape.seq_len,
                global_batch=shape.global_batch,
                seed=tcfg.seed,
            ),
            num_hosts=tcfg.num_hosts,
        )
        self.monitor = HeartbeatMonitor(timeout_s=30.0)
        for i in range(tcfg.num_hosts):
            self.monitor.register(f"host{i}")
        self.injector = failure_injector
        self.ckpt = AsyncCheckpointer(tcfg.checkpoint_dir)
        self.step_fn = make_train_step(cfg, shape, tcfg.opt, tcfg.total_steps,
                                       microbatches=tcfg.microbatches, ctx=ctx)
        self.restarts = 0

    # ------------------------------------------------------------ state
    def _specs(self, params, opt_state):
        return {"params": tree_param_specs(self.ctx, params),
                "opt": opt_state_specs(self.ctx, params, opt_state)}

    def init_state(self, params=None):
        """Params (drawn from the config's seed unless given, as a tree on
        the trainer's device) and their fresh optimizer state, placed under
        the mesh."""
        if params is None:
            params = init_params(self.cfg, device=self.device, seed=self.tcfg.seed)
        opt_state = init_opt_state(params, self.cfg)
        if self.ctx.mesh is None:
            return params, opt_state
        specs = self._specs(params, opt_state)
        return (with_shardings(self.ctx, params, specs["params"]),
                with_shardings(self.ctx, opt_state, specs["opt"]))

    def restore_or_init(self):
        step = latest_checkpoint(self.tcfg.checkpoint_dir)
        params, opt_state = self.init_state()
        if step is None:
            return params, opt_state, 0
        shardings = None
        if self.ctx.mesh is not None:
            shardings = map_specs(self.ctx.named, self._specs(params, opt_state))
        state = restore_checkpoint(
            self.tcfg.checkpoint_dir, step, {"params": params, "opt": opt_state},
            shardings=shardings,
        )
        return state["params"], state["opt"], int(step)

    # ------------------------------------------------------------- batch
    def _batch_for(self, tokens_np: np.ndarray) -> Dict[str, Any]:
        """The reference's batch: tokens, plus zero bf16 ``patch_embeds``
        for a vision config; an encoder-decoder gets zero ``audio_embeds``
        of ``seq_len`` frames and the first ``text_len(seq_len)`` tokens."""
        tokens = torch.as_tensor(tokens_np[:, : self.shape.seq_len],
                                 dtype=torch.long, device=self.device)
        B, S, D = tokens.shape[0], self.shape.seq_len, self.cfg.d_model
        batch: Dict[str, Any] = {"tokens": tokens}
        if self.cfg.frontend == "vision":
            P = min(self.cfg.num_patches, S // 2)
            batch["patch_embeds"] = torch.zeros((B, P, D), dtype=torch.bfloat16,
                                                device=self.device)
        if self.cfg.encoder_layers:
            batch = {"audio_embeds": torch.zeros((B, S, D), dtype=torch.bfloat16,
                                                 device=self.device),
                     "tokens": tokens[:, : text_len(S)]}
        if self.ctx.mesh is None:
            return batch
        return with_shardings(self.ctx, batch,
                              batch_specs(self.ctx, self.cfg, self.shape, batch))

    # --------------------------------------------------------------- run
    def run(self, start_fresh: bool = False) -> TrainResult:
        t0 = time.time()
        if start_fresh:
            params, opt_state = self.init_state()
            step0 = 0
        else:
            params, opt_state, step0 = self.restore_or_init()
        losses: List[float] = []
        grad_norms: List[float] = []
        step_s: List[float] = []
        step = step0
        while step < self.tcfg.total_steps:
            if self.injector is not None:
                for victim in self.injector.maybe_fail(step):
                    # worker failure: drop its cache + capacity, restart from
                    # the latest committed checkpoint (job-level recovery).
                    self.pipeline.remove_host(victim)
                    self.ckpt.wait()
                    self.restarts += 1
                    params, opt_state, step = self.restore_or_init()
            ts = time.time()
            tokens, info = self.pipeline.next_batch()
            batch = self._batch_for(tokens)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(full(metrics["loss"]))
            step_s.append(time.time() - ts)
            losses.append(loss)
            grad_norms.append(float(full(metrics["grad_norm"])))
            self.monitor.heartbeat(info["host"], step_time_s=time.time() - ts)
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, {"params": params, "opt": opt_state})
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"hit_rate {self.pipeline.hit_rate:.2f} "
                      f"stragglers {self.monitor.stragglers()}")
        self.ckpt.wait()
        return TrainResult(
            steps_run=step - step0,
            final_loss=losses[-1] if losses else float("nan"),
            losses=losses,
            restarts=self.restarts,
            pipeline_hit_rate=self.pipeline.hit_rate,
            wall_s=time.time() - t0,
            grad_norms=grad_norms,
            step_s=step_s,
        )
