"""Training driver: the port's ``Trainer`` (its data pipeline and its train
step with AdamW) stepped for the window, timed on the host clock, traced on
request, and its first steps judged against the plain reference.

Set-up makes the weights from the seed (the cell's architecture's
``make_weights``), hands them to the trainer in place of its own draw
(``Trainer.init_state(params=)``, which builds the optimizer state), gives
its pipeline the traffic's shard store (``traffic/<kind>.py``), and runs
the first ``check_steps`` steps through the window's own step: the
pipeline's next batch, its tokens on the card, the train step, the loss
read on the host.  From those it keeps each loss, each leaf's gradient as
the optimizer got it at step 1 (its first moment over 1 - b1), and each
leaf's change after the last of them, read before the next step drops
them.  The window then steps on the same state for ``seconds``, each step's
loss read ``read_lag`` steps after it was sent, on ``host_threads`` CPU
threads (both keys of the traffic file); with ``trace`` its last part runs
under ``torch.profiler``.
After the window, with the program's state freed, the reference runs the
same steps on the same batches from the same weights, with the
architecture's ``train_loss``.
"""

from __future__ import annotations

import gc
import math
import statistics
import tempfile
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional

import torch

from .. import spec as specmod
from .. import weights as wmod
from ..reference import train as rtrain
from ..trace import PROFILE_S, Trace


@dataclass
class Step:
    start: float
    finish: float
    tokens: int
    loss: float
    in_profile: bool = False
    failed: bool = False


@dataclass
class TrainObs:
    """What the metric readers read (``metrics/*.py``): ``reference`` is the
    architecture's module, which counts the operations of ``arch``."""
    arch: Dict[str, Any]
    reference: Any
    on_card: bool
    setup_s: float
    window_s: float
    requests: List[Step]                    # the window's steps
    counters: Dict[str, int]
    batch: int
    seq: int
    trace: Optional[Trace] = None
    profile_start: Optional[float] = None
    window_start: float = 0.0


def _norms(tree) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(x.float())) for p, x in wmod.leaves(tree)}


def relative_gap(prog: Dict[str, float], ref: Dict[str, float], counted) -> float:
    """Worst leaf of |prog - ref| over max(ref's norm of the leaf, the
    median leaf's)."""
    med = statistics.median(ref[p] for p in counted)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in counted)


def run(cell: specmod.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        tamper: Optional[Callable[[Any], None]] = None) -> Dict[str, Any]:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train_loop as tl
    from .serve import arch_config

    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    arch = cfg["arch"]
    B, S = int(traffic["batch"]), int(traffic["seq"])
    sched = {"warmup": min(100, max(1, int(traffic["total_steps"]) // 10)),
             "total": int(traffic["total_steps"])}
    if on_card:
        torch.set_num_threads(int(traffic.get("host_threads", torch.get_num_threads())))
        from repro_torch.kernels import _build
        _build.BUILD_DIR = specmod.ROOT / "build" / "kernels"
    weights = cell.reference.make_weights(arch, seed, device)
    tcfg = tl.TrainConfig(total_steps=sched["total"], seed=int(seed) % (1 << 31),
                          opt=AdamWConfig(**traffic["opt"]),
                          num_hosts=int(traffic["hosts"]), microbatches=1,
                          checkpoint_dir=str(Path(tempfile.gettempdir()) / "portbench_ckpt"))
    trainer = tl.Trainer(arch_config(cfg), ShapeConfig("train", "train", S, B), tcfg,
                         device=str(device))
    trainer.pipeline.store = specmod.traffic_kind(traffic).make(traffic, seed,
                                                                arch["vocab_size"])
    if tamper is not None:
        tamper(trainer)
    params, opt_state = trainer.init_state(params=weights)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batches: List[torch.Tensor] = []

    def dispatch(params, opt_state):
        """One step sent to the card: the pipeline's batch, uploaded from
        pinned memory without a wait, and the train step.  Its loss stays on
        the card until ``read``."""
        t = time.perf_counter()
        tokens, _ = trainer.pipeline.next_batch()
        host_tokens = torch.as_tensor(tokens[:, :S], dtype=torch.long)
        if on_card:
            host_tokens = host_tokens.pin_memory()
        batch = {"tokens": host_tokens.to(device, non_blocking=True)}
        params, opt_state, metrics = trainer.step_fn(params, opt_state, batch)
        return params, opt_state, (t, metrics["loss"].detach()), batch

    def read(pending, in_profile=False) -> Step:
        """The step's loss on the host: the step is done when it is there."""
        t, loss_t = pending
        loss = float(loss_t)
        return Step(t, time.perf_counter(), B * S, loss, in_profile, not math.isfinite(loss))

    # the initial weights are the reference's: off the card before the
    # first step, so that the program alone sets the card's peak
    W = wmod.map_leaves(lambda x: x.cpu(), weights)
    host = dict(wmod.leaves(W))
    del weights
    n_check = int(traffic["check_steps"])
    b1 = float(traffic["opt"]["b1"])
    losses: List[float] = []
    for t in range(n_check):
        params, opt_state, sent, batch = dispatch(params, opt_state)
        s = read(sent)
        batches.append(batch["tokens"].detach().cpu())
        losses.append(s.loss)
        if t == 0:
            first_grads = {p: n / (1 - b1) for p, n in _norms(opt_state["m"]).items()}
    change = {p: float(torch.linalg.vector_norm(x.float() - host[p].to(x.device).float()))
              for p, x in wmod.leaves(params)}
    gc.collect()
    base = dict(trainer.pipeline.stats)

    # the window sends steps ahead of the losses it reads (``read_lag``
    # steps), so that the card stays fed while the host stands still; at
    # its close it sends nothing more and waits for every step it sent
    lag = int(traffic.get("read_lag", 0))
    pending: Deque = deque()
    records: List[Step] = []
    gc.collect()
    gc.freeze()
    gc.disable()
    prof, profile_start = None, None
    prof_s = min(PROFILE_S, seconds / 2)
    sync()
    t0 = time.perf_counter()
    deadline, prof_at = t0 + seconds, t0 + seconds - prof_s
    while time.perf_counter() < deadline:
        if trace and on_card and prof is None and time.perf_counter() >= prof_at:
            # the untraced steps are all read before the profiler starts,
            # so that mfu.train's seconds hold them and nothing more
            while pending:
                records.append(read(*pending.popleft()))
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            profile_start = time.perf_counter()
        params, opt_state, p, _ = dispatch(params, opt_state)
        pending.append((p, prof is not None))
        if len(pending) > lag:
            records.append(read(*pending.popleft()))
    while pending:
        records.append(read(*pending.popleft()))
    sync()
    t_end = time.perf_counter()
    gc.enable()
    gc.unfreeze()
    if prof is not None:
        prof.__exit__(None, None, None)
    st = trainer.pipeline.stats
    counters = {"hits": st["hits"] - base["hits"], "misses": st["misses"] - base["misses"]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    tr = Trace.from_profiler(prof, t_end - profile_start) if prof is not None else None
    del prof
    obs = TrainObs(arch, cell.reference, on_card, t0 - t_start, t_end - t0, records,
                   counters, B, S, tr,
                   None if profile_start is None else profile_start - t0, t0)

    del params, opt_state, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    loss = cell.reference.train_loss
    ref = rtrain.train_steps(loss, W, arch, batches, traffic["opt"], sched, device)
    checks = compare(losses, first_grads, change, ref)
    if control:
        # the control (the reference in float8) and a planted fault (the
        # reference on half of each batch, its mean over the rest), each
        # put in the program's place
        for name, kw, b in (("control_", {"precision": "fp8"}, batches),
                            ("fault_half_batch_", {}, [x[: x.shape[0] // 2] for x in batches])):
            other = rtrain.train_steps(loss, W, arch, b, traffic["opt"], sched, device, **kw)
            checks.update({name + k: v for k, v in compare(
                other["losses"], other["grad_norms"], other["change_norms"], ref).items()
                if k != "compared"})
    notes = {"losses": losses, "reference_losses": ref["losses"]}
    return {"obs": obs, "checks": checks, "peak": peak, "notes": notes}


def compare(losses, grads, change, ref) -> Dict[str, float]:
    """The three numbers: the worst step's loss gap over the reference's
    loss, and the worst leaf's gap of the step-1 gradient norm and of the
    change norm (``relative_gap``).  Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out."""
    med = statistics.median(ref["grad_norms"].values())
    counted = [p for p, g in ref["grad_norms"].items() if g >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": relative_gap(grads, ref["grad_norms"], counted),
            "update_gap": relative_gap(change, ref["change_norms"], counted),
            "compared": len(counted) * 2 + len(losses)}
