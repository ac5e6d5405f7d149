"""Model flops utilisation of training, in %: the useful operations of
the steps in the untraced part of the window (the architecture's
``train_step_ops``: 6 a matmul parameter a token and attention forward
and backward, not the recompute), over that part's host seconds times the
card's bf16 peak (989 TFLOP/s at 700 W).  Read in the traced run, before
its profiler starts; nothing off the card."""

from portbench import arith


def read(obs):
    if not obs.on_card or obs.profile_start is None:
        return None
    steps = [s for s in obs.requests if not s.in_profile and not s.failed]
    if not steps:
        return None
    end = max(s.finish for s in steps) - obs.window_start
    ops = len(steps) * obs.reference.train_step_ops(obs.arch, obs.batch, obs.seq)
    return 100.0 * ops / (end * arith.PEAK_FLOPS)
