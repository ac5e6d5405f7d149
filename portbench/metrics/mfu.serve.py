"""Model flops utilisation of serving, in %: the useful operations of the
requests served in the untraced part of the window (each miss's prefill
and every decode step, counted by the architecture's ``prefill_ops`` /
``decode_ops``; the MoE's top-k experts, not its capacity padding), over
that part's host seconds times the card's bf16 peak (989 TFLOP/s at
700 W).  Read in the traced run, before its profiler starts; nothing off
the card."""

from portbench import arith


def read(obs):
    if not obs.on_card or obs.profile_start is None:
        return None
    ops, end = 0, 0.0
    for r in obs.requests:
        if r.in_profile or r.failed:
            continue
        if r.prefill_len:
            ops += obs.reference.prefill_ops(obs.arch, r.prefill_len)
        ops += sum(obs.reference.decode_ops(obs.arch, p) for p in r.positions)
        end = max(end, r.finish - obs.window_start)
    if end <= 0:
        return None
    return 100.0 * ops / (end * arith.PEAK_FLOPS)
