"""Host time of MoE routing, in ms a request: the host time inside the
program's ``moe.route`` spans (a MoE layer's router, top-k, counts and
ranks) in the traced part of a serving window, over the requests served in
that part.  A dropless prefill reads its fullest expert's count after the
span, in ``moe.fill``, and in a traced run waits for its queued device
work before the span, so no read to the host and no stall on a full
launch queue lies inside: the reading is the host's cost of issuing the
routing.  Nothing off the card, without a trace, or from a program that
opens no such span."""

from portbench import spans


def read(obs):
    if not obs.on_card or obs.trace is None:
        return None
    served = sum(1 for r in obs.requests if r.in_profile and not r.failed)
    iv = spans.intervals(obs.trace, ("moe.route",))
    if not iv or not served:
        return None
    return sum(b - a for v in iv.values() for a, b in v) / 1e3 / served
