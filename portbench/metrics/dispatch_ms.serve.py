"""Host time of routing and dispatch, in ms a request: the host time inside
the program's ``serve.route`` spans (each call the server makes into its
router) and ``serve.score`` spans (the dispatcher's device scoring and its
exactness check) in the traced part of a serving window, over the requests
served in that part.  The server opens ``serve.score`` once the model's
queued device work is done, so the reading holds the scoring's own
uploads, kernels and read-back, and no wait for the model.  Nothing off
the card, without a trace, or from a program that opens no such span."""

from portbench import spans


def read(obs):
    if not obs.on_card or obs.trace is None:
        return None
    served = sum(1 for r in obs.requests if r.in_profile and not r.failed)
    iv = spans.intervals(obs.trace, ("serve.route", "serve.score"))
    if not iv or not served:
        return None
    return sum(b - a for v in iv.values() for a, b in v) / 1e3 / served
