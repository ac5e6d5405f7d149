"""Share of the traced part of a serving window in which no kernel, copy
or memset ran on the card, in %: 1 - the union of the device intervals
of the profiler's trace over the traced span (host clock)."""


def read(obs):
    if not obs.on_card or obs.trace is None or obs.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s() / obs.trace.span_s)
