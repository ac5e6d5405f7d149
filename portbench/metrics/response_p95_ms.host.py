"""``response_p95_ms`` as a per-layer metric of the serving loop, for a cell
whose card is idle most of the window: there the tail follows the host's
pace and spreads too widely from run to run for an end-to-end bound.  Read
in the traced run over the requests served before its profiler started,
since the profiler slows the host's dispatch."""

from portbench import spec

_p95_ms = spec.metric_reader("response_p95_ms").p95_ms


def read(obs):
    return _p95_ms([r for r in obs.requests if not r.in_profile])
