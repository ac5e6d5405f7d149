"""Share of the window's served requests that found their session's KV
cache on the replica the router chose (``ServeStats.prefix_hits`` over
``ServeStats.served``, the counters' change over the window), in %."""


def read(obs):
    c = obs.counters
    if not c.get("served"):
        return None
    return 100.0 * c["prefix_hits"] / c["served"]
