"""Output tokens of the window's requests that completed correctly, over
the window's seconds (host clock, from the window's start to the
synchronize that closed its last step)."""


def read(obs):
    if obs.window_s <= 0:
        return None
    return sum(r.tokens for r in obs.requests if not r.failed) / obs.window_s
