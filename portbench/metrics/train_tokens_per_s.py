"""Tokens of all the window's train steps over the window's seconds (host
clock, each step closed by its loss read on the host)."""


def read(obs):
    if obs.window_s <= 0:
        return None
    return sum(s.tokens for s in obs.requests if not s.failed) / obs.window_s
