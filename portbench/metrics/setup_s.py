"""Set-up seconds: from the process's start to the window's start, the
weights, the kernel build or load, and the warm-up included (host clock)."""


def read(obs):
    return obs.setup_s
