"""The fullest expert's share of a dropless MoE group's tokens, in %: the
mean, over the groups whose fullest count the program read to the host
inside the serving window, of that count over the group's tokens (the
program's record ``repro_torch.models.moe.FILL_READS``, each entry on the
host clock the window is timed on).  A token reaches an expert at most
once, so routing spread evenly over E experts at top-k reads about 100 k
/ E; more is routing skewed onto one expert, which sets the capacity that
every expert's GEMM is padded to.  Nothing from a window without such a
read, or from a program that keeps no such record."""


def read(obs):
    from repro_torch.models import moe
    t0, t1 = obs.window_start, obs.window_start + obs.window_s
    reads = [(n, t) for at, n, t in getattr(moe, "FILL_READS", ()) if t0 <= at <= t1]
    if not reads:
        return None
    return 100.0 * sum(n / t for n, t in reads) / len(reads)
