"""Serving demo of the port: KV-prefix-cache-affinity routing (the paper's
data-aware dispatch applied to LLM serving) vs locality-blind routing (the
reference's ``examples/serve_diffusion.py``).

Sessions issue follow-up requests; a replica that already holds a session's
KV cache decodes immediately (local hit), others replay the prompt (the
"fetch from persistent storage" cost).  Routing goes through the
``CacheAffinityRouter``: each replica is an executor whose transient store
(``core.cache.Cache`` accounting) is published to the centralized index, and
the DRP grows the replica pool with queue length.  Reduced internlm2 on the
card: each prefill runs the flash-attention kernel.

  python -m repro_torch.examples.serve_diffusion                 # on the card
  python -m repro_torch.examples.serve_diffusion --device cpu    # plain versions
"""

import argparse
import time

import numpy as np

from ..configs import get_arch
from ..runtime import DiffusionServer

POLICIES = ("first-available", "max-compute-util", "good-cache-compute")
ROUNDS = 5


def sessions(cfg):
    rng = np.random.default_rng(0)
    return {f"user{i}": rng.integers(0, cfg.vocab_size, size=(24,)) for i in range(8)}


def run(cfg, policy: str, device: str):
    # max_sessions=3 per replica: the 8 sessions do not all fit anywhere —
    # locality-blind routing causes KV-cache thrash (prefill replays).
    srv = DiffusionServer(cfg, policy=policy, max_replicas=4, min_replicas=4,
                          cache_cap=64, max_sessions=3, seed=1, device=device)
    prompts = sessions(cfg)
    order_rng = np.random.default_rng(7)
    t0 = time.time()
    for _ in range(ROUNDS):
        sids = list(prompts)
        order_rng.shuffle(sids)          # arrival order varies per round
        for sid in sids:
            srv.submit(sid, prompts[sid], max_new_tokens=4)
            srv.step()                   # request-at-a-time (online arrival)
    return srv, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_arch("internlm2-1.8b").reduced()
    out = {}
    for policy in POLICIES:
        srv, wall = run(cfg, policy, args.device)
        s, r = srv.stats, srv.router.stats
        print(f"{policy:20s} served={s.served:3d} prefix_hit={s.hit_rate:5.0%} "
              f"prefills={s.prefills:3d} decode_steps={s.decode_steps:3d} "
              f"replicas={len(srv.replicas)} p50={r.p50_s * 1e3:6.1f}ms "
              f"p99={r.p99_s * 1e3:6.1f}ms wall={wall:.1f}s")
        out[policy] = {"served": s.served, "prefix_hit": s.hit_rate,
                       "prefills": s.prefills, "decode_steps": s.decode_steps,
                       "replicas": len(srv.replicas), "wall_s": wall}
        del srv

    print("\nprefix-affinity routing turns session follow-ups into cache hits —")
    print("the paper's max-cache-hit/good-cache-compute policies, 18 years later.")
    return out


if __name__ == "__main__":
    main()
