"""Where a served request's time goes on the card: one prefill and a run of
greedy decode steps of the port's decoder under ``torch.profiler``.

  python -m repro_torch.launch.profile_serve --arch internlm2-1.8b \\
      --prompt 16 --steps 16

Two windows, one prefill (with the decode-cache merge) and ``--steps``
back-to-back greedy decode steps, each run once plain and once under the
profiler and closed by a synchronize.  Prints one JSON line: per window the
host wall ms of the plain run and of the profiled run, the device's kernel
ms and launches in the profiled run, the device busy share (kernel ms over
the plain run's wall; the profiler slows the host, so the share over the
profiled wall is given beside it), and the kernels that take the most
device time.  Needs a CUDA card; random weights from seed 0, the server's
decode-cache length.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_arch
from ..configs.base import ShapeConfig
from ..models import cache_init, init_params, make_decode_step, make_prefill_step
from ..runtime.serve_loop import CACHE_CAP, _merge_prefill_caches


def _device_us(avg) -> float:
    return float(avg.self_device_time_total)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card")
    cfg = get_arch(args.arch)
    dev = torch.device("cuda")
    params = init_params(cfg, device=dev, seed=0)
    prefill = make_prefill_step(cfg, ShapeConfig("serve", "prefill", CACHE_CAP, 1))
    decode = make_decode_step(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, args.prompt)), device=dev)

    def do_prefill():
        logits, pre = prefill(params, {"tokens": tokens})
        caches = _merge_prefill_caches(cache_init(cfg, 1, CACHE_CAP, device=dev),
                                       pre, cfg)
        return torch.argmax(logits, dim=-1), caches

    def do_decode(state):
        tok, caches = state
        for i in range(args.steps):
            logits, caches = decode(params, {"token": tok, "pos": args.prompt + i,
                                             "caches": caches})
            tok = torch.argmax(logits, dim=-1)
        return tok, caches

    def window(fn, *a):
        """fn's host wall ms (closed by a synchronize) without and with the
        profiler; the device's kernel ms and launches in the profiled run,
        its busy share against both walls, and the top kernels."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*a)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            profiled_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [k for k in prof.key_averages() if _device_us(k) > 0
                   and k.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(_device_us(k) for k in kernels) / 1e3
        top = sorted(kernels, key=_device_us, reverse=True)[:8]
        seen = bool(kernels)
        return res, {
            "wall_ms": plain_ms, "profiled_wall_ms": profiled_ms,
            "device_kernel_ms": device_ms if seen else "not measured",
            "device_busy_share": device_ms / plain_ms if seen else "not measured",
            "busy_share_of_profiled_wall":
                device_ms / profiled_ms if seen else "not measured",
            "kernel_launches": sum(int(k.count) for k in kernels),
            "top_kernels": [{"name": k.key[:80], "count": int(k.count),
                             "device_ms": _device_us(k) / 1e3} for k in top]}

    do_decode(do_prefill())                      # warm: cuBLAS, kernel build/load
    state, pre = window(do_prefill)
    _, dec = window(do_decode, state)
    dec["ms_per_step"] = dec["wall_ms"] / args.steps
    if isinstance(dec["device_kernel_ms"], float):
        dec["device_ms_per_step"] = dec["device_kernel_ms"] / args.steps
    dec["launches_per_step"] = dec["kernel_launches"] / args.steps
    print(json.dumps({"device": torch.cuda.get_device_name(0), "arch": cfg.name,
                      "prompt": args.prompt, "steps": args.steps,
                      "prefill": pre, "decode": dec}))


if __name__ == "__main__":
    main()
