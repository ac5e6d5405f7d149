#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel in src/repro_torch/csrc, in parallel;
  3. parity  - each kernel against its plain PyTorch version on the card:
               flash attention (bf16, rel. err < 2e-2) and the two dispatch
               scoring kernels (max |out - float64| == 0.0);
  4. model   - the reduced internlm2 and gemma3 decoders, prefill and eight
               decode steps on the card against the same weights on the CPU
               (plain versions): logits rel. err < 2e-2, equal greedy tokens;
  5. serve   - internlm2-1.8b at full published width (random weights from a
               seed) served through DiffusionServer with the vectorized
               dispatcher and the batch drain, which puts the dispatcher's
               scoring on the card (the bulk rescore and the score mirror):
               the launcher's stream (seed 0, 8 sessions, 16-token prompts,
               32 requests, 8 new tokens, bursts of 8).  Kernel launch
               counters are zeroed just before and read just after;
  6. timing  - each kernel at the main path's shapes: CUDA-event times of
               the kernel, its plain version and one library call, beside
               the card's bound (bytes over 3.35 TB/s or operations over the
               type's peak, whichever is larger).
The line before the last is a JSON object with the per-kernel numbers; the
last line is the device record.  Exits non-zero without CUDA, and when the
repository's ``src/repro_torch`` is not next to this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; fp32 SIMT

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:87",
    "dispatch_scores": "src/repro/kernels/dispatch_score/dispatch_score.py:111",
    "dispatch_score_update": "src/repro/kernels/dispatch_score/dispatch_score.py:74",
}
SOURCES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "dispatch_scores": "src/repro_torch/csrc/dispatch_score.cu",
    "dispatch_score_update": "src/repro_torch/csrc/dispatch_score.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


# ------------------------------------------------------------- flash attention
def attn_inputs(B, Sq, Skv, H, Hkv, D, dtype, seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    return q, k, v


def attn_cost(B, Sq, Skv, H, Hkv, D, causal, window, elem):
    """(bytes, operations) the function needs: q, k, v read once, o written
    once; 4*D operations per unmasked (query, key) pair."""
    import torch
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    pairs = int(ok.sum())
    nbytes = elem * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)
    return nbytes, 4.0 * D * pairs * B * H


def sdpa_call(q, k, v, causal, window):
    """One library call computing the same function (timed only)."""
    import torch
    import torch.nn.functional as F
    Sq, Skv = q.shape[1], k.shape[1]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = {}
    if q.shape[2] != k.shape[2]:
        kw["enable_gqa"] = True
    if causal and not window and Sq == Skv:
        kw["is_causal"] = True
    else:
        qpos = torch.arange(Sq, device="cuda")[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device="cuda")[None, :]
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        kw["attn_mask"] = ok
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def flash_case(shape, causal=True, window=0, dtype_name="bf16", seed=0,
               timed=False):
    import torch
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    B, Sq, Skv, H, Hkv, D = shape
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    q, k, v = attn_inputs(B, Sq, Skv, H, Hkv, D, dtype, seed)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err = rel_err(out, ref)
    tol = 2e-2 if dtype_name == "bf16" else 2e-5
    row = {"shape": list(shape), "causal": causal, "window": window,
           "dtype": dtype_name, "rel_err": err,
           "max_abs_err": float((out.float() - ref.float()).abs().max())}
    if not err < tol:
        fail(f"flash_attention {row} exceeds {tol}")
    if timed:
        lib = sdpa_call(q, k, v, causal, window)
        lib_err = rel_err(lib().transpose(1, 2), ref)
        row["ms"] = cuda_ms(lambda: flash_attention(q, k, v, causal=causal,
                                                    window=window))
        row["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                        window=window))
        row["library_ms"] = cuda_ms(lib)
        row["library_rel_err"] = lib_err
        nbytes, ops = attn_cost(B, Sq, Skv, H, Hkv, D, causal, window,
                                q.element_size())
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, dtype_name)
    return row


# ------------------------------------------------------------ dispatch scoring
def score_inputs(W, O, E, density, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    demand = (rng.random((W, O)) < density).astype(np.float32)
    presence = (rng.random((E, O)) < 0.3).astype(np.float32)
    presence *= rng.choice([1.0, 0.5, 0.25], size=(E, O)).astype(np.float32)
    return demand, presence


def update_inputs(W, K, E, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, 8, (W, E))
              * rng.choice([1.0, 0.5, 0.25], size=(W, E))).astype(np.float32)
    mult = rng.integers(0, 3, (W, K)).astype(np.float32)
    delta = np.zeros((K, E), dtype=np.float32)
    delta[np.arange(K), rng.integers(0, E, K)] = rng.choice(
        [1.0, 0.5, 0.25, -0.5, -1.0], size=K)
    return scores, mult, delta


def scores_case(W, O, E, density=0.2, seed=42, timed=False):
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch_score.ops import dispatch_scores, dispatch_scores_ref
    demand, presence = score_inputs(W, O, E, density, seed)
    d, p = torch.from_numpy(demand).cuda(), torch.from_numpy(presence).cuda()
    out = dispatch_scores(d, p)
    exact = demand.astype(np.float64) @ presence.astype(np.float64).T
    err = float(np.abs(out.cpu().numpy().astype(np.float64) - exact).max(initial=0.0))
    plain = dispatch_scores_ref(d, p)
    err_plain = float((out - plain).abs().max()) if out.numel() else 0.0
    row = {"W": W, "O": O, "E": E, "max_abs_err": err,
           "max_abs_err_plain": err_plain}
    if err != 0.0 or err_plain != 0.0:
        fail(f"dispatch_scores not exact: {row}")
    if timed:
        row["ms"] = cuda_ms(lambda: dispatch_scores(d, p))
        row["plain_ms"] = cuda_ms(lambda: dispatch_scores_ref(d, p))
        pt = p.T
        row["library_ms"] = cuda_ms(lambda: torch.matmul(d, pt))
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * (W * O + E * O + W * E), 2.0 * W * E * O, "f32")
    return row


def update_case(W, K, E, seed=7, timed=False):
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch_score.ops import (dispatch_score_update,
                                                        dispatch_score_update_ref)
    scores, mult, delta = update_inputs(W, K, E, seed)
    s, m, dl = (torch.from_numpy(x).cuda() for x in (scores, mult, delta))
    out = dispatch_score_update(s, m, dl)
    exact = scores.astype(np.float64) + mult.astype(np.float64) @ delta
    err = float(np.abs(out.cpu().numpy().astype(np.float64) - exact).max(initial=0.0))
    err_plain = float((out - dispatch_score_update_ref(s, m, dl)).abs().max())
    row = {"W": W, "K": K, "E": E, "max_abs_err": err,
           "max_abs_err_plain": err_plain}
    if err != 0.0 or err_plain != 0.0:
        fail(f"dispatch_score_update not exact: {row}")
    if timed:
        row["ms"] = cuda_ms(lambda: dispatch_score_update(s, m, dl))
        row["plain_ms"] = cuda_ms(lambda: dispatch_score_update_ref(s, m, dl))
        row["library_ms"] = cuda_ms(lambda: torch.addmm(s, m, dl))
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * (2 * W * E + W * K + K * E), 2.0 * W * K * E, "f32")
    return row


# ----------------------------------------------------------------- model check
def model_check(arch: str, prompt_len: int):
    """Reduced decoder on the card vs the same weights on the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import cache_init, init_params
    from repro_torch.models.lm import lm_decode, lm_prefill
    from repro_torch.runtime.serve_loop import _merge_prefill_caches
    cfg = get_arch(arch).reduced()
    cpu = init_params(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 1)))
    worst = 0.0
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        logits, pre = lm_prefill(params, {"tokens": tokens.to(dev)}, cfg)
        caches = _merge_prefill_caches(cache_init(cfg, 1, 64, device=dev), pre, cfg)
        steps = [logits]
        for i in range(8):      # teacher-forced decode
            logits, caches = lm_decode(params, {"token": forced[i].to(dev),
                                                "pos": prompt_len + i,
                                                "caches": caches}, cfg)
            steps.append(logits)
        # padded vocab entries hold -1e30 on both sides; compare the real ones
        res[dev] = [x[..., :cfg.vocab_size].float().cpu() for x in steps]
    for a, b in zip(res["cuda"], res["cpu"]):
        worst = max(worst, rel_err(a, b))
        if not bool(torch.isfinite(a).all()):
            fail(f"{arch}: non-finite logits on the card")
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            fail(f"{arch}: greedy token differs between card and CPU")
    if not worst < 2e-2:
        fail(f"{arch}: logits rel. err {worst} >= 2e-2")
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------- serve
def serve_full_width(ops_fa, ops_ds):
    from dataclasses import asdict

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serve_loop import DiffusionServer

    cfg = get_arch("internlm2-1.8b")
    say(f"serve: {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} vocab={cfg.vocab_size} "
        f"params={cfg.param_count() / 1e9:.3f}e9")
    t0 = time.perf_counter()
    srv = DiffusionServer(cfg, device="cuda", dispatcher_impl="vectorized",
                          batch_drain=True, seed=0)
    torch.cuda.synchronize()
    say(f"serve: init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    disp = srv.router.dispatcher
    mirror = srv.score_mirror
    if mirror is None or disp.score_backend != "cuda":
        fail("the server did not put the dispatcher's scoring on the card")

    timing = {"prefill": [], "decode": []}
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def timed(kind, fn):
        def call(params, batch):
            nonlocal finite
            t = time.perf_counter()
            logits, caches = fn(params, batch)
            torch.cuda.synchronize()
            timing[kind].append(time.perf_counter() - t)
            finite = finite & torch.isfinite(logits).all()
            return logits, caches
        return call

    srv.prefill_fn = timed("prefill", srv.prefill_fn)
    srv.decode_fn = timed("decode", srv.decode_fn)

    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, cfg.vocab_size, size=(16,)) for i in range(8)}
    sids = list(prompts)
    n_req, burst = 32, 8
    verify_checks = 0

    torch.cuda.synchronize()
    for fn in (ops_fa, ops_ds.dispatch_scores, ops_ds.dispatch_score_update):
        fn.launches = 0
    t_start = time.perf_counter()
    for i in range(n_req):
        sid = sids[int(rng.integers(0, len(sids)))]
        srv.submit(sid, prompts[sid], max_new_tokens=8)
        if (i + 1) % burst == 0 or i + 1 == n_req:
            srv.step()          # rescore, drain, serve, mirror flush
            err = mirror.verify()
            if err != 0.0:
                fail(f"device mirror verify() = {err} after a step")
            verify_checks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {"flash_attention": ops_fa.launches,
                "dispatch_scores": ops_ds.dispatch_scores.launches,
                "dispatch_score_update": ops_ds.dispatch_score_update.launches}

    s, sc = srv.stats, srv.score_stats
    sb, sw = disp.rebuild_scores(backend="cuda")
    nb, nw = disp.rebuild_scores(backend="numpy")
    checks = {
        "served == 32": s.served == n_req,
        "check_consistency": disp.check_consistency(),
        "rebuild_scores exact": np.array_equal(sb, nb) and np.array_equal(sw, nw),
        "finite logits": bool(finite),
        "mirror verify": mirror.verify() == 0.0,
        "a rescore every step": sc.epochs == verify_checks,
        **{f"{k} launched": v > 0 for k, v in launches.items()},
    }
    r = srv.router.stats
    say(f"served={s.served} prefix_hit={s.hit_rate:.0%} prefills={s.prefills} "
        f"swap_ins={s.swap_ins} decode_steps={s.decode_steps} "
        f"replicas={len(srv.replicas)} scale_ups={r.scale_ups} "
        f"avg_response={s.avg_response_s * 1e3:.1f}ms "
        f"win_p50={r.p50_s * 1e3:.1f}ms win_p99={r.p99_s * 1e3:.1f}ms")
    pre, dec = timing["prefill"], timing["decode"]
    perf = {
        "prefill_ms_per_request": 1e3 * float(np.mean(pre)),
        "prefill_ms_per_request_after_first": 1e3 * float(np.mean(pre[1:] or pre)),
        "decode_ms_per_token": 1e3 * float(np.mean(dec)),
        "decode_ms_per_token_after_first": 1e3 * float(np.mean(dec[1:] or dec)),
        "decode_tokens_per_s": len(dec) / float(np.sum(dec)),
        "stream_tokens_per_s": s.decode_steps / wall,
        "wall_s": wall, "prefills": len(pre), "decode_steps": len(dec),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mirror": mirror.stats.snapshot(), "scores": asdict(sc),
        "verify_checks": verify_checks,
    }
    say("serve perf: " + json.dumps(perf))
    say("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serve checks failed: {bad}")
    shapes = {"flash_attention": (1, 16, 16, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.head_dim),
              "dispatch_scores": (max(1, sc.max_rows), disp._presence.shape[1],
                                  disp._presence.shape[0]),
              "dispatch_score_update": (disp._Sw.shape[0], max(1, sc.max_epoch_keys),
                                        disp._Sw.shape[1])}
    return launches, shapes, perf


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "n/a"
    say(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    took = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f}s for {sorted(took)} "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in took.items())})")
    for src in _build.sources():
        log = _build.target(src).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    say(f"  ptxas {src}: {line.strip()}")

    from repro_torch.kernels.dispatch_score import ops as ops_ds
    from repro_torch.kernels.flash_attention.ops import flash_attention as ops_fa

    # 3. parity
    t0 = time.perf_counter()
    flash_rows = []
    for shape, causal, window in (
            ((1, 16, 16, 16, 8, 128), True, 0),
            ((1, 512, 512, 16, 8, 128), True, 0),
            ((1, 2048, 2048, 16, 8, 128), True, 0),
            ((1, 256, 256, 2, 2, 64), True, 64),
            ((2, 128, 256, 4, 4, 64), True, 0),
            ((1, 256, 256, 2, 2, 64), False, 0),
            ((1, 100, 100, 4, 1, 32), True, 0),
            ((1, 70, 70, 2, 2, 16), True, 16)):
        flash_rows.append(flash_case(shape, causal, window, "bf16",
                                     timed=shape[1] >= 512))
    for shape in ((1, 16, 16, 16, 8, 128), (2, 256, 256, 4, 2, 64)):
        flash_rows.append(flash_case(shape, True, 0, "f32"))
    for row in flash_rows:
        say("parity flash_attention: " + json.dumps(row))
    for W, O, E, dens in ((16, 64, 4, 0.2), (256, 512, 64, 0.05),
                          (300, 1200, 96, 0.02), (64, 256, 4, 0.2)):
        say("parity dispatch_scores: " + json.dumps(scores_case(W, O, E, dens)))
    for W, K, E in ((16, 3, 4), (256, 128, 64), (300, 200, 96), (64, 8, 4)):
        say("parity dispatch_score_update: " + json.dumps(update_case(W, K, E)))
    z = torch.arange(12.0, device="cuda").reshape(3, 4)
    before = ops_ds.dispatch_score_update.launches
    same = ops_ds.dispatch_score_update(z, torch.zeros((3, 0), device="cuda"),
                                        torch.zeros((0, 4), device="cuda"))
    if not torch.equal(same, z) or ops_ds.dispatch_score_update.launches != before:
        fail("dispatch_score_update with K == 0 must copy and launch nothing")
    say(f"parity: ok in {time.perf_counter() - t0:.1f}s")

    # 4. model on the card vs the CPU
    t0 = time.perf_counter()
    for arch, plen in (("internlm2-1.8b", 16), ("gemma3-1b", 40)):
        say(f"model {arch} reduced: card vs cpu logits rel. err "
            f"{model_check(arch, plen):.3e}")
    say(f"model: ok in {time.perf_counter() - t0:.1f}s")

    # 5. serve at full width
    t0 = time.perf_counter()
    launches, shapes, perf = serve_full_width(ops_fa, ops_ds)
    say(f"serve: ok in {time.perf_counter() - t0:.1f}s")

    # 6. timing at the main path's shapes
    main_rows = {
        "flash_attention": flash_case(shapes["flash_attention"], True, 0, "bf16",
                                      timed=True),
        "dispatch_scores": scores_case(*shapes["dispatch_scores"], density=0.2,
                                       timed=True),
        "dispatch_score_update": update_case(*shapes["dispatch_score_update"],
                                             timed=True),
    }
    for k, row in main_rows.items():
        say(f"timing {k} (main path shape): kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"bound_us={row['bound_ms'] * 1e3:.3f} ({row['bound_by']})")
    kernels = []
    for k, row in main_rows.items():
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    say(f"total: {time.perf_counter() - t_all:.1f}s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi_line, "flash_rows": flash_rows,
         "main_rows": main_rows, "serve": perf, "launches": launches,
         "shapes": shapes}, indent=1))
    say(f"nvidia-smi: {smi_line}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
