#!/usr/bin/env python3
"""Time the port's scoring (K1, K2), flash-attention (K3), grouped expert
GEMM (K4), RG-LRU (K5) and WKV6 (K6) kernels and its AdamW step of one
checkout, for comparing two versions on one card.

    python3 kernel_ab.py --src path/to/checkout/src --label parent
    python3 kernel_ab.py --label change          # this checkout's src/

Builds that checkout's kernel sources into its own ``build/kernels`` and
prints one JSON line: CUDA-event ms (means over back-to-back launches, as in
``chip_smoke.py``) at the shapes of the main path and of long prompts, with
the card's name and power limit.  K3 runs causal at internlm2-1.8b's heads
(H = 16, Hkv = 8, D = 128) for S = 16, 2,048 and 16,384, at
recurrentgemma-9b's (D = 256, window 2,048) for S = 16 and 512, and, where
the checkout's kernel takes a scale and a value width of its own, at
DeepSeek-V2-Lite's expanded prefill (H = 16, qk 192, v 128) for S =
16,384.  K1 runs at the serving window (W, O, E) =
(8, 256, 16) and at (256, 512, 64); K2 at the serving update (W, K, E) =
(256, 2, 16) and at (256, 64, 64); K5 at recurrentgemma-9b's width (W =
4,096) for T = 1, 16 and 2,048, through the plain entry and, where the
checkout has it, the gated one (bf16 logits); K6 at rwkv6-3b's heads (H =
40, N = 64, bf16 r/k/v) for T = 1, 16, 64 and 2,048.  K4 runs without fill
counts (every row live) so that a version without them computes the same
function, and, where the checkout's ``moe_gmm`` takes counts, also at one
decode token's routing.  AdamW runs ``adamw_update`` at internlm2-1.8b's
whole tree (1.89 B params, bf16 grads; about 45 GB of the card), and, where
the checkout has the plain version apart (``kernels/adamw/ref.py``), that
version on the same leaves.
Run it for each version in turns (parent, change, change, parent) in one
call and compare only within the call.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent / "src"))
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch_score.ops import dispatch_score_update, dispatch_scores
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_scan.ops import wkv6
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    res = {"label": args.label, "src": args.src, "nvidia_smi": smi.stdout.strip()}

    for shape, window in (((1, 16, 16, 16, 8, 128), 0), ((1, 2048, 2048, 16, 8, 128), 0),
                          ((1, 16, 16, 16, 1, 256), 2048), ((1, 512, 512, 16, 1, 256), 2048)):
        q, k, v = cs.attn_inputs(*shape, torch.bfloat16, 0)
        res[f"flash {shape} w={window}"] = cs.cuda_ms(
            lambda: flash_attention(q, k, v, causal=True, window=window))
    q, k, v = cs.attn_inputs(1, 16384, 16384, 16, 8, 128, torch.bfloat16, 0)
    res["flash (1, 16384, 16384, 16, 8, 128) w=0"] = cs.cuda_ms(
        lambda: flash_attention(q, k, v, causal=True), iters=5)
    if "scale" in inspect.signature(flash_attention).parameters:
        # latent attention's expanded prefill: qk 192, v 128, YaRN's scale
        q, k, v = cs.attn_inputs(1, 16384, 16384, 16, 16, 192, torch.bfloat16, 0)
        v = v[..., :128].contiguous()
        res["flash mla (1, 16384, 16384, 16, 16, 192/128)"] = cs.cuda_ms(
            lambda: flash_attention(q, k, v, causal=True, scale=0.114721), iters=5)
    del q, k, v

    E, K, D, F = 64, 8, 2048, 1024          # olmoe-1b-7b
    fill = cs.routed_counts(1, E, K, 8, D) if "counts" in inspect.signature(
        moe_gmm).parameters else None
    for C, d_in, d_out, out_dtype in ((8, F, D, None), (8, D, F, torch.float32),
                                      (320, D, F, torch.float32), (320, F, D, None)):
        g = torch.Generator(device="cuda")
        g.manual_seed(2)
        x = torch.randn((E, C, d_in), generator=g, device="cuda").to(torch.bfloat16)
        ws = [(torch.randn((E, d_in, d_out), generator=g, device="cuda")
               / d_in ** 0.5).to(torch.bfloat16) for _ in range(4)]
        key = f"gmm C={C} {d_in}x{d_out} out={out_dtype or 'bf16'}"
        res[key] = cs.cuda_ms(cs.cycling([lambda w=w: moe_gmm(x, w, out_dtype)
                                          for w in ws]))
        if fill is not None and C == 8:
            res[key + " decode routing"] = cs.cuda_ms(cs.cycling(
                [lambda w=w: moe_gmm(x, w, out_dtype, counts=fill) for w in ws]))
        del ws

    for W, O, E, dens in ((8, 256, 16, 0.2), (256, 512, 64, 0.05)):
        d, p = (torch.from_numpy(a).cuda() for a in cs.score_inputs(W, O, E, dens, 42))
        res[f"scores W={W} O={O} E={E}"] = cs.cuda_ms(lambda: dispatch_scores(d, p))
    for W, K, E in ((256, 2, 16), (256, 64, 64)):
        s, m, dl = (torch.from_numpy(a).cuda() for a in cs.update_inputs(W, K, E, 7))
        res[f"update W={W} K={K} E={E}"] = cs.cuda_ms(lambda: dispatch_score_update(s, m, dl))

    gated = getattr(rg_ops, "rglru_gated_scan", None)
    for T in (1, 16, 2048):
        for key, fn in k5_calls(rg_ops, gated, T).items():
            res[key] = cs.cuda_ms(fn)

    H, N = 40, 64                           # rwkv6-3b
    for T in (1, 16, 64, 2048):
        r, k, v, w, u, s0 = cs.wkv6_inputs(1, T, H, N, rkv="bf16")
        res[f"wkv6 T={T}"] = cs.cuda_ms(lambda: wkv6(r, k, v, w, u, s0))
    res.update(adamw_ms())
    print(json.dumps(res), flush=True)


def adamw_ms(arch="internlm2-1.8b"):
    """{label: ms} of the AdamW step at ``arch``'s whole tree: the
    checkout's ``adamw_update`` and, where it has one, its plain version."""
    import importlib

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map
    params = init_params(get_arch(arch), device="cuda", seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    grads = tree_map(lambda p: (1e-3 * torch.randn(p.shape, generator=g, device="cuda"))
                     .to(p.dtype), params)
    state = adamw_init(params)
    cfg = AdamWConfig()
    n = sum(p.numel() for p in tree_leaves(params))
    res = {f"adamw {arch}": cs.cuda_ms(lambda: adamw_update(grads, state, params, cfg),
                                       iters=5, warmup=2),
           f"adamw {arch} params": n,
           f"adamw {arch} bound": 24.0 * n / cs.HBM_BYTES_PER_S * 1e3}
    try:
        ref = importlib.import_module("repro_torch.kernels.adamw.ref")
    except ImportError:
        ref = None
    if ref is not None:
        leaves = [tree_leaves(t) for t in (grads, state["m"], state["v"], params)]
        one = torch.ones((), device="cuda")
        res[f"adamw {arch} plain"] = cs.cuda_ms(
            lambda: ref.adamw_ref(*leaves, one * 0.1, one * 0.05, cfg.lr, b1=cfg.b1,
                                  b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay,
                                  grad_clip=cfg.grad_clip), iters=5, warmup=2)
    del params, grads, state
    torch.cuda.empty_cache()
    return res


def k5_calls(rg_ops, gated, T, W=4096):
    """{label: call} for K5 at (1, T, W) from a seed: the plain entry, and
    the gated one (bf16 logits) where the checkout has it."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    a = torch.sigmoid(torch.randn((1, T, W), generator=g, device="cuda"))
    b, x, r, i = (torch.randn((1, T, W), generator=g, device="cuda") for _ in range(4))
    h0 = torch.randn((1, W), generator=g, device="cuda")
    calls = {f"rglru T={T}": lambda: rg_ops.rglru_scan(a, b, h0)}
    if gated is not None:
        lam = torch.full((W,), 0.65, device="cuda")
        xb, rb, ib = (t.to(torch.bfloat16) for t in (x, r, i))
        calls[f"rglru gated T={T}"] = lambda: gated(xb, rb, ib, lam, h0)
    return calls


if __name__ == "__main__":
    main()
