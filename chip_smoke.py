#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):
  1. device  - the card's name and power limit (nvidia-smi);
     gloo4   - started here, read after phase 4: the multi-rank jobs of
               ``tests/_torch_sharded_jobs.py`` (no JAX) on 4 gloo ranks on
               this machine's CPU, a (2, 2) mesh, the card hidden from them,
               on inputs from the port's own init: ``moe_ffn_sharded``, the
               sharded loss and grads, two ``Trainer`` steps and a
               microbatch step, checkpoints across meshes, the sharded
               ``DiffusionServer`` (reduced internlm2, olmoe,
               recurrentgemma, rwkv6; modeled and real payload), K3's
               GQA heads at tp = 2, and reduced gemma3-1b with 3 query
               heads, which do not divide over 'tp' (each rank attends its
               own S / 2 query rows: K3's entry at its offset in prefill,
               the plain route in training), each held to the port on one
               device by ``port_checks`` (the bounds of
               ``test_torch_sharding.py``);
  2. build   - nvcc builds every kernel in src/repro_torch/csrc, in parallel;
  3. parity  - each kernel against its plain PyTorch version on the card:
               flash attention (bf16, rel. err < 2e-2, head dims up to 256,
               prompts up to 2,048, unmasked at the whisper encoder's 1,024
               and 1,500 frames and across Sq != Skv (cross-attention, 128
               and 187 queries), causal at llava's 4,608 positions with 56/8
               heads; f32 < 2e-5, also unmasked at Sq != Skv; then one
               sequence shard at a time at its own query offset, llava's
               prompt in 16 blocks of 288 rows and a 2,048-token prompt
               under a 2,048 window at D = 256 in 16 of 128, each block
               against the plain version and the same rows of K3 over the
               whole sequence, 2e-2; latent attention's qk 192 / v 128
               at a softmax scale of its own, bf16 at 16 and 2,048
               positions and f32 at a ragged 100), the two
               dispatch scoring
               kernels (max |out - float64| == 0.0; K1 also at the serving
               window, at W = 1 and at ragged O), the grouped expert GEMM
               (1e-5 f32, 3e-2 bf16; at olmoe's shapes also with fill counts
               from a routed decode token and routed prompts at C = 8, 13
               and 320, and with poisoned weights: NaN in every expert whose
               count is 0 and in every dead row, which must leave the output
               finite, 0 on dead rows and equal to the plain version on live
               rows; at DeepSeek-V2-Lite's E = 64, D = 2,048, F = 1,408, whose
               last 256-wide tile over F is half full, with a decode
               token's fills at C = 8, at C = 200 full, and poisoned), the
               RG-LRU scan (1e-5; the plain entry and the gated
               one, whose gate chain runs inside the kernel, from T = 1 to
               2,048, and at a ragged last group of steps) and
               WKV6 (1e-4 at rwkv6's heads
               from T = 1 to 2,048, short and windowed; finite and 1e-3 under
               strong decay, w down to 1e-5), the two scans with a
               carried-in state and on their final state;
  4. model   - the reduced internlm2, gemma3, olmoe, recurrentgemma,
               rwkv6, llama3-8b, llama3.2-3b and qwen3-moe-235b-a22b
               decoders, prefill and eight decode steps on the card
               against the same weights on the CPU (plain versions): logits
               rel. err < 2e-2, equal greedy tokens; the same for reduced
               whisper (64 audio frames, 8 text tokens; 6 flash-attention
               launches, three a layer pair) and reduced llava (8 patches
               before 16 tokens; 4 launches);
  5. serve   - each family at full published width (random weights from a
               seed) served through DiffusionServer with the vectorized
               dispatcher and the batch drain, which puts the dispatcher's
               scoring on the card (the bulk rescore and the score mirror):
               internlm2-1.8b on the launcher's stream (seed 0, 8 sessions,
               16-token prompts, 32 requests, 8 new tokens, bursts of 8),
               then olmoe-1b-7b, recurrentgemma-9b and rwkv6-3b on 4
               sessions and 16 requests, one model on the card at a time.
               Kernel launch counters are zeroed just before each and read
               just after, and every RG-LRU launch of recurrentgemma's run
               must come from the gated entry;
     mesh_serve - the same four at full width and the same streams under
               ``make_ctx(make_host_mesh())``, world size 1 over NCCL (params,
               caches, prompts and tokens DTensors, every kernel on the local
               shards): counters, greedy tokens and every kernel's launches
               equal to the unsharded run's (so to ``SERVE_LAUNCHES``),
               decode ms/token of both runs; every kernel entry point given
               an empty batch launches nothing;
  6. payload - internlm2-1.8b at full width served twice on the launcher's
               stream with two HBM session slots over eight sessions and a
               host tier of eight, payload modeled and then real: equal
               counters, assignment logs and greedy tokens, swap-ins > 0,
               every measured edge that touches hbm in (0, 64) GB/s (the
               host link); then one session's cache hbm -> dram -> disk ->
               hbm through ``RealPayload`` in 4 MiB spill chunks, bit-equal,
               its spill freed, and a flipped spill byte caught in both
               corrupt modes;
  7. checkpoint - the same params saved by ``AsyncCheckpointer`` into a
               temporary directory, restored onto the card bit for bit;
  8. ci      - the obs, chaos and overload smokes of
               ``.github/workflows/ci.yml`` with ``repro_torch.launch.serve``
               (on the card), each in a temporary directory, their assertion
               blocks unchanged;
  9. train   - (a) each kernel entry point on CUDA inputs that require grad
               raises (no kernel has a backward), and under no_grad matches
               its plain version; (b) one train step of reduced internlm2,
               gemma3, olmoe (its routing replayed from the CPU),
               recurrentgemma and rwkv6 on the card against the CPU: loss,
               grad norm, grads and first moments within 2e-2 (rwkv6's
               grads and moments 3e-2, ``STEP_LIMITS_BY_ARCH``), each leaf's
               update within 2e-2 of AdamW applied on the CPU to the card's
               moments, params within one bf16 ulp (98%; rwkv6 97%) and 2 lr
               plus one ulp (all) of the CPU's step, no kernel launch (the
               train route reaches none); (c) ``python -m
               repro_torch.launch.train`` at internlm2-1.8b's full width (8
               x 256 tokens, 9 steps): finite losses and grad norms, the
               mean loss of the last three steps under step 1's, the median
               step ms over steps 4-9, tokens/s, peak memory, and the AdamW
               update timed alone at that width (its share of a step); (d) a
               failure at step 12 and a restart from the step-10 checkpoint
               on the card, the restored state bit-equal to the saved one;
               (e) olmoe-1b-7b at 2 of 16 layers and rwkv6-3b at 4 of 32,
               full width, trained by the port's ``Trainer`` in this process
               (8 x 256 tokens, 6 steps, the launcher's AdamW): finite
               losses and grad norms, no kernel launch, the median step ms
               over steps 4-6, tokens/s, peak memory under 80 GB and the
               step's bound; (f) recurrentgemma-9b's 'R' block at full width
               forward and backward on the card against the CPU (B = 1, T =
               256: output 2e-2, every grad 3e-2 L2), timed at B = 4, then
               ``python -m repro_torch.launch.train --arch recurrentgemma-9b
               --reduced --steps 3`` on the card;
     dryrun  - the cost model under this machine's torch: (a) started
               beside the build, ``python -m repro_torch.launch.dryrun`` on
               internlm2-1.8b x train_4k, olmoe-1b-7b x decode_32k (each
               rank's block of the capacity buffer), rwkv6-3b x train_4k
               (its loops over time counted by their trip counts),
               gemma3-1b x prefill_32k and llama3.2-3b x decode_32k, whose
               query heads do not divide over 'tp' (each rank's own query
               rows, and its own cache slots), the last three held to
               torch 2.13's matmul flops on a CPU host and the two train
               cells to this machine's first count (``DRYRUN_DOT_FLOPS``), 256 fake ranks (16 x 16, the
               card hidden, nothing allocated): each cell's terms, dominant term, peak
               GiB and collective counts, ``ok`` required; five reduced
               cells on a fake (2, 2) mesh held to the matmul flops torch
               2.13 counts, equal to the reference's compiled step's
               (``DRYRUN_REDUCED_DOT_FLOPS``); (b) after phase
               9, the cost model's counts at world size 1 on FakeTensors of
               phase 9's internlm2-1.8b step and of one decode step beside
               what the card measured: matmul flops over ``_step_bound``'s
               operations (0.8-1.5), the eager peak over the launcher's
               ``max_memory_allocated`` (0.5-2.0), the decode step's bytes
               over the weights it reads (0.5-2.0), the bounds beside the
               measured step and ms/token; then phase 9's rwkv6-3b step (4
               of 32 layers, 8 x 256 tokens; traced in (a)'s process after
               the cells) with trip counts against the same step with
               every step run (matmul flops
               equal, flops, transcendentals and bytes within 1%, the peak
               within 5%), its matmul flops over ``_step_bound``'s
               operations (0.8-1.5) and its eager peak over the card's
               ``max_memory_allocated`` (0.5-2.0);
     examples - ``python -m repro_torch.examples.serve_diffusion`` (reduced
               internlm2 under ``DiffusionServer``, three policies) and
               ``elastic_failover`` (reduced gemma3-1b through the
               ``Trainer``, a scale-up, a worker loss and recovery, a
               scale-down) run in this process on the card and on the CPU:
               equal serving counters, flash-attention launches on the card;
               equal events and recovery actions, the first loss within
               2e-2 (both runs' weights drawn on the CPU), a finite final
               loss;
 10. mesh    - (a) ``--mesh host`` at world size 1 over NCCL: olmoe-1b-7b
               at full width, 2 of 16 layers, trained 6 steps by the
               ``Trainer`` under ``make_ctx(make_host_mesh())`` on the
               tokens, seed and optimizer of phase 9's ``--mesh none`` run:
               all 24 MoE calls through ``moe_ffn_sharded``, the first loss
               within 2e-3 of that run's and the others within 2e-2, no
               kernel launch; step ms, tokens/s and peak memory beside that
               run's; (b) ``topk_compress`` and ``compressed_psum`` on the
               full-width grads, bit-equal to their plain forms, the mean
               within scale / 2; (c) the trained params saved as DTensors
               and restored under ``shardings=``, bit-exact; (d) every
               kernel entry point refuses DTensor operands;
 11. encdec  - whisper-medium at full width and depth (24 + 24 layers,
               random weights from seed 0): a prefill of 1,024 seeded audio
               frames and 128 tokens with exactly 72 flash-attention
               launches, 32 greedy decode steps (self caches of 448, cross
               caches of 1,024), finite logits, prefill and decode ms, peak
               memory; then ``python -m repro_torch.launch.train --arch
               whisper-medium --seq 1024 --batch 8 --steps 6`` in a
               subprocess (finite losses, step ms, peak memory);
 12. vision  - llava-next-34b at full width with its depth cut to 8 of 60
               layers: a prefill of 2,304 seeded patch embeddings and 2,304
               tokens (one flash-attention launch a layer), 16 greedy decode
               steps, finite logits; then the same config served text-only
               as in phase 5 (4 sessions, 16 requests);
     archs   - llama3-8b and llama3.2-3b at full width and depth, and
               qwen3-moe-235b-a22b at full width with 2 of its 94 layers
               (random weights from seed 0): a 16-token prefill (one K3
               launch a layer; qwen3 also 3 K4 launches a layer, E = 128,
               D = 4,096, F = 1,536) and 8 greedy decode steps, finite
               logits, decode ms/token beside its weight-read floor;
 13. timing  - each kernel at the main path's shapes: CUDA-event times of
               the kernel, its plain version and one library call where one
               computes the same function, beside the card's bound (bytes
               over 3.35 TB/s or operations over the type's peak, whichever
               is larger).  The grouped expert GEMM's row is olmoe's down
               product at one decode token's routing, its bound counted from
               the live experts' bytes (the all-experts bound beside it),
               its times taken over four copies of the weights in turn so
               that no launch finds them in L2.  More rows: the gate/up
               shape, full capacity at C = 8 and C = 320, flash attention at
               2,048 tokens (D = 128) and at 512 (D = 256), at the whisper
               encoder's and cross-attention's shapes, at llava's
               prefill and at the last of its 16 sequence blocks (288 rows
               at q_offset 4,320, SDPA given the explicit boolean mask),
               window scoring at
               (W, O, E) = (256, 512, 64), the rank-K update at (256, 64,
               64), WKV6 at T = 16 and 2,048, K4 at qwen3-moe-235b-a22b's
               down product at one decode token's routing (E = 128, top 8)
               and at the block one rank runs in olmoe-1b-7b x decode_32k
               on 16 x 16 (E = 4 of 64 experts, C = 2 of 24 slots, the gate
               product with the block's fills).  DeepSeek-V2-Lite's rows
               (``deepseek_rows``): K3 at S = 16,384 with H = 16, qk 192, v
               128 and scale 0.114721 (SDPA given the same scale) beside
               D = 128 at the same length, and K4's gate/up and down
               products at a decode token's routing (C = 8) and at a routed
               2,048-token prefill group at its fullest count.
               The RG-LRU's row is the gated
               entry at one decode token; rows for the plain entry at T = 1
               (beside one ``addcmul``) and for both entries at T = 16 and
               2,048 follow.
The line before the last is a JSON object with the per-kernel numbers; the
last line is the device record.  Exits non-zero without CUDA, and when the
repository's ``src/repro_torch`` is not next to this file.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# AdamW's bytes a bf16 param: the norm reads g; the update reads g, p, m, v
# and writes p, m, v
ADAMW_BYTES = 24.0
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}   # dense tensor-core bf16; fp32 SIMT

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:87",
    "dispatch_scores": "src/repro/kernels/dispatch_score/dispatch_score.py:111",
    "dispatch_score_update": "src/repro/kernels/dispatch_score/dispatch_score.py:74",
    "moe_gmm": "src/repro/kernels/moe_gmm/moe_gmm.py:39",
    "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:41",
    "wkv6": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:87",
    "adamw_update": "none: src/repro/optim/adamw.py is jnp code that XLA fuses",
}
SOURCES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "dispatch_scores": "src/repro_torch/csrc/dispatch_score.cu",
    "dispatch_score_update": "src/repro_torch/csrc/dispatch_score.cu",
    "moe_gmm": "src/repro_torch/csrc/moe_gmm.cu",
    "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
    "wkv6": "src/repro_torch/csrc/wkv6.cu",
    "adamw_update": "src/repro_torch/csrc/adamw.cu",
}
# each kernel's launches over the serve run of its family (phase 5): the
# serving path is the same whatever the train route does
SERVE_LAUNCHES = {"flash_attention": 264, "dispatch_scores": 8, "dispatch_score_update": 3,
                  "moe_gmm": 6480, "rglru_scan": 3510, "wkv6": 4320}
SERVE_COUNTERS = ("served", "prefix_hits", "prefills", "swap_ins", "decode_steps")
# The served families: (arch, sessions, requests, the kernels its path must
# launch besides the two scoring kernels every vectorized drain runs).
FAMILIES = (("internlm2-1.8b", 8, 32, ("flash_attention",)),
            ("olmoe-1b-7b", 4, 16, ("flash_attention", "moe_gmm")),
            ("recurrentgemma-9b", 4, 16, ("flash_attention", "rglru_scan",
                                          "rglru_gated_scan")),
            ("rwkv6-3b", 4, 16, ("wkv6",)))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls.  The card
    is held busy (``torch.cuda._sleep``) while the host enqueues them, so the
    events time the device and not the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t        # one call, host and device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_s, 1.0) * 2e9))   # cycles, < 2 GHz
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
def attn_inputs(B, Sq, Skv, H, Hkv, D, dtype, seed, Dv=None):
    """q, k of head width D and v of ``Dv`` (None: D), from a seed."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q = torch.randn((B, Sq, H, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Skv, Hkv, Dv or D), generator=g, device="cuda").to(dtype)
    return q, k, v


def attn_cost(B, Sq, Skv, H, Hkv, D, causal, window, elem, q_offset=None, Dv=None):
    """(bytes, operations) the function needs: q, k, v read once, o written
    once; 2*(D + Dv) operations per unmasked (query, key) pair (Dv, the
    value width, None: D), query row i at position ``q_offset + i``
    (default ``Skv - Sq``)."""
    import torch
    qpos = torch.arange(Sq)[:, None] + (Skv - Sq if q_offset is None else q_offset)
    kpos = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    pairs = int(ok.sum())
    Dv = Dv or D
    nbytes = elem * (B * Sq * H * (D + Dv) + B * Skv * Hkv * (D + Dv))
    return nbytes, 2.0 * (D + Dv) * pairs * B * H


def sdpa_call(q, k, v, causal, window, q_offset=None, scale=None):
    """One library call computing the same function (timed only); a mask
    other than whole-sequence causal goes in as an explicit boolean one.
    v may be narrower than q and k; ``scale`` None is 1 / sqrt(D)."""
    import torch
    import torch.nn.functional as F
    Sq, Skv = q.shape[1], k.shape[1]
    offset = Skv - Sq if q_offset is None else q_offset
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kw = {} if scale is None else {"scale": scale}
    if q.shape[2] != k.shape[2]:
        kw["enable_gqa"] = True
    if causal and not window and Sq == Skv:
        kw["is_causal"] = True
    elif causal or window:
        qpos = torch.arange(Sq, device="cuda")[:, None] + offset
        kpos = torch.arange(Skv, device="cuda")[None, :]
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device="cuda")
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        kw["attn_mask"] = ok
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def flash_case(shape, causal=True, window=0, dtype_name="bf16", seed=0,
               timed=False, Dv=None, scale=None):
    """K3 against its plain version at (B, Sq, Skv, H, Hkv, D), a value
    width ``Dv`` (None: D) and a softmax ``scale`` (None: 1 / sqrt(D))."""
    import torch
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    B, Sq, Skv, H, Hkv, D = shape
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    q, k, v = attn_inputs(B, Sq, Skv, H, Hkv, D, dtype, seed, Dv)
    kw = dict(causal=causal, window=window, scale=scale)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, **kw)
    err = rel_err(out, ref)
    tol = 2e-2 if dtype_name == "bf16" else 2e-5
    row = {"shape": list(shape), "dv": Dv or D, "scale": scale, "causal": causal,
           "window": window, "dtype": dtype_name, "rel_err": err,
           "max_abs_err": float((out.float() - ref.float()).abs().max())}
    if not err < tol:
        fail(f"flash_attention {row} exceeds {tol}")
    if timed:
        lib = sdpa_call(q, k, v, causal, window, scale=scale)
        row["library_rel_err"] = rel_err(lib().transpose(1, 2), ref)
        row["ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw))
        row["plain_ms"] = cuda_ms(lambda: attention_ref(q, k, v, **kw))
        row["library_ms"] = cuda_ms(lib)
        nbytes, ops = attn_cost(B, Sq, Skv, H, Hkv, D, causal, window,
                                q.element_size(), Dv=Dv)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, dtype_name)
    return row


# K3 on one sequence shard at a time: (label, (B, S, H, Hkv, D), window,
# shards), the way a prefill whose query heads do not divide over 'tp' runs
# it on each rank (llava-next-34b's 56 heads at tp = 16, its served prompt of
# 2,304 patches and 2,304 tokens; recurrentgemma's local attention)
FLASH_SPLITS = (("llava prefill", (1, 4608, 56, 8, 128), 0, 16),
                ("window 2048", (1, 2048, 16, 1, 256), 2048, 16))


def flash_split_case(label, shape, window, shards, seed=0, timed=False):
    """Each of ``shards`` equal row blocks of the query at its own
    ``q_offset`` against the plain version on the same inputs, and against
    the same rows of K3 over the whole sequence (bf16, causal).  ``timed``:
    the last block, the heaviest, against its bound, the plain version and
    SDPA with an explicit boolean mask."""
    import torch
    from repro_torch.kernels.flash_attention.ops import attention_ref, flash_attention
    B, S, H, Hkv, D = shape
    q, k, v = attn_inputs(B, S, S, H, Hkv, D, torch.bfloat16, seed)
    whole = flash_attention(q, k, v, causal=True, window=window)
    n = S // shards
    errs, max_abs = [], 0.0
    for a in range(0, S, n):
        qa = q[:, a:a + n].contiguous()
        out = flash_attention(qa, k, v, causal=True, window=window, q_offset=a)
        ref = attention_ref(qa, k, v, causal=True, window=window, q_offset=a)
        errs.append([rel_err(out, ref), rel_err(out, whole[:, a:a + n])])
        max_abs = max(max_abs, float((out.float() - ref.float()).abs().max()))
    torch.cuda.synchronize()
    row = {"label": label, "shape": list(shape), "window": window, "shards": shards,
           "rows": n, "first_and_last_offset": [0, S - n], "worst_rel_err_plain": max(e[0] for e in errs),
           "worst_rel_err_whole": max(e[1] for e in errs), "max_abs_err": max_abs}
    if not (row["worst_rel_err_plain"] < 2e-2 and row["worst_rel_err_whole"] < 2e-2):
        fail(f"flash_attention split {row} exceeds 2e-2 (per block {errs})")
    if timed:
        a = S - n
        qa = q[:, a:].contiguous()
        lib = sdpa_call(qa, k, v, True, window, q_offset=a)
        row["library_rel_err"] = rel_err(lib().transpose(1, 2),
                                         attention_ref(qa, k, v, causal=True,
                                                       window=window, q_offset=a))
        row["ms"] = cuda_ms(lambda: flash_attention(qa, k, v, causal=True, window=window,
                                                    q_offset=a))
        row["plain_ms"] = cuda_ms(lambda: attention_ref(qa, k, v, causal=True,
                                                        window=window, q_offset=a))
        row["library_ms"] = cuda_ms(lib)
        nbytes, ops = attn_cost(B, n, S, H, Hkv, D, True, window, q.element_size(),
                                q_offset=a)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, "bf16")
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


# --------------------------------------------------------- grouped expert GEMM
def routed_counts(T, E, K, C, D, seed=0):
    """Fill counts (int32 [E], on the card) of one top-K routing of T tokens
    through the port's router, on a random router and random hidden states
    from a seed: min(assignments per expert, C)."""
    import torch
    from repro_torch.models import moe
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    router = {"router": torch.randn((D, E), generator=g, device="cuda") / D ** 0.5}
    x = torch.randn((T, D), generator=g, device="cuda")
    _, _, idx = moe._router(router, x, K)
    flat = idx.reshape(-1)
    n = torch.zeros(E, dtype=torch.int32, device="cuda")
    n.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return torch.clamp(n, max=C)


def decode_block(cfg, T, dp, tp):
    """((E, C, D, F), fills) of the block of the MoE capacity buffer rank (0,
    0) runs in a decode step of T tokens on a (dp, tp) mesh: its E / tp
    experts and its chunk of C over 'dp', each expert's fill (from a
    seeded routing, ``routed_counts``) less the block's first slot."""
    import torch
    from repro_torch.models.moe import capacity
    E, C = cfg.num_experts, capacity(T, cfg.moe_top_k, cfg.num_experts,
                                     cfg.capacity_factor)
    n_e, n_c = E // tp, -(-C // dp)
    fill = routed_counts(T, E, cfg.moe_top_k, C, cfg.d_model)[:n_e]
    return (n_e, n_c, cfg.d_model, cfg.d_ff), torch.clamp(fill, 0, n_c)


def cycling(fns):
    """One callable that calls ``fns`` in turn: timing over several copies of
    the weights keeps each launch's reads out of the 50 MB L2, as the served
    path finds them (every layer has its own experts)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def gmm_case(E, C, D, F, dtype_name="bf16", out_dtype=None, counts=None,
             poison=False, seed=2, timed=False, copies=4):
    """K4 against its plain version.  ``counts``: fill counts (int32 [E]) or
    None for every row live.  ``poison``: x's dead rows and the weights of
    every expert with count 0 are NaN, so any read of them shows in the
    output; the output must be finite, zero on dead rows and equal to the
    plain version on live rows."""
    import torch
    from repro_torch.kernels.moe_gmm.ops import gmm_ref, moe_gmm
    dtype = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((E, C, D), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, D, F), generator=g, device="cuda") / D ** 0.5).to(dtype)
    kw = {} if counts is None else {"counts": counts}
    live = (torch.arange(C, device="cuda")[None, :]
            < (counts if counts is not None else torch.full((E,), C, device="cuda"))[:, None])
    if poison:
        x[~live] = float("nan")
        w[counts == 0] = float("nan")
    out = moe_gmm(x, w, out_dtype, **kw)
    torch.cuda.synchronize()
    ref = gmm_ref(x, w, out_dtype, **kw)
    tol = 3e-2 if dtype_name == "bf16" else 1e-5
    row = {"shape": [E, C, D, F], "dtype": dtype_name,
           "out_dtype": str(out.dtype).replace("torch.", ""),
           "live_experts": int((live.any(1)).sum()), "live_rows": int(live.sum()),
           "poison": poison, "rel_err": rel_err(out[live], ref[live]),
           "max_abs_err": float((out.float() - ref.float()).abs().max()),
           "finite": bool(torch.isfinite(out).all()),
           "dead_rows_zero": bool((out[~live] == 0).all())}
    if not (row["rel_err"] < tol and out.dtype == ref.dtype and row["finite"]
            and row["dead_rows_zero"]):
        fail(f"moe_gmm {row} exceeds {tol}, or is not finite, or not 0 on dead rows")
    if timed:
        ws = [w] + [torch.randn_like(w, dtype=torch.float32).to(dtype)
                    for _ in range(copies - 1)]
        row["ms"] = cuda_ms(cycling([lambda w=w: moe_gmm(x, w, out_dtype, **kw)
                                     for w in ws]))
        row["plain_ms"] = cuda_ms(cycling([lambda w=w: gmm_ref(x, w, out_dtype, **kw)
                                           for w in ws]))
        row["library_ms"] = cuda_ms(cycling([lambda w=w: torch.bmm(x, w) for w in ws]))
        elem, out_bytes = x.element_size(), out.element_size() * E * C * F
        live_bytes = elem * (row["live_rows"] * D + row["live_experts"] * D * F) + out_bytes
        row["bound_ms"], row["bound_by"] = bound_ms(
            live_bytes, 2.0 * row["live_rows"] * D * F, dtype_name)
        row["bound_all_experts_ms"], _ = bound_ms(
            elem * (E * C * D + E * D * F) + out_bytes, 2.0 * E * C * D * F, dtype_name)
        del ws
    return row


def deepseek_rows():
    """DeepSeek-V2-Lite's kernel shapes, each held to its plain version and
    timed: K3 at the expanded latent attention of its longest served
    prompt (S = 16,384, H = 16, qk 192, v 128, YaRN's softmax scale) beside
    internlm2-1.8b's heads at the same length; K4 at its experts (E = 64,
    top 6, D = 2,048, F = 1,408, whose last 256-wide tile over F is half
    full) at one decode token's routing at the dropless decode capacity of
    8, and at a routed prefill group of ``DROPLESS_GROUP`` tokens at its
    fullest expert's count."""
    import torch
    from repro_torch.configs.deepseek_v2_lite import CONFIG as ds
    from repro_torch.models.layers import mla_softmax_scale
    from repro_torch.models.moe import DROPLESS_GROUP, dropless_capacity
    S, H = 16384, ds.num_heads
    rows = {
        "flash_attention S=16384 D=128 (causal)": flash_case(
            (1, S, S, 16, 8, 128), True, 0, "bf16", timed=True),
        f"flash_attention deepseek-v2-lite prefill S={S} H={H} qk {ds.head_dim} "
        f"v {ds.v_head_dim} (causal, scale {mla_softmax_scale(ds):.6f})": flash_case(
            (1, S, S, H, H, ds.head_dim), True, 0, "bf16", timed=True,
            Dv=ds.v_head_dim, scale=mla_softmax_scale(ds)),
    }
    gc.collect()
    torch.cuda.empty_cache()            # the plain version's [H, S, S] scores
    E, K, D, F = ds.num_experts, ds.moe_top_k, ds.d_model, ds.d_ff
    T = DROPLESS_GROUP
    decode_fill = routed_counts(1, E, K, 8, D)
    group = routed_counts(T, E, K, T, D, seed=1)
    C = dropless_capacity(group, T)
    for label, c, fill in (("decode routing", 8, decode_fill),
                           (f"a routed {T}-token prefill group (C={C})", C, group)):
        rows[f"moe_gmm deepseek-v2-lite w1/w3 (f32 out), {label}"] = gmm_case(
            E, c, D, F, out_dtype=torch.float32, counts=fill, timed=True)
        rows[f"moe_gmm deepseek-v2-lite w2, {label}"] = gmm_case(
            E, c, F, D, counts=fill, timed=True)
    return rows


# -------------------------------------------------------------- RG-LRU scan
def rglru_case(B, T, W, with_h0=True, seed=3, timed=False):
    import torch
    from repro_torch.kernels.rglru_scan.ops import rglru_ref, rglru_scan
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, T, W), generator=g, device="cuda"))
    b = torch.randn((B, T, W), generator=g, device="cuda")
    h0 = torch.randn((B, W), generator=g, device="cuda") if with_h0 else None
    y, hT = rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    y_r, h_r = rglru_ref(a, b, h0)
    row = {"shape": [B, T, W], "h0": with_h0, "rel_err_y": rel_err(y, y_r),
           "rel_err_hT": rel_err(hT, h_r),
           "max_abs_err": max(float((y - y_r).abs().max()),
                              float((hT - h_r).abs().max()))}
    if not (row["rel_err_y"] < 1e-5 and row["rel_err_hT"] < 1e-5):
        fail(f"rglru_scan {row} exceeds 1e-5")
    if timed:
        row["ms"] = cuda_ms(lambda: rglru_scan(a, b, h0))
        row["plain_ms"] = cuda_ms(lambda: rglru_ref(a, b, h0),
                                  iters=20 if T <= 64 else 2, warmup=1)
        # one step is one PyTorch call; no single call computes a longer scan
        row["library_ms"] = None
        if T == 1 and h0 is not None:
            a1, b1 = a[:, 0], b[:, 0]
            row["library_ms"] = cuda_ms(lambda: torch.addcmul(b1, a1, h0))
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * (3 * B * T * W + 2 * B * W), 2.0 * B * T * W, "f32")
    return row


# fp32 operations an element of the gated scan needs: two sigmoids (exp,
# add, divide), -8 softplus(lam) r and its exp, 1 - a^2 (two), the clamp
# (two), sqrt, i xi, the product, and the step's multiply and add
GATED_OPS = 6 + 2 + 2 + 2 + 1 + 2 + 2


def rglru_gated_case(B, T, W, with_h0=True, dtype_name="bf16", seed=5, timed=False):
    import torch
    from repro_torch.kernels.rglru_scan.ops import rglru_gated_ref, rglru_gated_scan
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = torch.bfloat16 if dtype_name == "bf16" else torch.float32
    xi, r_logit, i_logit = (torch.randn((B, T, W), generator=g, device="cuda").to(dt)
                            for _ in range(3))
    lam = 0.65 + 0.5 * torch.randn((W,), generator=g, device="cuda")
    h0 = torch.randn((B, W), generator=g, device="cuda") if with_h0 else None
    y, hT = rglru_gated_scan(xi, r_logit, i_logit, lam, h0)
    torch.cuda.synchronize()
    y_r, h_r = rglru_gated_ref(xi, r_logit, i_logit, lam, h0)
    row = {"shape": [B, T, W], "gated": True, "dtype": dtype_name, "h0": with_h0,
           "rel_err_y": rel_err(y, y_r), "rel_err_hT": rel_err(hT, h_r),
           "max_abs_err": max(float((y - y_r).abs().max()),
                              float((hT - h_r).abs().max())),
           "finite": bool(torch.isfinite(y).all() and torch.isfinite(hT).all())}
    if not (row["finite"] and row["rel_err_y"] < 1e-5 and row["rel_err_hT"] < 1e-5):
        fail(f"rglru_gated_scan {row} exceeds 1e-5")
    if timed:
        row["ms"] = cuda_ms(lambda: rglru_gated_scan(xi, r_logit, i_logit, lam, h0))
        # the plain version is a Python loop over T: few runs at long T
        row["plain_ms"] = cuda_ms(lambda: rglru_gated_ref(xi, r_logit, i_logit, lam, h0),
                                  iters=20 if T <= 64 else 2, warmup=1)
        row["library_ms"] = None        # no single PyTorch call computes it
        nbytes = (3 * xi.element_size() * B * T * W + 4 * W + 4 * B * T * W
                  + 2 * 4 * B * W)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, GATED_OPS * B * T * W, "f32")
    return row


# --------------------------------------------------------------------- WKV6
def wkv6_inputs(B, T, H, N, rkv="f32", decay=None, seed=4):
    """r, k, v ~ 0.5 N(0,1) in ``rkv``; w = exp(-exp(x)), x ~ N(-2, 0.5) (the
    reference's kernel test) or the constant ``decay``; u = 0.3; s0 != 0."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = torch.bfloat16 if rkv == "bf16" else torch.float32
    r, k, v = (0.5 * torch.randn((B, T, H, N), generator=g, device="cuda")
               for _ in range(3))
    r, k, v = r.to(dt), k.to(dt), v.to(dt)
    x = torch.randn((B, T, H, N), generator=g, device="cuda")
    w = (torch.exp(-torch.exp(0.5 * x - 2.0)) if decay is None
         else torch.full_like(x, decay))
    u = 0.3 * torch.ones((H, N), device="cuda")
    s0 = 0.5 * torch.randn((B, H, N, N), generator=g, device="cuda")
    return r, k, v, w, u, s0


def wkv6_case(B, T, H, N, rkv="f32", decay=None, seed=4, timed=False):
    import torch
    from repro_torch.kernels.rwkv6_scan.ops import wkv6, wkv6_ref
    r, k, v, w, u, s0 = wkv6_inputs(B, T, H, N, rkv, decay, seed)
    out, sT = wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    o_r, s_r = wkv6_ref(r, k, v, w, u, s0)
    tol = 1e-3 if decay is not None else 1e-4
    row = {"shape": [B, T, H, N], "rkv": rkv, "decay": decay,
           "rel_err_out": rel_err(out, o_r), "rel_err_sT": rel_err(sT, s_r),
           "max_abs_err": max(float((out - o_r).abs().max()),
                              float((sT - s_r).abs().max())),
           "finite": bool(torch.isfinite(out).all() and torch.isfinite(sT).all())}
    if not (row["finite"] and row["rel_err_out"] < tol and row["rel_err_sT"] < tol):
        fail(f"wkv6 {row} exceeds {tol}")
    if timed:
        row["ms"] = cuda_ms(lambda: wkv6(r, k, v, w, u, s0))
        # the plain version is a Python loop over T: few runs at long T
        row["plain_ms"] = cuda_ms(lambda: wkv6_ref(r, k, v, w, u, s0),
                                  iters=20 if T <= 64 else 2, warmup=1)
        row["library_ms"] = None        # no single PyTorch call computes it
        nbytes = (3 * r.element_size() * B * T * H * N + 4 * B * T * H * N * 2
                  + 4 * H * N + 2 * 4 * B * H * N * N)
        # a step's fp32 operations: r.S (2 N^2), w*S + k*v (3 N^2), and the
        # bonus v_j * sum_i r_i u_i k_i (3 N for the sum, 2 N to add it in)
        ops = B * T * H * (5.0 * N * N + 5.0 * N)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, "f32")
    return row


# ----------------------------------------------------------------- model check
class RoutingReplay:
    """Teacher-forced MoE routing for the card-vs-CPU model check.

    Top-k routing is discontinuous: where two experts' router probabilities
    tie to within rounding, any change of summation order can swap them and
    change the layer's output wholesale.  The CPU pass records each router
    call's expert choice; the card pass computes its own probabilities and
    gate values but routes to the CPU's experts, so the logits compare the
    rest of the computation.  Every call where the card's own choice differs
    is counted, and it must be a tie: the CPU's margin between the k-th and
    the (k+1)-th probability under ``TIE``.
    """

    TIE = 2e-3

    def __init__(self, moe):
        self.moe, self.orig = moe, moe._router
        self.recorded, self.flips, self.mode, self.i = [], [], "record", 0

    def __call__(self, p, x2d, top_k):
        import torch
        probs, gate_vals, gate_idx = self.orig(p, x2d, top_k)
        if self.mode == "record":
            top = torch.topk(probs, top_k + 1, dim=-1).values
            self.recorded.append((gate_idx.cpu(), (top[:, -2] - top[:, -1]).cpu()))
            return probs, gate_vals, gate_idx
        idx, margin = self.recorded[self.i]
        self.i += 1
        own = gate_idx.cpu()
        for t in torch.nonzero((own.sort(-1).values != idx.sort(-1).values).any(-1)):
            self.flips.append(float(margin[t]))
        idx = idx.to(probs.device)
        vals = torch.gather(probs, 1, idx)
        return probs, vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx

    def __enter__(self):
        self.moe._router = self
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def model_check(arch: str, prompt_len: int, frontend_len: int = 0):
    """Reduced model on the card vs the same weights on the CPU: prefill,
    then eight teacher-forced decode steps.  ``frontend_len`` seeded frame
    embeddings go in as whisper's ``audio_embeds`` (the prompt is then its
    text) or as llava's ``patch_embeds`` before the prompt.  Returns (worst
    logits rel. err, routing flips at ties, problems found, card launches)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import (cache_init, init_params, make_decode_step,
                                    make_prefill_step)
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.serve_loop import _merge_prefill_caches
    cfg = get_arch(arch).reduced()
    cpu = init_params(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 1)))
    batch = {"tokens": tokens}
    pos0 = prompt_len
    if frontend_len:
        frames = torch.as_tensor(rng.standard_normal(
            (1, frontend_len, cfg.d_model)), dtype=torch.float32).to(torch.bfloat16)
        batch["audio_embeds" if cfg.encoder_layers else "patch_embeds"] = frames
        pos0 += 0 if cfg.encoder_layers else frontend_len
    prefill = make_prefill_step(cfg, ShapeConfig("check", "prefill", 64, 1))
    decode = make_decode_step(cfg)
    res = {}
    ops = kernel_ops()
    before = {k: fn.launches for k, fn in ops.items()}
    with RoutingReplay(moe_mod) as replay:
        for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
            replay.mode = "record" if dev == "cpu" else "replay"
            logits, pre = prefill(params, {k: v.to(dev) for k, v in batch.items()})
            caches = _merge_prefill_caches(cache_init(cfg, 1, 64, device=dev), pre, cfg)
            steps = [logits]
            for i in range(8):      # teacher-forced decode
                logits, caches = decode(params, {"token": forced[i].to(dev),
                                                 "pos": pos0 + i, "caches": caches})
                steps.append(logits)
            # padded vocab entries hold -1e30 on both sides; compare the real ones
            res[dev] = [x[..., :cfg.vocab_size].float().cpu() for x in steps]
    card = {k: fn.launches - before[k] for k, fn in ops.items()
            if fn.launches > before[k]}
    problems = []
    errs = [rel_err(a, b) for a, b in zip(res["cuda"], res["cpu"])]
    for step, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
        if not bool(torch.isfinite(a).all()):
            problems.append(f"{arch}: non-finite logits on the card (step {step})")
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            problems.append(f"{arch}: greedy token differs between card and CPU "
                            f"(step {step})")
    if not max(errs) < 2e-2:
        problems.append(f"{arch}: logits rel. err {max(errs)} >= 2e-2")
    if any(m >= RoutingReplay.TIE for m in replay.flips):
        problems.append(f"{arch}: the card routed differently where the CPU's "
                        f"top-k margin was not a tie: {replay.flips}")
    say(f"model {arch} reduced: per-step rel. err "
        + " ".join(f"{e:.2e}" for e in errs)
        + f"; routing flips at ties {len(replay.flips)} (CPU margins "
        f"{[f'{m:.1e}' for m in replay.flips]}); card launches {card}")
    return max(errs), replay.flips, problems, card


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------- serve
def kernel_ops():
    """{name: wrapper} for every kernel; each wrapper carries ``launches``."""
    from repro_torch.kernels.dispatch_score import ops as ops_ds
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan.ops import rglru_gated_scan, rglru_scan
    from repro_torch.kernels.rwkv6_scan.ops import wkv6
    return {"flash_attention": flash_attention,
            "dispatch_scores": ops_ds.dispatch_scores,
            "dispatch_score_update": ops_ds.dispatch_score_update,
            "moe_gmm": moe_gmm, "rglru_scan": rglru_scan,
            "rglru_gated_scan": rglru_gated_scan, "wkv6": wkv6}


def drive_stream(srv, n_sessions, n_req, ops, label):
    """The launcher's stream (seed 0, 16-token prompts, 8 new tokens, bursts
    of 8) through ``srv``, the score mirror verified after every step.  The
    launch counters are zeroed just before and read just after.  Returns
    (wall s, launches, mirror checks)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    prompts = {f"s{i}": rng.integers(0, srv.cfg.vocab_size, size=(16,))
               for i in range(n_sessions)}
    sids = list(prompts)
    burst = 8
    verify_checks = 0
    mirror = srv.score_mirror

    torch.cuda.synchronize()
    for fn in ops.values():
        fn.launches = 0
    t_start = time.perf_counter()
    for i in range(n_req):
        sid = sids[int(rng.integers(0, len(sids)))]
        srv.submit(sid, prompts[sid], max_new_tokens=8)
        if (i + 1) % burst == 0 or i + 1 == n_req:
            srv.step()          # rescore, drain, serve, mirror flush
            err = mirror.verify()
            if err != 0.0:
                fail(f"{label}: device mirror verify() = {err} after a step")
            verify_checks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return wall, {k: fn.launches for k, fn in ops.items()}, verify_checks


def serve_full_width(arch, n_sessions, n_req, needs, ops, cfg=None, ctx=None):
    """Serve ``arch`` at full width (``cfg``, when given: the config with its
    depth cut) on the launcher's kind of stream, under the mesh of ``ctx``
    when given; the launch counters cover this run alone.  Frees the model
    before returning."""
    from dataclasses import asdict

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.sharding import ShardCtx, local
    from repro_torch.runtime.serve_loop import DiffusionServer

    cfg = cfg or get_arch(arch)
    say(f"serve: {cfg.name} layers={cfg.num_layers} pattern="
        f"{''.join(cfg.layer_pattern) or 'A'} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} experts={cfg.num_experts} "
        f"vocab={cfg.vocab_size} params={cfg.param_count() / 1e9:.3f}e9")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = DiffusionServer(cfg, device="cuda", dispatcher_impl="vectorized",
                          batch_drain=True, seed=0, ctx=ctx or ShardCtx())
    torch.cuda.synchronize()
    say(f"serve: init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    disp = srv.router.dispatcher
    mirror = srv.score_mirror
    if mirror is None or disp.score_backend != "cuda":
        fail("the server did not put the dispatcher's scoring on the card")

    timing = {"prefill": [], "decode": []}
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    tokens = []

    def timed(kind, fn):
        def call(params, batch):
            nonlocal finite
            t = time.perf_counter()
            logits, caches = fn(params, batch)
            torch.cuda.synchronize()
            timing[kind].append(time.perf_counter() - t)
            finite = finite & torch.isfinite(local(logits)[..., :cfg.vocab_size]).all()
            return logits, caches
        return call

    def recorded(greedy):
        def call(logits):
            tok = greedy(logits)
            tokens.append(local(tok))
            return tok
        return call

    srv.prefill_fn = timed("prefill", srv.prefill_fn)
    srv.decode_fn = timed("decode", srv.decode_fn)
    srv._greedy = recorded(srv._greedy)

    wall, launches, verify_checks = drive_stream(srv, n_sessions, n_req, ops, arch)

    s, sc = srv.stats, srv.score_stats
    sb, sw = disp.rebuild_scores(backend="cuda")
    nb, nw = disp.rebuild_scores(backend="numpy")
    checks = {
        f"served == {n_req}": s.served == n_req,
        "check_consistency": disp.check_consistency(),
        "rebuild_scores exact": np.array_equal(sb, nb) and np.array_equal(sw, nw),
        "finite logits": bool(finite),
        "mirror verify": mirror.verify() == 0.0,
        "a rescore every step": sc.epochs == verify_checks,
        **{f"{k} launched": launches[k] > 0
           for k in ("dispatch_scores", "dispatch_score_update", *needs)},
    }
    if "rglru_gated_scan" in needs:     # the R layers' gates run in the kernel
        checks["every rglru_scan launch gated"] = (
            launches["rglru_gated_scan"] == launches["rglru_scan"])
    r = srv.router.stats
    say(f"served={s.served} prefix_hit={s.hit_rate:.0%} prefills={s.prefills} "
        f"swap_ins={s.swap_ins} decode_steps={s.decode_steps} "
        f"replicas={len(srv.replicas)} scale_ups={r.scale_ups} "
        f"avg_response={s.avg_response_s * 1e3:.1f}ms "
        f"win_p50={r.p50_s * 1e3:.1f}ms win_p99={r.p99_s * 1e3:.1f}ms")
    pre, dec = timing["prefill"], timing["decode"]
    perf = {
        "arch": arch, "served": s.served, "prefix_hits": s.prefix_hits,
        "prefills": s.prefills, "decode_steps": s.decode_steps,
        "prefill_ms_per_request": 1e3 * float(np.mean(pre)),
        "prefill_ms_per_request_after_first": 1e3 * float(np.mean(pre[1:] or pre)),
        "decode_ms_per_token": 1e3 * float(np.mean(dec)),
        "decode_ms_per_token_after_first": 1e3 * float(np.mean(dec[1:] or dec)),
        "decode_tokens_per_s": len(dec) / float(np.sum(dec)),
        "stream_tokens_per_s": s.decode_steps / wall,
        "wall_s": wall, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mirror": mirror.stats.snapshot(), "scores": asdict(sc),
        "verify_checks": verify_checks, "launches": launches,
        "swap_ins": s.swap_ins, "mesh": [srv.ctx.dp, srv.ctx.tp],
        "greedy_tokens": torch.cat(tokens).tolist(),
    }
    say(f"serve perf {arch}: " + json.dumps(perf))
    say(f"kernels {arch}: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{arch}: serve checks failed: {bad}")
    shapes = {"flash_attention": (1, 16, 16, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.head_dim),
              "dispatch_scores": (max(1, sc.max_rows), disp._presence.shape[1],
                                  disp._presence.shape[0]),
              "dispatch_score_update": (disp._Sw.shape[0], max(1, sc.max_epoch_keys),
                                        disp._Sw.shape[1])}
    del srv, disp, mirror, sb, sw
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes, perf


# ------------------------------------------------------------------- payload
def _flat(tree):
    """Leaves of a tree in the order the port's checkpointer writes them."""
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def _same_bits(a, b) -> bool:
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _edge_rows(measured, label, card):
    """Print each measured edge; fail unless every edge that touches hbm
    lies under the dram tier's roofline, the H100's host link (PCIe Gen5
    x16, 64 GB/s a direction)."""
    from repro_torch.diffusion.tiers import roofline_tier_bw
    link = roofline_tier_bw("dram")
    rows = measured.rows()
    for r in rows:
        say(f"payload {label} [{card}]: {r['src']}->{r['dst']} moves={r['moves']} "
            f"bytes={r['bytes']:.0f} seconds={r['seconds']:.6f} "
            f"GB/s={r['bytes_per_s'] / 1e9:.3f}")
    bad = [f"{r['src']}->{r['dst']} {r['bytes_per_s'] / 1e9:.3f} GB/s" for r in rows
           if "hbm" in (r["src"], r["dst"])
           and not 0.0 < r["bytes_per_s"] < link]
    if bad:
        fail(f"payload {label}: hbm edges outside (0, {link / 1e9:g}) GB/s: {bad}")
    return rows


def payload_phase(ops, card):
    """internlm2-1.8b at full width served twice on one stream, payload
    modeled then real, with two HBM session slots over eight sessions so
    that sessions are demoted to host memory and swapped back in; then one
    session's cache through every home of a ``RealPayload``.  Returns the
    real server (its params feed the checkpoint phase) and the results."""
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.diffusion.payload import RealPayload
    from repro_torch.runtime.chaos import flip_spill_byte
    from repro_torch.runtime.serve_loop import DiffusionServer

    cfg = get_arch("internlm2-1.8b")
    runs = {}
    for payload in ("modeled", "real"):
        srv = None                      # the modeled run's model goes first
        gc.collect()
        torch.cuda.empty_cache()
        srv = DiffusionServer(cfg, device="cuda", dispatcher_impl="vectorized",
                              batch_drain=True, seed=0, max_replicas=1,
                              min_replicas=1, max_sessions=2,
                              host_cache_sessions=8, cache_cap=128,
                              payload=payload)
        srv.router.assignment_log = []
        tokens = []
        decode = srv.decode_fn

        def recorded(params, batch, decode=decode, tokens=tokens):
            logits, caches = decode(params, batch)
            tokens.append(logits.argmax(-1))
            return logits, caches

        srv.decode_fn = recorded
        wall, launches, checks = drive_stream(srv, 8, 32, ops, f"payload {payload}")
        s = srv.stats
        runs[payload] = {
            "counters": {c: getattr(s, c) for c in SERVE_COUNTERS},
            "log": list(srv.router.assignment_log),
            "tokens": torch.cat(tokens).tolist(), "wall_s": wall,
            "launches": launches, "mirror_checks": checks,
            "mirror_verify": srv.score_mirror.verify()}
        say(f"payload={payload}: served={s.served} prefix_hits={s.prefix_hits} "
            f"prefills={s.prefills} swap_ins={s.swap_ins} "
            f"decode_steps={s.decode_steps} wall={wall:.2f}s "
            f"launches {' '.join(f'{k}={v}' for k, v in launches.items() if v)}")
    m, r = runs["modeled"], runs["real"]
    edges = _edge_rows(srv.measured, "serve real", card)
    checks = {
        "swap_ins > 0": r["counters"]["swap_ins"] > 0,
        "counters equal": r["counters"] == m["counters"],
        "assignment logs equal": r["log"] == m["log"] and len(r["log"]) == 32,
        "greedy tokens equal": r["tokens"] == m["tokens"]
        and len(r["tokens"]) == r["counters"]["decode_steps"],
        "mirror verify": m["mirror_verify"] == 0.0 and r["mirror_verify"] == 0.0,
        "roofline check": srv.measured.check_roofline(10.0) == [],
        "swap-in bandwidth measured": srv.swap_in_bandwidth() > 0.0,
        "edges hbm<->dram measured": {(e["src"], e["dst"]) for e in edges}
        >= {("hbm", "dram"), ("dram", "hbm")},
        **{f"{k} launched": r["launches"][k] > 0 for k in
           ("flash_attention", "dispatch_scores", "dispatch_score_update")},
    }

    # one full-width session cache through every home: hbm -> dram -> disk -> hbm
    (replica,) = srv.replicas.values()
    caches = replica.sessions[sorted(replica.sessions)[0]]["caches"]
    want = [t.clone() for t in _flat(caches)]
    nbytes = sum(t.numel() * t.element_size() for t in want)
    chunk = 4 << 20
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spill_") as spill:
        p = RealPayload("roundtrip", spill_dir=spill, chunk_bytes=chunk,
                        device="cuda")
        p.put("kv:rt", caches, "hbm")
        chunks = []
        for tier in ("dram", "disk", "hbm"):
            p.moved("kv:rt", tier)
            if tier == "disk":
                chunks = [len(leaf.chunks) for leaf in p._leaves["kv:rt"]]
        got = _flat(p.value("kv:rt"))
        checks["round trip bit-equal on the card"] = len(got) == len(want) and all(
            g.is_cuda and _same_bits(g, w) for g, w in zip(got, want))
        checks["every leaf over more than one chunk"] = bool(chunks) and min(chunks) > 1
        p.dropped("kv:rt")
        checks["spill files freed"] = not any(Path(spill).iterdir())
        rt_edges = _edge_rows(p.measured, "round trip", card)
        checks["round trip edges"] = [(e["src"], e["dst"]) for e in rt_edges] == [
            ("disk", "hbm"), ("dram", "disk"), ("hbm", "dram")]
        for mode in ("raise", "recover"):
            fired = []
            q = RealPayload(f"corrupt_{mode}", spill_dir=spill, chunk_bytes=chunk,
                            device="cuda", corrupt_mode=mode)
            q.on_corruption = fired.append
            q.put("kv:c", caches, "dram")
            q.moved("kv:c", "disk")
            flipped = flip_spill_byte(q, "kv:c")
            if mode == "raise":
                try:
                    q.get("kv:c")
                    caught = False
                except IOError:
                    caught = True
                q.dropped("kv:c")
                checks["raise mode: IOError"] = flipped and caught
            else:
                back = q.get("kv:c")
                checks["recover mode: None, on_corruption once"] = (
                    flipped and back is None and fired == ["kv:c"]
                    and q.corruptions_recovered == 1 and not q.has("kv:c"))
        checks["corrupt spills freed"] = not any(Path(spill).iterdir())
    say(f"payload round trip: {len(want)} leaves, {nbytes} bytes, chunks per "
        f"leaf on disk {chunks}")
    split = swap_in_split(caches, nbytes, card)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"payload checks failed: {bad}")
    result = {"runs": {k: {x: v[x] for x in ("counters", "wall_s", "launches",
                                                 "mirror_checks")}
                       for k, v in runs.items()},
              "serve_edges": edges, "roundtrip_edges": rt_edges,
              "session_cache_bytes": nbytes, "chunks_per_leaf": chunks,
              "swap_in_split": split}
    return srv, result


def swap_in_split(caches, nbytes, card, reps=5):
    """Time a dram->hbm swap-in of one session cache whole (``moved``, its
    mean over ``reps``) and its two steps apart (medians of ``reps``): the
    host copy out of the dram home, and the upload of that copy."""
    import statistics

    import torch
    from repro_torch.diffusion.payload import RealPayload

    p = RealPayload("split", device="cuda")
    p.put("kv:s", caches, "dram")
    t_host, t_up = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = p._to_host("kv:s")
        t1 = time.perf_counter()
        p._to_device(host)
        t_up.append(time.perf_counter() - t1)
        t_host.append(t1 - t0)
        p.moved("kv:s", "hbm")
        p.moved("kv:s", "dram")
    row = next(r for r in p.measured.rows() if (r["src"], r["dst"]) == ("dram", "hbm"))
    p.dropped("kv:s")
    out = {"reps": reps, "bytes": nbytes,
           "host_copy_s": statistics.median(t_host),
           "upload_s": statistics.median(t_up),
           "move_mean_s": row["seconds"] / row["moves"]}
    out["host_copy_share"] = out["host_copy_s"] / (out["host_copy_s"] + out["upload_s"])
    say(f"payload swap-in split [{card}]: host copy "
        f"{nbytes / out['host_copy_s'] / 1e9:.3f} GB/s, upload "
        f"{nbytes / out['upload_s'] / 1e9:.3f} GB/s, whole move "
        f"{nbytes / out['move_mean_s'] / 1e9:.3f} GB/s; host copy share "
        f"{out['host_copy_share']:.3f}")
    return out


# ---------------------------------------------------------------- checkpoint
def checkpoint_phase(params, card):
    """Save ``params`` with the AsyncCheckpointer into a temporary directory,
    restore them onto the card, and hold them bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint

    leaves = _flat(params)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        say(f"checkpoint: {len(leaves)} leaves, {nbytes} bytes; "
            f"{free / 1e9:.1f} GB free under {tempfile.gettempdir()}")
        if free < 1.05 * nbytes:
            fail(f"checkpoint: {nbytes / 1e9:.2f} GB to write, only "
                 f"{free / 1e9:.2f} GB free")
        torch.cuda.synchronize()
        ck = AsyncCheckpointer(d, keep=1)
        t0 = time.perf_counter()
        ck.save(0, params)
        t_snapshot = time.perf_counter() - t0       # copies to host memory
        ck.wait()
        t_save = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        restored = restore_checkpoint(d, 0, params)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        got = _flat(restored)
        exact = len(got) == len(leaves) and all(
            g.is_cuda and _same_bits(g, w) for g, w in zip(got, leaves))
        del restored, got
    finally:
        shutil.rmtree(d, ignore_errors=True)
    result = {"bytes": nbytes, "bytes_on_disk": on_disk,
              "snapshot_s": t_snapshot, "save_s": t_save, "restore_s": t_restore,
              "save_gb_s": nbytes / t_save / 1e9,
              "restore_gb_s": nbytes / t_restore / 1e9}
    say(f"checkpoint [{card}]: " + json.dumps(result))
    if not exact:
        fail("checkpoint: the restored params differ from the saved ones")
    return result


# ------------------------------------------------------------------------ ci
CI_WORKFLOW = ROOT / ".github" / "workflows" / "ci.yml"
CI_STEPS = ("Observability smoke", "Chaos smoke", "Overload smoke")


def ci_scripts():
    """{step: its ``run:`` block from the CI workflow, with the reference
    launcher (``repro.launch.serve``) replaced by the port's}."""
    lines = CI_WORKFLOW.read_text().splitlines()
    out = {}
    for step in CI_STEPS:
        i = next(n for n, l in enumerate(lines)
                 if l.strip().startswith(f"- name: {step}"))
        i = next(n for n in range(i + 1, len(lines))
                 if lines[n].strip() == "run: |")
        indent = len(lines[i + 1]) - len(lines[i + 1].lstrip())
        body = []
        for line in lines[i + 1:]:
            if line.strip() and len(line) - len(line.lstrip()) < indent:
                break
            body.append(line[indent:])
        script = "\n".join(body).strip() + "\n"
        if script.count("python -m repro.launch.serve") != 1:
            fail(f"ci: {step}: expected one reference launcher command")
        out[step] = script.replace("python -m repro.launch.serve",
                                   "python -m repro_torch.launch.serve")
    return out


def ci_phase():
    """The CI workflow's obs, chaos and overload smokes with the port's
    launcher on the card (no ``--device``: the default is cuda), each a
    subprocess in a temporary directory whose ``src`` links to this
    checkout's; their assertion blocks run unchanged."""
    import os
    import shutil
    import tempfile

    results = {}
    for step, script in ci_scripts().items():
        d = Path(tempfile.mkdtemp(prefix="chip_smoke_ci_"))
        try:
            (d / "src").symlink_to(SRC)
            (d / "bin").mkdir()
            shim = d / "bin" / "python"   # the workflow calls "python"
            shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
            shim.chmod(0o755)
            env = {**os.environ, "PATH": f"{d / 'bin'}:{os.environ.get('PATH', '')}"}
            env.pop("PYTHONPATH", None)
            t0 = time.perf_counter()
            out = subprocess.run(
                ["bash", "--noprofile", "--norc", "-eo", "pipefail", "-c", script],
                cwd=d, env=env, capture_output=True, text=True, timeout=600)
            took = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        lines = out.stdout.splitlines()
        shown = [l for l in lines if l.startswith(
            ("served=", "chaos:", "admission:", "scores:"))]
        for line in shown:
            say(f"ci {step}: {line}")
        say(f"ci {step}: rc={out.returncode} in {took:.1f}s")
        if out.returncode != 0:
            tail = "\n".join((out.stdout + out.stderr).splitlines()[-30:])
            fail(f"ci {step}: rc {out.returncode}\n{tail}")
        results[step] = {"seconds": took, "lines": shown}
    return results


# ----------------------------------------------------------------------- train
TRAIN_ARCH = "internlm2-1.8b"
# the reference launcher's own docstring shape; 9 steps write no checkpoint
# (the launcher checkpoints every max(10, steps // 4) steps)
TRAIN_ARGS = ("--arch", TRAIN_ARCH, "--seq", "256", "--batch", "8", "--steps", "9")
# the families whose blocks hold K4, K5 and K6, trained through the
# reference's plain ops; olmoe and rwkv6 at full width with their depth
# cut, recurrentgemma (whose smallest whole group is 2.754 B params) as one
# full-width 'R' block and as the reduced model through the launcher
FAMILY_ARCHS = ("olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-3b")
# depths cut (olmoe from 4, rwkv6 from 16 layers) to keep the script's time
FAMILY_FULL_WIDTH = (("olmoe-1b-7b", 2), ("rwkv6-3b", 4))
FAMILY_TRAIN_STEPS = 6
FAMILY_SEQ, FAMILY_BATCH = 256, 8
RG_TRAIN_ARGS = ("--arch", "recurrentgemma-9b", "--reduced", "--steps", "3")
GUARDED = ("flash_attention", "moe_gmm", "rglru_scan", "rglru_gated_scan", "wkv6",
           "dispatch_scores", "dispatch_score_update")


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _guard_inputs(name, ops):
    """(call, f32 CUDA inputs) of one kernel entry point at a small shape."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(17)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    fn = ops[name]
    if name == "flash_attention":
        return (lambda q, k, v: fn(q, k, v, causal=True),
                [rnd(1, 64, 4, 64), rnd(1, 64, 2, 64), rnd(1, 64, 2, 64)])
    if name == "moe_gmm":
        return fn, [rnd(4, 8, 64), rnd(4, 64, 32)]
    if name == "rglru_scan":
        return fn, [torch.sigmoid(rnd(1, 8, 64)), rnd(1, 8, 64), rnd(1, 64)]
    if name == "rglru_gated_scan":
        return fn, [rnd(1, 8, 64), rnd(1, 8, 64), rnd(1, 8, 64), rnd(64), rnd(1, 64)]
    if name == "wkv6":
        return fn, [rnd(1, 8, 2, 64), rnd(1, 8, 2, 64), rnd(1, 8, 2, 64),
                    torch.sigmoid(rnd(1, 8, 2, 64)), rnd(2, 64), rnd(1, 2, 64, 64)]
    if name == "dispatch_scores":
        return fn, [rnd(8, 256), rnd(16, 256)]
    return fn, [rnd(256, 16), rnd(256, 2), rnd(2, 16)]


def grad_guard_check(ops):
    """(a) Each entry point on CUDA inputs that require grad raises before it
    launches; under ``torch.no_grad()`` it launches once and matches its plain
    version (the wrapper on CPU copies) within 1e-4 relative."""
    import torch
    rows = {}
    for name in GUARDED:
        fn, xs = _guard_inputs(name, ops)
        before = ops[name].launches
        try:
            with torch.enable_grad():
                fn(*[x.clone().requires_grad_(True) for x in xs])
        except RuntimeError as e:
            if "no backward" not in str(e):
                fail(f"train guard {name}: unexpected error {e}")
        else:
            fail(f"train guard {name}: launched on inputs that require grad")
        if ops[name].launches != before:
            fail(f"train guard {name}: counted a launch it refused")
        with torch.no_grad():
            got = _first(fn(*[x.clone().requires_grad_(True) for x in xs]))
        torch.cuda.synchronize()
        if ops[name].launches != before + 1:
            fail(f"train guard {name}: no launch under torch.no_grad()")
        rows[name] = rel_err(got.cpu(), _first(fn(*[x.cpu() for x in xs])))
        if not rows[name] < 1e-4:
            fail(f"train guard {name}: rel. err {rows[name]} >= 1e-4 under no_grad")
    return rows


def _l2_rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


# Card-vs-CPU limits of one train step: grads and first moments (L2), the
# share of params within one bf16 ulp.  rwkv6 rounds the cotangent of its
# WKV output to bf16 (the gate product before ``wo``), and the grads of u
# and of decay_b are then small sums of large f32 terms: card vs CPU they
# part by 2.03e-2 (u, L2), and 2.4% of decay_b's elements take opposite
# grad signs (97.6% within one ulp); the port against the JAX reference on
# the CPU, at equal params, parts by 1.9e-2 on u.  rwkv6 is held to the
# cross-implementation grad limit of the lm tests (3e-2 L2) and 97%.
STEP_LIMITS = {"grads": 2e-2, "m": 2e-2, "within_ulp": 0.98}
STEP_LIMITS_BY_ARCH = {"rwkv6-3b": {"grads": 3e-2, "m": 3e-2, "within_ulp": 0.97}}


def train_step_check(arch, ops):
    """(b) One ``make_train_step`` on the card and on the CPU from the same
    params and pipeline tokens (reduced ``arch``; lr 1e-2 at schedule scale 1,
    so every bf16 param moves by many ulps).  Held to the CPU within 2e-2:
    the loss, the grad norm and each leaf's grads and first moment (L2).
    Each leaf's update on the card is held within 2e-2 (L2) to the AdamW
    update computed on the CPU from the card's own moments: AdamW's first
    update is close to lr * sign(g), so where card and CPU grads are near 0
    with opposite signs the two steps move an element apart by 2 lr, which
    says nothing about the update.  Against the CPU's step, at least 98% of
    each leaf's elements lie within one bf16 ulp, and all within 2 lr plus
    one ulp of the larger of the two (``STEP_LIMITS``, rwkv6's in
    ``STEP_LIMITS_BY_ARCH``).  No kernel launches: the train route
    reaches none.  A MoE config routes on the card as the CPU did
    (``RoutingReplay``; the router runs again in each group's recompute, in
    the same order on both devices), and a choice of its own that differs
    must be a tie."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DiffusionDataPipeline, PipelineConfig
    from repro_torch.models import init_opt_state, init_params, make_loss_fn, make_train_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_unflatten
    cfg = get_arch(arch).reduced()
    S, B = 64, 4
    shape = ShapeConfig("t", "train", S, B)
    pipe = DiffusionDataPipeline(PipelineConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                                global_batch=B, seed=0), num_hosts=2)
    tokens = torch.as_tensor(pipe.next_batch()[0][:, :S], dtype=torch.long)
    opt = AdamWConfig(lr=1e-2)
    step = make_train_step(cfg, shape, opt, total_steps=1, microbatches=1)
    loss_fn = make_loss_fn(cfg, shape)
    cpu = init_params(cfg, device="cpu", seed=5)
    paths, cpu_leaves, _ = tree_flatten_with_paths(cpu)
    p0 = [t.float() for t in cpu_leaves]
    dtypes = [t.dtype for t in cpu_leaves]
    res = {}
    with RoutingReplay(moe_mod) as replay:
        for dev in ("cpu", "cuda"):
            replay.mode = "record" if dev == "cpu" else "replay"
            params = _to(cpu, dev)
            batch = {"tokens": tokens.to(dev)}
            _zero(ops)
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            loss, _ = loss_fn(tree_unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
            new_p, new_o, metrics = step(params, init_opt_state(params, cfg), batch)
            if dev == "cuda":
                torch.cuda.synchronize()
            res[dev] = {"loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "grads": [g.float().cpu() for g in grads],
                        "params": [t.float().cpu() for t in tree_leaves(new_p)],
                        "m": [t.cpu() for t in tree_leaves(new_o["m"])],
                        "v": [t.cpu() for t in tree_leaves(new_o["v"])],
                        "launches": {k: fn.launches for k, fn in ops.items()
                                     if fn.launches}}
    c, h = res["cuda"], res["cpu"]
    lr = opt.lr * float(cosine_schedule(torch.tensor(1), warmup=1, total=1))
    b1c = 1.0 - torch.tensor(opt.b1, dtype=torch.float32)
    b2c = 1.0 - torch.tensor(opt.b2, dtype=torch.float32)
    upd_err, grad_err, m_err, within_ulp, excess = [], [], [], [], []
    for p, dt, m, v, pc, ph, gc, gh, mh in zip(p0, dtypes, c["m"], c["v"], c["params"],
                                               h["params"], c["grads"], h["grads"], h["m"]):
        # rounded to the leaf's own type (f32 leaves: the RG-LRU's lam,
        # RWKV6's w0, decay_b and u, the MoE router)
        want = (p - lr * ((m / b1c) / (torch.sqrt(v / b2c) + opt.eps)
                          + opt.weight_decay * p)).to(dt).float()
        upd_err.append(_l2_rel(pc - p, want - p))
        grad_err.append(_l2_rel(gc, gh))
        m_err.append(_l2_rel(m, mh))
        ulp = torch.from_numpy(np.spacing(ph.abs().numpy())) * 65536.0
        ulp_max = torch.from_numpy(np.spacing(torch.maximum(pc.abs(), ph.abs()).numpy())) \
            * 65536.0
        diff = (pc - ph).abs()
        within_ulp.append(float((diff <= ulp).double().mean()))
        # before rounding the two differ by at most 2 lr (|update| <= lr at
        # step 1); each bf16 rounding adds at most half an ulp of its value
        excess.append(float((diff - ulp_max).max()) / lr)
    row = {"arch": arch, "loss": [c["loss"], h["loss"]],
           "grad_norm": [c["grad_norm"], h["grad_norm"]],
           "loss_rel_err": abs(c["loss"] - h["loss"]) / abs(h["loss"]),
           "grad_norm_rel_err": abs(c["grad_norm"] - h["grad_norm"]) / h["grad_norm"],
           "worst_grad_l2": max(grad_err), "worst_m_l2": max(m_err),
           "worst_update_l2": max(upd_err), "min_within_ulp": min(within_ulp),
           "max_excess_over_lr": max(excess),
           "worst_leaves": {k: paths[max(range(len(v)), key=lambda i: sgn * v[i])]
                            for k, v, sgn in (("grad_l2", grad_err, 1), ("m_l2", m_err, 1),
                                              ("update_l2", upd_err, 1),
                                              ("within_ulp", within_ulp, -1))},
           "kernel_launches": c["launches"],
           "router_calls": replay.i, "routing_flips_at_ties": len(replay.flips),
           "leaves": len(p0)}
    lim = row["limits"] = {**STEP_LIMITS, **STEP_LIMITS_BY_ARCH.get(arch, {})}
    say(f"train step {arch} reduced (card vs cpu): " + json.dumps(row))
    finite = all(bool(torch.isfinite(t).all()) for t in c["params"] + c["grads"])
    problems = [k for k, ok in (
        ("finite", finite and np.isfinite(c["loss"])),
        ("loss", row["loss_rel_err"] < 2e-2),
        ("grad_norm", row["grad_norm_rel_err"] < 2e-2),
        ("grads", row["worst_grad_l2"] < lim["grads"]),
        ("m", row["worst_m_l2"] < lim["m"]),
        ("update", row["worst_update_l2"] < 2e-2),
        ("params within one ulp", row["min_within_ulp"] >= lim["within_ulp"]),
        ("params within 2 lr + one ulp", row["max_excess_over_lr"] <= 2.0),
        ("no kernel launch", not c["launches"]),
        ("router calls replayed", replay.i == len(replay.recorded)),
        ("routing flips only at ties",
         all(m < RoutingReplay.TIE for m in replay.flips))) if not ok]
    if problems:
        fail(f"train step {arch}: {problems}")
    return row


def train_full_width(card, args=TRAIN_ARGS, falls=True):
    """(c) ``python -m repro_torch.launch.train`` at full width on the card,
    in a subprocess: by default internlm2-1.8b, 9 steps of 8 x 256 tokens.
    Returns its per-step report, the median step ms over steps 4 to the last
    and the positions (tokens; audio frames for an encoder-decoder) a
    second.  ``falls``: the mean loss of the last three steps must be under
    step 1's."""
    import os
    import shutil
    import statistics
    import tempfile

    import numpy as np
    opt = {a: b for a, b in zip(args, args[1:])
           if a.startswith("--") and not b.startswith("--")}
    arch, n = opt["--arch"], int(opt["--steps"])
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, "--ckpt-dir", d]
    try:
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                             capture_output=True, text=True, timeout=900)
        took = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    label = f"train full width {arch}"
    if out.returncode != 0:
        tail = "\n".join((out.stdout + out.stderr).splitlines()[-30:])
        fail(f"{label}: rc {out.returncode}\n{tail}")
    lines = out.stdout.splitlines()
    for line in lines:
        if line.startswith("step "):
            say(f"{label}: {line}")
    if not lines[-1].startswith(f"done: {n} steps"):
        fail(f"{label}: last line {lines[-1]!r}")
    report = json.loads(next(l for l in lines if l.startswith("train: "))[len("train: "):])
    losses, norms, step_ms = report["losses"], report["grad_norms"], report["step_ms"]
    first = 4 if n >= 4 else min(2, n)      # a short run: every step after the first
    med = statistics.median(step_ms[first - 1:n])
    positions = report["seq"] * report["batch"]
    row = {"arch": arch, "seq": report["seq"], "batch": report["batch"],
           "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "median_step_ms": med, f"median_step_ms_{first}_{n}": med,
           "tokens_per_s": positions / (med / 1e3),
           "max_memory_allocated": report["max_memory_allocated"],
           "device_name": report["device_name"], "device": report["device"],
           "mesh": report["mesh"], "adamw_launches": report["adamw_launches"],
           "nvidia_smi": card,
           "command_s": took, "done": lines[-1]}
    say(f"{label} [{card}]: median step {med:.2f} ms over steps {first}-{n}, "
        f"{row['tokens_per_s']:.0f} positions/s, peak "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB allocated; {lines[-1]}")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"{label}: non-finite loss or grad norm {losses} {norms}")
    if len(losses) != n or (falls and not np.mean(losses[-3:]) < losses[0]):
        fail(f"{label}: {len(losses)} losses, or the loss did not fall: {losses}")
    return row


def optimizer_timing(arch):
    """The AdamW update alone at ``arch``'s full width on the card (random
    bf16 grads and f32 moments).  The first call's result is held to the
    plain version (``kernels/adamw/ref.py``), leaf by leaf: p, m and v
    bit-equal to ``adamw_apply_ref``'s given the kernels' clip factor, the
    grad norm within 1e-5 relative of ``global_norm``.  Then CUDA events
    around each of 3 calls, the fused kernels' launches counted over them
    (the counter zeroed just before), and the plain version timed the same
    way.  The bound moves ``ADAMW_BYTES`` a param.  Also each leaf's size,
    for the step's bound (``_step_bound``)."""
    import statistics

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.adamw import ref
    from repro_torch.kernels.adamw.ops import adamw_fused
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_update, global_norm
    from repro_torch.optim.adamw import _schedule
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_map
    cfg = AdamWConfig()
    params = init_params(get_arch(arch), device="cuda", seed=0)
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    rand = lambda p, scale: scale * torch.randn(p.shape, generator=g, device="cuda")
    grads = tree_map(lambda p: rand(p, 1e-3).to(p.dtype), params)
    state = {"m": tree_map(lambda p: rand(p, 1e-4), params),
             "v": tree_map(lambda p: rand(p, 1e-4).square_(), params),
             "step": torch.full((), 4, dtype=torch.int32, device="cuda")}
    paths, leaves, _ = tree_flatten_with_paths(params)
    sizes = {p: t.numel() for p, t in zip(paths, leaves)}
    n = sum(sizes.values())
    tables = -(-len(leaves) // 48)
    ins = [tree_leaves(t) for t in (grads, state["m"], state["v"], params)]
    hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    _, b1c, b2c, lr = _schedule(state, cfg, 1.0)

    new_p, new_s, met = adamw_update(grads, state, params, cfg)
    gnorm = met["grad_norm"]
    clip = ref.clip_factor(gnorm, cfg.grad_clip)
    outs = [tree_leaves(t) for t in (new_p, new_s["m"], new_s["v"])]
    del new_p, new_s
    worst, unequal = 0.0, []
    for i, path in enumerate(paths):
        want = ref.adamw_apply_ref(*([x[i]] for x in ins), clip, b1c, b2c, lr, **hyper)
        for k, (w,) in enumerate(want):
            got = outs[k][i]
            worst = max(worst, float((got.float() - w.float()).abs().max()))
            if not torch.equal(got, w):
                unequal.append(f"{path}.{'pmv'[k]}")
        del want
    del outs
    plain_norm = float(global_norm(grads))
    norm_err = abs(float(gnorm) - plain_norm) / plain_norm

    def timed(fn):
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times

    # the first call above was the kernels' warm-up
    adamw_fused.launches = 0
    times = timed(lambda: adamw_update(grads, state, params, cfg))
    launched = adamw_fused.launches
    plain_call = lambda: ref.adamw_ref(*ins, b1c, b2c, lr, grad_clip=cfg.grad_clip, **hyper)
    plain_call()
    plain = timed(plain_call)
    del params, grads, state, ins
    gc.collect()
    torch.cuda.empty_cache()
    row = {"params": n, "leaves": len(leaves), "sizes": sizes,
           "ms": statistics.median(times), "ms_all": times,
           "plain_ms": statistics.median(plain), "plain_ms_all": plain,
           "library_ms": None, "launches_3_calls": launched,
           "bound_ms": ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": worst, "unequal_leaves": unequal, "grad_norm": float(gnorm),
           "plain_grad_norm": plain_norm, "grad_norm_rel_err": norm_err}
    problems = [k for k, ok in (
        ("p, m and v bit-equal to the plain version's", not unequal),
        ("grad norm within 1e-5 of global_norm", norm_err <= 1e-5),
        (f"{2 * tables} launches a call", launched == 3 * 2 * tables)) if not ok]
    if problems:
        fail(f"train optimizer {arch}: {problems}: "
             + json.dumps({k: v for k, v in row.items() if k != "sizes"}))
    return row


def train_restart_check(ops):
    """(d) The reference test's failure injection on the card: reduced
    internlm2, 20 steps of 4 x 64 tokens, a checkpoint every 5, host1 lost
    at step 12.  One restart, two hosts left, a finite loss, and the state
    the restart restores is the state saved at step 10, bit for bit.  No
    kernel launches."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import FailureInjector, TrainConfig, Trainer
    d = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        tr = Trainer(get_arch(TRAIN_ARCH).reduced(), ShapeConfig("t", "train", 64, 4),
                     TrainConfig(total_steps=20, log_every=100, checkpoint_every=5,
                                 checkpoint_dir=d, num_hosts=3),
                     failure_injector=FailureInjector({12: ["host1"]}), device="cuda")
        saved, restored = {}, []
        save, restore = tr.ckpt.save, tr.restore_or_init

        def saving(step, tree):
            saved[step] = [t.detach().cpu().clone() for t in _flat(tree)]
            save(step, tree)

        def restoring():
            restored.append(restore())
            return restored[-1]

        tr.ckpt.save, tr.restore_or_init = saving, restoring
        before = {k: fn.launches for k, fn in ops.items()}
        t0 = time.perf_counter()
        res = tr.run(start_fresh=True)
        took = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    launched = {k: fn.launches - before[k] for k, fn in ops.items() if fn.launches > before[k]}
    (params, opt, step), = restored
    got = _flat({"params": params, "opt": opt})
    exact = len(got) == len(saved.get(step, [])) and all(
        g.is_cuda and _same_bits(g.cpu(), w) for g, w in zip(got, saved[step]))
    row = {"restarts": res.restarts, "hosts_left": tr.pipeline.num_hosts(),
           "restored_step": step, "opt_step": int(opt["step"]), "saved_steps": sorted(saved),
           "leaves": len(got), "bit_equal": exact, "final_loss": res.final_loss,
           "steps_run": res.steps_run, "kernel_launches": launched, "seconds": took}
    say("train restart (card): " + json.dumps(row))
    ok = (res.restarts == 1 and row["hosts_left"] == 2 and np.isfinite(res.final_loss)
          and step == 10 and row["opt_step"] == 10 and exact and not launched)
    if not ok:
        fail(f"train restart: {row}")
    return row


def _step_bound(leaves, tokens, capacity_rows):
    """The least time of one train step on the card: 8 operations a matmul
    param a token (forward, backward, the group recompute) at the bf16 peak,
    an expert's weights counted on the C rows of its slot in the [E, C, D]
    buffer (``capacity_rows``; E x C rows in all, as the einsums compute
    them) instead of the tokens; plus AdamW's ``ADAMW_BYTES`` a param at
    the memory rate.  ``leaves``: {path: numel};
    matmul params are all but the embedding table and the norm scales."""
    n = sum(leaves.values())
    n_exp = sum(k for p, k in leaves.items() if "experts" in p)
    n_mm = sum(k for p, k in leaves.items()
               if p != "embed" and not p.endswith("scale")) - n_exp
    expert_ops = 8.0 * n_exp * capacity_rows
    ops = 8.0 * n_mm * tokens + expert_ops
    adamw_ms = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
    return {"params": n, "matmul_params": n_mm, "expert_params": n_exp,
            "capacity": capacity_rows, "ops": ops, "expert_ops": expert_ops,
            "expert_ops_f32_ms": expert_ops / PEAK_OPS["f32"] * 1e3,
            "adamw_bound_ms": adamw_ms,
            "bound_ms": ops / PEAK_OPS["bf16"] * 1e3 + adamw_ms}


def train_family_full_width(arch, layers, card, ops, steps=FAMILY_TRAIN_STEPS,
                            ctx=None, keep=None):
    """(b) ``arch`` at full published width with its depth cut to ``layers``,
    trained on the card by the port's ``Trainer`` in this process: 8 x 256
    tokens from the data pipeline, the launcher's AdamW (lr 1e-3), no
    checkpoint.  Finite losses and grad norms, no launch of ``ops``; the
    fused AdamW kernels' launches, two a step a table of 48 leaves (one
    under ``ctx``, where DTensor takes the norm); the median step ms over
    steps 4 to the last, tokens/s, peak memory (under 80 GB) and the step's
    bound.  ``ctx``: under that sharding context (the launcher's ``--mesh
    host``); ``keep``: a dict that receives the last step's params and
    batch."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.adamw.ops import adamw_fused
    from repro_torch.models.moe import capacity
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.tree import tree_flatten_with_paths
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    seq, batch = FAMILY_SEQ, FAMILY_BATCH
    d = tempfile.mkdtemp(prefix="chip_smoke_family_")
    leaves = {}
    try:
        kw = {} if ctx is None else {"ctx": ctx}
        tr = Trainer(cfg, ShapeConfig("train", "train", seq, batch),
                     TrainConfig(total_steps=steps, log_every=steps + 1,
                                 checkpoint_every=steps + 1, checkpoint_dir=d,
                                 opt=AdamWConfig(lr=1e-3)), device="cuda", **kw)
        init = tr.init_state
        if keep is not None:
            step_fn = tr.step_fn

            def keeping(params, opt_state, batch):
                out = step_fn(params, opt_state, batch)
                keep.update(params=out[0], batch=batch)
                return out

            tr.step_fn = keeping

        def counting():
            params, opt_state = init()
            paths, xs, _ = tree_flatten_with_paths(params)
            leaves.update({p: x.numel() for p, x in zip(paths, xs)})
            return params, opt_state

        tr.init_state = counting
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero(ops)
        adamw_fused.launches = 0
        t0 = time.perf_counter()
        res = tr.run(start_fresh=True)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        launched = {k: fn.launches for k, fn in ops.items() if fn.launches}
        adamw_launched = adamw_fused.launches
        peak = torch.cuda.max_memory_allocated()
        del tr
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    tokens = seq * batch
    C = capacity(tokens, cfg.moe_top_k, cfg.num_experts, cfg.capacity_factor) \
        if cfg.num_experts else 0
    bound = _step_bound(leaves, tokens, C)
    step_ms = [x * 1e3 for x in res.step_s]
    med = statistics.median(step_ms[3:])
    row = {"arch": arch, "layers": layers, "of_layers": get_arch(arch).num_layers,
           "seq": seq, "batch": batch, "losses": res.losses,
           "grad_norms": res.grad_norms, "step_ms": step_ms,
           f"median_step_ms_4_{steps}": med, "median_step_ms": med,
           "tokens_per_s": tokens / (med / 1e3), "max_memory_allocated": peak,
           "step_bound_ms": bound["bound_ms"], "bound": bound,
           "kernel_launches": launched, "adamw_launches": adamw_launched,
           "seconds": took, "nvidia_smi": card}
    label = arch if ctx is None else f"{arch} --mesh host {[ctx.dp, ctx.tp]}"
    row["mesh"] = None if ctx is None else [ctx.dp, ctx.tp]
    say(f"train family {label} full width, {layers} of {row['of_layers']} layers "
        f"[{card}]: " + json.dumps(row))
    say(f"train family {label} [{card}]: median step {med:.2f} ms over steps 4-{steps}, "
        f"{row['tokens_per_s']:.0f} tokens/s, peak {peak / 1e9:.2f} GB allocated, "
        f"step bound {bound['bound_ms']:.2f} ms ({bound['ops'] / 1e12:.2f} TFLOP at "
        f"the bf16 peak + AdamW {bound['adamw_bound_ms']:.2f} ms over "
        f"{bound['params']} params)")
    problems = [k for k, ok in (
        ("finite losses and grad norms", len(res.losses) == steps
         and np.isfinite(res.losses).all() and np.isfinite(res.grad_norms).all()),
        ("no kernel launch", not launched),
        ("AdamW launches", adamw_launched == (1 if ctx is not None else 2)
         * len(res.losses) * -(-len(leaves) // 48)),
        ("peak under 80 GB", peak < 80e9)) if not ok]
    if problems:
        fail(f"train family {arch}: {problems}: {row}")
    return row


def _block_grads(cfg, bp, x, cot):
    """An 'R' block in train mode: (out, grads of every param and of x)
    for the loss sum(out * cot)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(bp)]
    xg = x.detach().requires_grad_(True)
    positions = torch.arange(x.shape[1], device=x.device)
    out, _, _ = lm.apply_block(tree_unflatten(bp, leaves), "R", xg, cfg=cfg,
                               positions=positions, mode="train")
    grads = torch.autograd.grad((out.float() * cot).sum(), leaves + [xg])
    return out.detach(), grads


def rg_block_check(ops, card):
    """(c) recurrentgemma-9b's 'R' block at full width (d_model 4096,
    rnn_width 4096, MLP at d_ff 12288; random weights from seed 0) forward
    and backward in train mode on the card against the same block on the
    CPU at B = 1, T = 256: output within 2e-2 (max rel.), every grad within
    3e-2 (L2), no kernel launch.  Then timed on the card at the trainer's
    microbatch, B = 4, T = 256: host ms (synchronized) and device ms."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.tree import tree_flatten_with_paths, tree_leaves
    cfg = get_arch("recurrentgemma-9b")
    gen = torch.Generator()
    gen.manual_seed(0)
    bp = lm.block_init(gen, "R", cfg)
    n = sum(t.numel() for t in tree_leaves(bp))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1, 256, cfg.d_model)),
                        dtype=torch.float32).to(torch.bfloat16)
    cot = torch.as_tensor(rng.standard_normal((1, 256, cfg.d_model)), dtype=torch.float32)
    t0 = time.perf_counter()
    out_h, g_h = _block_grads(cfg, bp, x, cot)
    cpu_s = time.perf_counter() - t0
    bp_c = _to(bp, "cuda")
    _zero(ops)
    out_c, g_c = _block_grads(cfg, bp_c, x.cuda(), cot.cuda())
    torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in ops.items() if fn.launches}
    out_err = rel_err(out_c.cpu(), out_h)
    grad_l2 = [_l2_rel(a.float().cpu(), b.float()) for a, b in zip(g_c, g_h)]
    finite = bool(torch.isfinite(out_c).all()) and all(
        bool(torch.isfinite(g).all()) for g in g_c)
    # the trainer's microbatch: 4 sequences of 256 tokens
    xb = torch.randn((4, 256, cfg.d_model), device="cuda").to(torch.bfloat16)
    cb = torch.randn((4, 256, cfg.d_model), device="cuda")

    def fwd_bwd():
        return _block_grads(cfg, bp_c, xb, cb)

    fwd_bwd()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    dev_ms = cuda_ms(fwd_bwd, iters=3, warmup=1)
    paths, xs, _ = tree_flatten_with_paths(bp)
    n_mm = sum(t.numel() for p, t in zip(paths, xs) if not p.endswith("scale"))
    ops_n = 6.0 * n_mm * 4 * 256           # forward and backward, no recompute
    nbytes = 2.0 * 2 * n + 2 * 2 * xb.numel() + 4 * cb.numel()  # params, grads, x, dx, cot
    bound, by = bound_ms(nbytes, ops_n, "bf16")
    row = {"params": n, "out_rel_err": out_err, "worst_grad_l2": max(grad_l2),
           "grad_l2": grad_l2, "kernel_launches": launched, "cpu_s": cpu_s,
           "host_ms_b4": statistics.median(walls), "host_ms_b4_all": walls,
           "device_ms_b4": dev_ms, "bound_ms_b4": bound, "bound_by": by,
           "nvidia_smi": card}
    say(f"train rg block full width [{card}]: " + json.dumps(row))
    del bp_c
    gc.collect()
    torch.cuda.empty_cache()
    problems = [k for k, ok in (("finite", finite), ("out", out_err < 2e-2),
                                ("grads", max(grad_l2) < 3e-2),
                                ("no kernel launch", not launched)) if not ok]
    if problems:
        fail(f"train rg block: {problems}: {row}")
    return row


def train_phase(ops, card):
    """(a) the grad guards, (b) one step card vs CPU for reduced internlm2,
    gemma3, olmoe, recurrentgemma and rwkv6, (c) the launcher at full
    width, the AdamW update timed alone at the same width, (d) a failure
    and restart on the card, (e) olmoe and rwkv6 at full width with cut
    depth, (f) recurrentgemma's 'R' block at full width and the reduced
    model through the launcher."""
    import torch
    out = {"guards": grad_guard_check(ops)}
    say("train guards: every entry point refused grad inputs; no_grad rel. err "
        + json.dumps(out["guards"]))
    out["step"] = [train_step_check(arch, ops) for arch in (TRAIN_ARCH, "gemma3-1b")
                   + FAMILY_ARCHS]
    gc.collect()
    torch.cuda.empty_cache()
    out["full_width"] = train_full_width(card)
    out["optimizer"] = opt = optimizer_timing(TRAIN_ARCH)
    fw = out["full_width"]
    bound = _step_bound(opt.pop("sizes"), fw["seq"] * fw["batch"], 0)
    step_bound = fw["step_bound_ms"] = bound["bound_ms"]
    fw["step_bound_ops"] = bound["ops"]
    fw["optimizer_share"] = opt["ms"] / fw["median_step_ms_4_9"]
    say(f"train optimizer [{card}]: AdamW update {opt['ms']:.2f} ms "
        f"(runs {', '.join(f'{t:.2f}' for t in opt['ms_all'])}; "
        f"{opt['launches_3_calls']} kernel launches in 3 calls), plain version "
        f"{opt['plain_ms']:.2f} ms, over {opt['params']} params in {opt['leaves']} leaves, "
        f"bound {opt['bound_ms']:.2f} ms (bytes); p, m, v bit-equal to the plain "
        f"version's, grad norm rel. err {opt['grad_norm_rel_err']:.2e}; "
        f"{100 * fw['optimizer_share']:.1f}% of the median step; step bound "
        f"{step_bound:.2f} ms ({bound['matmul_params']} matmul params); the launcher's "
        f"{len(fw['losses'])} steps launched the AdamW kernels {fw['adamw_launches']} times")
    if fw["adamw_launches"] != 2 * len(fw["losses"]) * -(-opt["leaves"] // 48):
        fail(f"train full width: {fw['adamw_launches']} AdamW launches in "
             f"{len(fw['losses'])} steps of {opt['leaves']} leaves")
    out["restart"] = train_restart_check(ops)
    out["families"] = [train_family_full_width(arch, layers, card, ops)
                       for arch, layers in FAMILY_FULL_WIDTH]
    out["rg_block"] = rg_block_check(ops, card)
    out["rg_reduced"] = train_full_width(card, RG_TRAIN_ARGS, falls=False)
    return out


# --------------------------------------------------------------------- mesh
MESH_ARCH, MESH_LAYERS = "olmoe-1b-7b", 2
MESH_LAUNCH_ARGS = ("--arch", MESH_ARCH, "--reduced", "--steps", "3", "--mesh", "host")
MESH_FIRST_LOSS_TOL, MESH_LOSS_TOL = 2e-3, 2e-2
TOPK_RATIO = 0.01


def _plain_topk(g, e, k_ratio):
    """``topk_compress`` of one leaf the plain way: the k-th largest
    magnitude read off a full descending sort."""
    import torch
    acc = g.float() + e
    flat = torch.abs(acc).reshape(-1)
    k = max(1, int(flat.numel() * k_ratio))
    thresh = torch.sort(flat, descending=True).values[k - 1]
    mask = torch.abs(acc) >= thresh
    zero = torch.zeros((), device=acc.device)
    return torch.where(mask, acc, zero).to(g.dtype), torch.where(mask, zero, acc)


def _plain_int8_mean(g):
    """``compressed_psum`` of one leaf over one rank, the plain way: the
    leaf's int8 codes times its scale (half to even, clipped at 127).
    Returns (that mean in g's dtype, in f32, the scale)."""
    import torch
    scale = (torch.clamp(g.abs().max(), min=1e-12) / 127.0).float()
    mean = torch.clamp(torch.round(g.float() / scale), -127, 127) * scale
    return mean.to(g.dtype), mean, scale


def dtensor_guard_check(ops, ctx):
    """Each kernel entry point given DTensor operands on the card raises
    before it launches (a kernel would read the local shard alone)."""
    import torch
    from repro_torch.models.sharding import P, distribute
    for name in GUARDED:
        fn, xs = _guard_inputs(name, ops)
        before = ops[name].launches
        try:
            with torch.no_grad():
                fn(*[distribute(ctx, x, P(*[None] * x.ndim)) for x in xs])
        except TypeError as e:
            if "DTensor" not in str(e):
                fail(f"mesh guard {name}: unexpected error {e}")
        else:
            fail(f"mesh guard {name}: launched on DTensor operands")
        if ops[name].launches != before:
            fail(f"mesh guard {name}: counted a launch it refused")
    return sorted(GUARDED)


def mesh_phase(ops, card, none_row):
    """(a) ``--mesh host`` at world size 1 over NCCL: olmoe-1b-7b at full
    width, 2 of 16 layers, trained 6 steps by the ``Trainer`` under
    ``make_ctx(make_host_mesh())`` with the seed, tokens and optimizer of
    the train phase's ``--mesh none`` run of the same configuration
    (``none_row``): every MoE layer through ``moe_ffn_sharded`` and none
    through ``moe_ffn``, the first loss within 2e-3 of ``none_row``'s and
    every later one within 2e-2 (bf16 steps drift apart), no launch of the
    model's kernels, the AdamW update kernel once a step on the local shards;
    median step ms, tokens/s and peak GB beside ``none_row``'s.  (b)
    ``topk_compress`` and ``compressed_psum`` (world 1, NCCL) on that run's
    full-width grad tree against their plain forms: every leaf of the sent
    grads and residuals bit-equal, the mean bit-equal to the dequantized
    codes and within scale / 2 of the grads; each one's ms.  (c) the
    trained params saved as DTensors and restored under ``shardings=`` on
    the card, bit-exact.  (d) every kernel entry point refuses DTensor
    operands.  (e) ``python -m repro_torch.launch.train --mesh host`` on
    reduced olmoe with ``--device`` left at its default: on the card, on a
    (1, 1) mesh."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    from repro_torch.models import lm, make_loss_fn
    from repro_torch.models.sharding import full, local, tree_shardings
    from repro_torch.runtime import compressed_psum, init_error_state, topk_compress
    from repro_torch.tree import tree_leaves, tree_unflatten
    gc.collect()
    torch.cuda.empty_cache()
    started = init_process_group("cuda")
    if not started or dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        fail("mesh: wanted a fresh NCCL process group of one rank")
    calls = {"moe_ffn_sharded": 0, "moe_ffn": 0}

    def counting(name):
        fn = getattr(lm, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return fn, wrapped

    real = {}
    for name in calls:
        real[name], wrapped = counting(name)
        setattr(lm, name, wrapped)
    out = {}
    try:
        ctx = make_ctx(make_host_mesh())
        keep = {}
        try:
            row = train_family_full_width(MESH_ARCH, MESH_LAYERS, card, ops, ctx=ctx,
                                          keep=keep)
        finally:
            for name, fn in real.items():
                setattr(lm, name, fn)
        want_calls = 2 * MESH_LAYERS * FAMILY_TRAIN_STEPS   # forward + recompute
        d_first = abs(row["losses"][0] - none_row["losses"][0])
        d_later = max(abs(a - b) for a, b in zip(row["losses"][1:],
                                                 none_row["losses"][1:]))
        cmp = {"mesh": row["mesh"], "calls": dict(calls), "want_sharded_calls": want_calls,
               "first_loss_diff": d_first, "later_loss_diff_max": d_later,
               "losses": row["losses"], "none_losses": none_row["losses"],
               "median_step_ms": row["median_step_ms"],
               "none_median_step_ms": none_row["median_step_ms"],
               "tokens_per_s": row["tokens_per_s"],
               "none_tokens_per_s": none_row["tokens_per_s"],
               "peak_gb": row["max_memory_allocated"] / 1e9,
               "none_peak_gb": none_row["max_memory_allocated"] / 1e9,
               "adamw_launches": row["adamw_launches"],
               "none_adamw_launches": none_row["adamw_launches"],
               "step_ms": row["step_ms"], "nvidia_smi": card}
        out["train"] = cmp
        say(f"mesh train {MESH_ARCH} [{card}]: " + json.dumps(cmp))
        say(f"mesh train {MESH_ARCH} [{card}]: --mesh host {row['mesh']} median step "
            f"{row['median_step_ms']:.2f} ms vs --mesh none "
            f"{none_row['median_step_ms']:.2f} ms ("
            f"{row['median_step_ms'] / none_row['median_step_ms']:.3f}x), "
            f"{row['tokens_per_s']:.0f} vs {none_row['tokens_per_s']:.0f} tokens/s, "
            f"peak {cmp['peak_gb']:.2f} vs {cmp['none_peak_gb']:.2f} GB")
        problems = [k for k, ok in (
            ("every MoE layer through moe_ffn_sharded",
             calls["moe_ffn_sharded"] == want_calls and calls["moe_ffn"] == 0),
            (f"first loss within {MESH_FIRST_LOSS_TOL}", d_first < MESH_FIRST_LOSS_TOL),
            (f"later losses within {MESH_LOSS_TOL}", d_later < MESH_LOSS_TOL),
            ("a (1, 1) mesh", row["mesh"] == [1, 1])) if not ok]
        if problems:
            fail(f"mesh train: {problems}: {cmp}")

        # (b) one more grad tree at the last step's params and batch
        cfg = dataclasses.replace(get_arch(MESH_ARCH), num_layers=MESH_LAYERS)
        loss_fn = make_loss_fn(cfg, ShapeConfig("train", "train", 256, 8), ctx=ctx)
        params = keep.pop("params")
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad(), ctx.scope():
            loss, _ = loss_fn(tree_unflatten(params, leaves), keep.pop("batch"))
            grads = torch.autograd.grad(loss, leaves)
        grads = [local(g) for g in grads]
        del leaves, loss
        err = init_error_state(grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sent, resid = topk_compress(grads, err, TOPK_RATIO)
        torch.cuda.synchronize()
        topk_ms = (time.perf_counter() - t0) * 1e3
        same = True
        for g, e, s1, r1 in zip(grads, err, sent, resid):
            s2, r2 = _plain_topk(g, e, TOPK_RATIO)
            same &= torch.equal(s1, s2) and torch.equal(r1, r2)
            del s2, r2
        del sent, resid, err
        pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean = compressed_psum(grads, pod, axis="pod")
        torch.cuda.synchronize()
        psum_ms = (time.perf_counter() - t0) * 1e3
        psum_same, worst = True, 0.0
        for g, m in zip(grads, mean):
            m2, m32, scale = _plain_int8_mean(g)
            psum_same &= torch.equal(m, m2)
            # the codes' bound, before the mean is rounded to the leaf's dtype
            worst = max(worst, float((m32 - g.float()).abs().max() / scale))
        n = sum(g.numel() for g in grads)
        comp = {"leaves": len(grads), "elements": n, "k_ratio": TOPK_RATIO,
                "topk_ms": topk_ms, "topk_equal": same, "psum_ms": psum_ms,
                "psum_equal": psum_same, "psum_err_over_scale": worst,
                "nvidia_smi": card}
        out["compression"] = comp
        say(f"mesh compression [{card}]: " + json.dumps(comp))
        if not (same and psum_same and worst <= 0.5 + 1e-6):
            fail(f"mesh compression: {comp}")
        del grads, mean
        gc.collect()

        # (c) the trained params through the checkpointer and back under the mesh
        d = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        try:
            t0 = time.perf_counter()
            save_checkpoint(d, FAMILY_TRAIN_STEPS, {"params": params})
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = restore_checkpoint(d, FAMILY_TRAIN_STEPS, {"params": params},
                                      shardings={"params": tree_shardings(ctx, params)})
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
        finally:
            shutil.rmtree(d, ignore_errors=True)
        pairs = list(zip(tree_leaves(params), tree_leaves(back["params"])))
        exact = all(type(b).__name__ == "DTensor" and b.placements == a.placements
                    and local(b).is_cuda and _same_bits(local(a), local(b))
                    for a, b in pairs)
        nbytes = sum(full(a).numel() * full(a).element_size() for a, _ in pairs)
        ck = {"bytes": nbytes, "save_s": t_save, "restore_s": t_restore,
              "exact": exact, "leaves": len(pairs)}
        out["checkpoint"] = ck
        say(f"mesh checkpoint [{card}]: " + json.dumps(ck))
        if not exact:
            fail(f"mesh checkpoint: restore under shardings= not bit-exact: {ck}")
        del params, back, pairs
        out["dtensor_guards"] = dtensor_guard_check(ops, ctx)
        say("mesh guards: every kernel entry point refused DTensor operands: "
            + ", ".join(out["dtensor_guards"]))
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    out["launcher"] = row = train_full_width(card, MESH_LAUNCH_ARGS, falls=False)
    if not (row["mesh"] == [1, 1] and row["device"].startswith("cuda")):
        fail(f"mesh launcher: wanted a (1, 1) mesh on the card: {row}")
    return out


# ------------------------------------------------- encoder-decoder, vision
ENCDEC_ARCH = "whisper-medium"
# 1,024 frames: the reference's attention takes a KV length only if
# attn_chunk(S) divides it, and attn_chunk(1,500) = 1,024 does not divide
# whisper's own 1,500 (K3 is held at 1,500 in the parity phase); the
# reference's text length for them, 128 tokens; decode cap 448, whisper's
# text context
ENCDEC_FRAMES, ENCDEC_CAP, ENCDEC_STEPS = 1024, 448, 32
ENCDEC_TRAIN_ARGS = ("--arch", ENCDEC_ARCH, "--seq", "1024", "--batch", "8",
                     "--steps", "6")
VISION_ARCH = "llava-next-34b"
# full width, depth cut from 60 layers: 60 are 68.8 GB of bf16 params, and
# the f32 draw of the largest leaf alone 35 GB; 8 are 10.9 GB
VISION_LAYERS, VISION_SEQ, VISION_STEPS = 8, 4608, 16


def _zero(ops):
    import torch
    torch.cuda.synchronize()
    for fn in ops.values():
        fn.launches = 0


def _timed_prefill(prefill, params, batch, ops, reps=3):
    """One prefill with the launch counters zeroed just before and read just
    after, then ``reps`` more; host ms of each (synchronized).  Returns
    (logits, caches, launches, ms)."""
    import torch
    _zero(ops)
    t = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    ms = [1e3 * (time.perf_counter() - t)]
    launches = {k: fn.launches for k, fn in ops.items()}
    for _ in range(reps):
        t = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return logits, caches, launches, ms


def _greedy(decode, params, logits, caches, pos, steps, vocab, ops):
    """``steps`` greedy decode steps after ``logits`` from position ``pos``,
    counters zeroed before; host ms of each (synchronized).  Returns
    (tokens, all logits finite, ms, launches)."""
    import torch
    finite = torch.isfinite(logits[..., :vocab]).all()
    tokens, ms = [], []
    _zero(ops)
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1)
        tokens.append(tok)
        t = time.perf_counter()
        logits, caches = decode(params, {"token": tok, "pos": pos + i, "caches": caches})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        finite = finite & torch.isfinite(logits[..., :vocab]).all()
    launches = {k: fn.launches for k, fn in ops.items() if fn.launches}
    return torch.cat(tokens).tolist(), bool(finite), ms, launches


def _frontend_inputs(cfg, n_frames, n_tokens, seed=0):
    """Seeded bf16 frame embeddings [1, n_frames, D] and tokens [1, n_tokens]
    on the card."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    frames = torch.randn((1, n_frames, cfg.d_model), generator=g,
                         device="cuda").to(torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (1, n_tokens), generator=g, device="cuda")
    return frames, tokens


def forward_ops(cfg, B, S, P=0, head_positions=1):
    """Operations (two a multiply-add) of one forward pass at batch B, the
    matmuls and the unmasked (query, key) pairs of attention: whisper over S
    audio frames and its ``text_len(S)`` text tokens, a decoder-only 'A'
    stack over S positions whose first P are projected patches; the LM head
    on ``head_positions`` positions a sequence."""
    from repro_torch.models.encdec import text_len
    d, f, H, Hkv, Dh = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q_o, k_v = 2 * d * H * Dh, 2 * d * Hkv * Dh
    head = d * cfg.padded_vocab * head_positions
    if cfg.encoder_layers:
        St = text_len(S)
        mats = (cfg.encoder_layers * (q_o + k_v + 3 * d * f) * S
                + cfg.decoder_layers * ((2 * q_o + k_v + 3 * d * f) * St + k_v * S))
        pairs = (cfg.encoder_layers * S * S
                 + cfg.decoder_layers * (St * (St + 1) // 2 + St * S))
    else:
        mats = cfg.num_layers * (q_o + k_v + 3 * d * f) * S + d * d * P
        pairs = cfg.num_layers * S * (S + 1) // 2
    return B * (2 * (mats + head) + 4 * Dh * H * pairs)


# the embedding and position tables (a few rows read a step), and what a
# decode step never reads: whisper's encoder, llava's patch projection
_TABLES = ("embed", "pos_embed_enc", "pos_embed_dec")
_NOT_IN_DECODE = _TABLES + ("enc", "enc_norm", "patch_proj")


def _nbytes(tree, skip=()):
    return sum(x.numel() * x.element_size() for k, v in tree.items() if k not in skip
               for x in _flat(v))


def _decode_weight_bytes(params, cfg, batch):
    """The weights a decode step of ``batch`` tokens reads: all but the
    tables and the encoder, and of each MoE layer's experts only the
    min(E, batch x top_k) its tokens route to (K4 reads no other)."""
    from repro_torch.tree import tree_flatten_with_paths
    total = _nbytes(params, _NOT_IN_DECODE)
    if cfg.num_experts:
        paths, leaves, _ = tree_flatten_with_paths(params)
        experts = sum(x.numel() * x.element_size() for p, x in zip(paths, leaves)
                      if "/experts/" in p)
        live = min(cfg.num_experts, batch * cfg.moe_top_k) / cfg.num_experts
        total -= experts * (1.0 - live)
    return total


def _prefill_decode(cfg, batch, seq, new_caches, pos, steps, ops, label):
    """Params from seed 0, a counted and timed prefill of ``batch`` (shape
    seq_len ``seq``), its caches copied into ``new_caches()``, then
    ``steps`` greedy decode steps from ``pos``.  Returns the phase's row,
    with the prefill's bound (its forward operations at the bf16 peak, or
    its weights' bytes) and the decode floor: every weight a step reads
    (``_decode_weight_bytes``) and the whole decode caches, once, at
    3.35 TB/s."""
    import statistics

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import init_params, make_decode_step, make_prefill_step
    from repro_torch.runtime.serve_loop import _merge_prefill_caches
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _flat(params))
    say(f"{label}: init {init_s:.1f}s, {n_params} params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) on the card")
    prefill = make_prefill_step(cfg, ShapeConfig(label, "prefill", seq, 1))
    logits, pre, launches, pre_ms = _timed_prefill(prefill, params, batch, ops)
    caches = _merge_prefill_caches(new_caches(), pre, cfg)
    del pre
    tokens, finite, dec_ms, dec_launches = _greedy(
        make_decode_step(cfg), params, logits, caches, pos, steps, cfg.vocab_size, ops)
    if cfg.encoder_layers:
        fwd = forward_ops(cfg, 1, batch["audio_embeds"].shape[1])
    else:
        P = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
        fwd = forward_ops(cfg, 1, P + batch["tokens"].shape[1], P)
    pre_bound, pre_by = bound_ms(_nbytes(params, _TABLES), fwd, "bf16")
    dec_bytes = _decode_weight_bytes(params, cfg, logits.shape[0]) + _nbytes(caches)
    row = {"arch": cfg.name, "layers": cfg.num_layers or cfg.decoder_layers,
           "params": n_params, "init_s": init_s, "prefill_ms": pre_ms,
           "prefill_ms_median_after_first": statistics.median(pre_ms[1:]),
           "prefill_launches": {k: v for k, v in launches.items() if v},
           "decode_ms": dec_ms,
           "decode_ms_per_token_after_first": statistics.mean(dec_ms[1:]),
           "decode_tokens_per_s": (steps - 1) / (sum(dec_ms[1:]) / 1e3),
           "decode_launches": dec_launches, "greedy_tokens": tokens,
           "finite": finite, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "prefill_ops": fwd, "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
           "decode_bytes_a_step": dec_bytes,
           "decode_floor_ms": dec_bytes / HBM_BYTES_PER_S * 1e3}
    say(f"{label} perf: " + json.dumps(row))
    del params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _report(row, card, label):
    say(f"{label} [{card}]: prefill {row['prefill_ms_median_after_first']:.2f} ms "
        f"(bound {row['prefill_bound_ms']:.3f} ms, {row['prefill_bound_by']}; "
        f"{row['prefill_launches'].get('flash_attention', 0)} K3 launches), decode "
        f"{row['decode_ms_per_token_after_first']:.2f} ms/token "
        f"({row['decode_tokens_per_s']:.1f} tokens/s; floor "
        f"{row['decode_floor_ms']:.3f} ms: {row['decode_bytes_a_step'] / 1e9:.3f} GB a "
        f"step), peak {row['peak_gb']:.2f} GB")


def encdec_phase(ops, card):
    """whisper-medium at full width and depth (24 + 24 layers): a prefill of
    1,024 seeded audio frames and 128 text tokens, which must launch K3 72
    times (the encoder's attention, the decoder's self- and cross-attention
    in each of 24 layer pairs), 32 greedy decode steps against self caches
    of capacity 448 and cross caches of 1,024; then the training launcher
    at 8 x 1,024 frames for 6 steps."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.encdec import encdec_cache_init, text_len
    cfg = get_arch(ENCDEC_ARCH)
    say(f"encdec: {cfg.name} layers={cfg.encoder_layers}+{cfg.decoder_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        f"head_dim={cfg.head_dim} vocab={cfg.vocab_size} "
        f"params={cfg.param_count() / 1e9:.3f}e9 [{card}]")
    St = text_len(ENCDEC_FRAMES)
    audio, tokens = _frontend_inputs(cfg, ENCDEC_FRAMES, St)
    # decode caches: self at whisper's text context, cross at the encoder's
    # length (the API's cache_init sizes both to the cap, as the reference's)
    row = _prefill_decode(
        cfg, {"audio_embeds": audio, "tokens": tokens}, ENCDEC_FRAMES,
        lambda: encdec_cache_init(cfg, 1, ENCDEC_CAP, ENCDEC_FRAMES, device="cuda"),
        St, ENCDEC_STEPS, ops, "encdec")
    want = cfg.encoder_layers + 2 * cfg.decoder_layers
    k3 = row["prefill_launches"].get("flash_attention", 0)
    checks = {f"{want} flash_attention launches a prefill": k3 == want,
              "finite logits": row["finite"],
              "no flash_attention launch in decode":
                  "flash_attention" not in row["decode_launches"]}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"encdec: {bad} (prefill launches {row['prefill_launches']})")
    _report(row, card, "encdec")
    del audio, tokens
    torch.cuda.empty_cache()
    row["train"] = tr = train_full_width(card, ENCDEC_TRAIN_ARGS, falls=False)
    # the step's bound: forward, backward (twice the forward) and the layer
    # recompute at the bf16 peak, plus AdamW's 22 bytes a param (read g, p,
    # m, v; write p, m, v)
    step_ops = 4 * forward_ops(cfg, tr["batch"], tr["seq"],
                               head_positions=text_len(tr["seq"]) - 1)
    tr["step_ops"] = step_ops
    tr["step_bound_ms"] = (step_ops / PEAK_OPS["bf16"]
                           + 22 * row["params"] / HBM_BYTES_PER_S) * 1e3
    say(f"encdec train [{card}]: median step {tr['median_step_ms']:.2f} ms against "
        f"a bound of {tr['step_bound_ms']:.2f} ms ({step_ops / 1e12:.2f} TFLOP and "
        f"AdamW's bytes)")
    return row


def vision_phase(ops, card):
    """llava-next-34b at full width, depth cut to 8 layers: a prefill of
    2,304 seeded patch embeddings (the config's num_patches, which the
    reference's P = min(num_patches, S // 2) gives at S = 4,608) and 2,304
    tokens, one K3 launch a layer, 16 greedy decode steps; then the
    text-only server on the same config (4 sessions, 16 requests)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.models import cache_init
    cfg = replace(get_arch(VISION_ARCH), num_layers=VISION_LAYERS)
    P = min(cfg.num_patches, VISION_SEQ // 2)
    say(f"vision: {cfg.name} layers={cfg.num_layers} (of 60) d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} params={cfg.param_count() / 1e9:.3f}e9 "
        f"patches={P} text={VISION_SEQ - P} [{card}]")
    patches, tokens = _frontend_inputs(cfg, P, VISION_SEQ - P, seed=1)
    row = _prefill_decode(
        cfg, {"patch_embeds": patches, "tokens": tokens}, VISION_SEQ,
        lambda: cache_init(cfg, 1, VISION_SEQ + VISION_STEPS, device="cuda"),
        VISION_SEQ, VISION_STEPS, ops, "vision")
    del patches, tokens
    k3 = row["prefill_launches"].get("flash_attention", 0)
    checks = {f"{VISION_LAYERS} flash_attention launches a prefill": k3 == VISION_LAYERS,
              "finite logits": row["finite"]}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"vision: {bad} (prefill launches {row['prefill_launches']})")
    _report(row, card, "vision")
    launches, _, perf = serve_full_width(VISION_ARCH, 4, 16, ("flash_attention",), ops,
                                         cfg=cfg)
    row["serve"] = perf
    return row


# ------------------------------------------------------------------- gloo4
GLOO4_RANKS = 4
GLOO4_TIMEOUT_S = 420
TESTS = ROOT / "tests"


def gloo4_start():
    """Start the ``sharding`` jobs of ``tests/_torch_sharded_jobs.py`` on 4
    gloo ranks of this machine's CPU, a (2, 2) mesh, with the card hidden
    from them, on inputs the port's own init draws (``make_inputs``).
    Returns the handle ``gloo4_finish`` reads."""
    import os
    import tempfile
    jobs = TESTS / "_torch_sharded_jobs.py"
    if not jobs.is_file():
        fail(f"{jobs} not found: run from a checkout of the repository")
    sys.path.insert(0, str(TESTS))
    import _torch_sharded_jobs as J
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gloo4_"))
    J.make_inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for r in range(GLOO4_RANKS):
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(jobs), str(r), str(GLOO4_RANKS), str(tmp / "store"),
                 str(tmp / "inputs.npz"), str(tmp), "sharding"],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    return {"tmp": tmp, "procs": procs, "t0": time.perf_counter(), "jobs": J}


def gloo4_finish(h, card):
    """Wait for the 4 ranks (every one stopped on a failure or at the time
    limit), then hold their results to the port on one device."""
    import shutil

    import numpy as np
    import torch
    tmp, procs = h["tmp"], h["procs"]
    deadline = h["t0"] + GLOO4_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
        late = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if late or bad:
            tails = "\n".join(f"--- rank {r}:\n" + (tmp / f"rank{r}.log").read_text()[-2500:]
                              for r in sorted(set(bad) | set(late)))
            fail(f"gloo4: ranks {late} still running after {GLOO4_TIMEOUT_S} s, "
                 f"ranks {bad} failed\n{tails}")
        wall = time.perf_counter() - h["t0"]
        out = dict(np.load(tmp / "result.npz"))
        flags = json.loads((tmp / "flags.json").read_text())
        checks = h["jobs"].port_checks(out, flags)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    row = {"torch": torch.__version__, "ranks": GLOO4_RANKS, "mesh": [2, 2],
           "wall_s": wall, "job_seconds": flags.get("seconds"),
           "checks": len(checks), "failed": [k for k, ok in checks.items() if not ok],
           "serve": {a: {k: v for k, v in flags[f"serve/{a}"]["modeled"].items()
                         if k != "tokens"} for a in h["jobs"].SERVE_ARCHS}}
    say(f"gloo4 [{card}] torch {torch.__version__}: " + json.dumps(row))
    if row["failed"]:
        fail(f"gloo4: checks failed: {row['failed']}")
    return row


# ------------------------------------------------------------------ dryrun
# cells laid out per rank where the reference's compiled step splits them:
# gemma3-1b's prefill and llama3.2-3b's decode, whose query heads do not
# divide over 'tp' (each rank attends its own S / 16 query rows, or its own
# cap / 16 cache slots), and olmoe-1b-7b's decode (each rank's block of the
# MoE capacity buffer); their per-device matmul flops as torch 2.13 counts
# them on a CPU host, which this machine's torch must count too; and the
# two train cells, as this script's own first run counted them here
# (torch 2.11; their reduced cells are held to torch 2.13 below)
DRYRUN_DOT_FLOPS = {("gemma3-1b", "prefill_32k"): 20_009_791_258_624.0,
                    ("olmoe-1b-7b", "decode_32k"): 4_667_211_776.0,
                    ("llama3.2-3b", "decode_32k"): 8_850_505_728.0,
                    ("internlm2-1.8b", "train_4k"): 67_143_695_597_568.0,
                    ("rwkv6-3b", "train_4k"): 98_010_147_061_760.0}
# reduced cells on a fake (2, 2) mesh whose per-device matmul flops torch
# 2.13 counts on a CPU host equal to the reference's compiled step's (the
# attention output product, rwkv6's mix LoRA and WKV, whisper's MLP):
# this machine's torch must count them too
DRYRUN_REDUCED_DOT_FLOPS = {("internlm2-1.8b", "train_4k"): 52_297_728.0,
                            ("rwkv6-3b", "train_4k"): 80_347_136.0,
                            ("whisper-medium", "train_4k"): 28_377_088.0,
                            ("rwkv6-3b", "prefill_32k"): 18_120_704.0,
                            ("whisper-medium", "prefill_32k"): 7_192_576.0}
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                ("rwkv6-3b", "train_4k"), ("gemma3-1b", "prefill_32k"),
                ("llama3.2-3b", "decode_32k"))
DRYRUN_TIMEOUT_S = 600
DECODE_CAP, DECODE_POS = 128, 16        # the serve phase's cache, a short prompt
COST_FLOPS_BAND, COST_MEMORY_BAND = (0.8, 1.5), (0.5, 2.0)
# the trip-counted trace of the train phase's rwkv6-3b step against the same
# step with every step of its loops over time run: matmul flops equal, the
# other counts within TRIP_TOL, the peak within TRIP_PEAK_TOL
TRIP_ARCH, TRIP_TOL, TRIP_PEAK_TOL = "rwkv6-3b", 0.01, 0.05


def dryrun_start():
    """(a) ``repro_torch.launch.dryrun``'s ``main`` on the production cells
    (16 x 16 fake ranks of this machine's torch, the card hidden), then (b)'s
    ``trip_count_readings`` (no card either), in one process at a lower
    priority, started beside the build.  Returns the handle
    ``dryrun_finish`` reads."""
    import os
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
           "CUDA_VISIBLE_DEVICES": ""}
    layers = dict(FAMILY_FULL_WIDTH)[TRIP_ARCH]
    code = ("import json, os, sys\n"
            "os.nice(10)\n"
            "from repro_torch.launch.dryrun import main\n"
            f"for arch, shape in {DRYRUN_CELLS!r}:\n"
            "    main(['--arch', arch, '--shape', shape, '--out', sys.argv[1]])\n"
            "import chip_smoke\n"
            "red = chip_smoke.reduced_dot_flops()\n"
            "open(os.path.join(sys.argv[1], 'reduced.json'), 'w').write(json.dumps(red))\n"
            f"trip = chip_smoke.trip_count_readings({layers}, {FAMILY_SEQ}, {FAMILY_BATCH})\n"
            "open(os.path.join(sys.argv[1], 'trips.json'), 'w').write(json.dumps(trip))\n")
    with open(tmp / "dryrun.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", code, str(tmp)], stdout=log,
                                stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return {"tmp": tmp, "proc": proc, "t0": time.perf_counter()}


def _dryrun_cells(h, card):
    """(the production cells' rows, the trip-count readings)."""
    import shutil
    tmp, proc = h["tmp"], h["proc"]
    rows = []
    try:
        try:
            proc.wait(timeout=max(1.0, h["t0"] + DRYRUN_TIMEOUT_S - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        for arch, shape in DRYRUN_CELLS:
            tag = f"{arch}_{shape}_sp".replace(".", "_")
            path = tmp / f"{tag}.json"
            res = json.loads(path.read_text()) if path.exists() else {"ok": False}
            if not res.get("ok"):
                log = (tmp / "dryrun.log").read_text()[-2500:]
                fail(f"dryrun {arch} x {shape}: rc {proc.returncode}, "
                     f"{res.get('error', 'no result')}\n{log}")
            t, hlo = res["roofline_terms_s"], res["hlo_analysis"]
            row = {"arch": arch, "shape": shape, "mesh": res["mesh"],
                   "trace_s": res["trace_s"], "ops": res["ops"], "terms_s": t,
                   "dominant_term": res["dominant_term"],
                   "peak_device_gib": res["memory"]["peak_device_gib"],
                   "collective_count": hlo["collective_count"],
                   "collective_bytes": hlo["total_collective_bytes"],
                   "dot_flops": hlo["dot_flops"], "bytes": hlo["bytes"],
                   "useful_flops_ratio": res["useful_flops_ratio"]}
            say(f"dryrun {arch} x {shape} @ {res['mesh']} (fake ranks, {card}): "
                + json.dumps(row))
            want = DRYRUN_DOT_FLOPS.get((arch, shape))
            if want is not None and not math.isclose(row["dot_flops"], want,
                                                     rel_tol=1e-9):
                fail(f"dryrun {arch} x {shape}: matmul flops {row['dot_flops']}, "
                     f"DRYRUN_DOT_FLOPS {want}")
            rows.append(row)
        if proc.returncode != 0 or not (tmp / "trips.json").exists():
            fail(f"dryrun: rc {proc.returncode}\n{(tmp / 'dryrun.log').read_text()[-2500:]}")
        reduced = json.loads((tmp / "reduced.json").read_text())
        say(f"dryrun reduced cells @ 2x2 (fake ranks, {card}): " + json.dumps(reduced))
        bad = {k: (v, DRYRUN_REDUCED_DOT_FLOPS[tuple(k.split("|"))])
               for k, v in reduced.items() if v != DRYRUN_REDUCED_DOT_FLOPS[tuple(k.split("|"))]}
        if bad:
            fail(f"dryrun reduced cells: matmul flops (this torch, torch 2.13): {bad}")
        trip = json.loads((tmp / "trips.json").read_text())
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    return rows, trip


def reduced_dot_flops():
    """The per-device matmul flops of ``DRYRUN_REDUCED_DOT_FLOPS``'s
    reduced cells, each traced on a fake (2, 2) mesh."""
    from repro_torch.launch.dryrun import trace_cell
    return {f"{a}|{s}": trace_cell(a, s, False, reduced=True,
                                   mesh_shape=(2, 2))[-1].total.dot_flops
            for a, s in DRYRUN_REDUCED_DOT_FLOPS}


def cost_model_readings(seq, batch):
    """(b) The cost model at world size 1, no mesh, on FakeTensors: the
    train phase's internlm2-1.8b step (``seq`` x ``batch`` tokens, one
    microbatch, AdamW) and one decode step at batch 1 (cache of
    ``DECODE_CAP``).  Counts, not times; no card needed."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import roofline_terms
    from repro_torch.launch.op_analysis import trace_step
    from repro_torch.models import (cache_init, init_opt_state, make_decode_step,
                                    make_train_step, param_specs)
    from repro_torch.tree import tree_map
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("train", "train", seq, batch)
    with FakeTensorMode():
        params = tree_map(lambda sp: torch.empty(sp.shape, dtype=sp.dtype),
                          param_specs(cfg))
        opt = init_opt_state(params, cfg)
        tokens = torch.empty((batch, seq), dtype=torch.int32)
        caches = cache_init(cfg, 1, DECODE_CAP, device="cpu")
        token = torch.empty((1,), dtype=torch.int32)
    train = trace_step(make_train_step(cfg, shape, microbatches=1), params, opt,
                       {"tokens": tokens}, donate=(0, 1))
    decode = trace_step(make_decode_step(cfg), params,
                        {"token": token, "pos": DECODE_POS, "caches": caches},
                        donate=(1,))
    out = {}
    for name, tr in (("train", train), ("decode", decode)):
        terms = roofline_terms(tr.total, None)
        out[name] = {"dot_flops": tr.total.dot_flops, "bytes": tr.total.bytes,
                     "ops": tr.ops, "trace_s": tr.seconds, "terms_s": terms,
                     "step_time_bound_s": max(terms.values()), "memory": tr.memory}
    out["decode"]["weight_bytes"] = _decode_weight_bytes(params, cfg, 1)
    return out


def trip_count_readings(layers, seq, batch):
    """(b) The train phase's rwkv6-3b step (``layers`` of its depth, ``seq``
    x ``batch`` tokens, the ``Trainer``'s AdamW and one microbatch) on
    FakeTensors at world size 1, traced with its loops over time counted by
    their trip counts and again with every step run."""
    import dataclasses
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.op_analysis import trace_step
    from repro_torch.models import init_opt_state, make_train_step, param_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_arch(TRIP_ARCH), num_layers=layers)
    shape = ShapeConfig("train", "train", seq, batch)
    with FakeTensorMode():
        params = tree_map(lambda sp: torch.empty(sp.shape, dtype=sp.dtype),
                          param_specs(cfg))
        opt = init_opt_state(params, cfg)
        tokens = torch.empty((batch, seq), dtype=torch.long)
    step = make_train_step(cfg, shape, AdamWConfig(lr=1e-3), FAMILY_TRAIN_STEPS,
                           microbatches=1)
    out = {"layers": layers, "seq": seq, "batch": batch}
    for label, counted in (("trips", True), ("every_step", False)):
        tr = trace_step(step, params, opt, {"tokens": tokens}, donate=(0, 1),
                        regions=["wkv_scan"], trip_counts=counted)
        out[label] = {k: getattr(tr.total, k) for k in
                      ("dot_flops", "flops", "transcendentals", "bytes")}
        out[label].update(ops=tr.ops, trace_s=tr.seconds,
                          wkv_scan_flops=tr.regions["wkv_scan"].flops,
                          peak_device_bytes=tr.memory["peak_device_bytes"],
                          eager_peak_bytes=tr.memory["eager_peak_bytes"])
    return out


def dryrun_finish(h, card, train, served):
    """(a) read the three production cells; (b) the cost model's readings
    beside what the card measured in the train and serve phases: matmul
    flops over ``_step_bound``'s operations, the predicted peak over the
    launcher's ``max_memory_allocated``, the bound beside the median step;
    the decode step's bytes over the weights it reads; the rwkv6-3b step
    counted by trip counts against every step run, and against its
    ``_step_bound`` and ``max_memory_allocated``."""
    import torch
    cells, trip = _dryrun_cells(h, card)
    row = {"torch": torch.__version__, "cells": cells}
    fw = train["full_width"]
    cm = cost_model_readings(fw["seq"], fw["batch"])
    tr, dec = cm["train"], cm["decode"]
    ratios = {
        "train_dot_flops_over_step_bound_ops": tr["dot_flops"] / fw["step_bound_ops"],
        "train_eager_peak_over_max_memory_allocated":
            tr["memory"]["eager_peak_bytes"] / fw["max_memory_allocated"],
        "train_peak_device_over_max_memory_allocated":
            tr["memory"]["peak_device_bytes"] / fw["max_memory_allocated"],
        "train_bound_ms": 1e3 * tr["step_time_bound_s"],
        "train_median_step_ms": fw["median_step_ms"],
        "decode_bytes_over_weight_bytes": dec["bytes"] / dec["weight_bytes"],
        "decode_bound_ms": 1e3 * dec["step_time_bound_s"],
        "decode_weight_floor_ms": 1e3 * dec["weight_bytes"] / HBM_BYTES_PER_S,
        "decode_ms_per_token": served[TRAIN_ARCH][2]["decode_ms_per_token"],
    }
    row.update(cost_model=cm, ratios=ratios)
    say(f"dryrun cost model vs card [{card}]: " + json.dumps(ratios))
    say("dryrun cost model readings: " + json.dumps(
        {k: {kk: v[kk] for kk in ("dot_flops", "bytes", "ops", "trace_s", "terms_s")}
         for k, v in cm.items()}))
    checks = (("train flops", ratios["train_dot_flops_over_step_bound_ops"], COST_FLOPS_BAND),
              ("train memory", ratios["train_eager_peak_over_max_memory_allocated"],
               COST_MEMORY_BAND),
              ("decode memory", ratios["decode_bytes_over_weight_bytes"], COST_MEMORY_BAND))
    fam = next(r for r in train["families"] if r["arch"] == TRIP_ARCH)
    if (trip["layers"], trip["seq"], trip["batch"]) != (fam["layers"], fam["seq"],
                                                        fam["batch"]):
        fail(f"dryrun: the traced rwkv6 step {trip} is not the trained one {fam}")
    tc, full = trip["trips"], trip["every_step"]
    trip_ratios = {
        "dot_flops_trips_over_every_step": tc["dot_flops"] / full["dot_flops"],
        **{f"{k}_trips_over_every_step": tc[k] / full[k]
           for k in ("flops", "transcendentals", "bytes")},
        "peak_trips_over_every_step": tc["peak_device_bytes"] / full["peak_device_bytes"],
        "dot_flops_over_step_bound_ops": tc["dot_flops"] / fam["bound"]["ops"],
        "eager_peak_over_max_memory_allocated":
            tc["eager_peak_bytes"] / fam["max_memory_allocated"],
        "ops_run": [tc["ops"], full["ops"]], "trace_s": [tc["trace_s"], full["trace_s"]]}
    row.update(trip_counts=trip, trip_ratios=trip_ratios)
    say(f"dryrun {TRIP_ARCH} step, {fam['layers']} of {fam['of_layers']} layers, "
        f"trip counts vs every step and vs card [{card}]: " + json.dumps(trip_ratios))
    checks += (
        ("rwkv6 dot flops, trips vs every step",
         trip_ratios["dot_flops_trips_over_every_step"], (1.0, 1.0)),
        *((f"rwkv6 {k}, trips vs every step", trip_ratios[f"{k}_trips_over_every_step"],
           (1 - TRIP_TOL, 1 + TRIP_TOL)) for k in ("flops", "transcendentals", "bytes")),
        ("rwkv6 peak, trips vs every step", trip_ratios["peak_trips_over_every_step"],
         (1 - TRIP_PEAK_TOL, 1 + TRIP_PEAK_TOL)),
        ("rwkv6 train flops", trip_ratios["dot_flops_over_step_bound_ops"], COST_FLOPS_BAND),
        ("rwkv6 train memory", trip_ratios["eager_peak_over_max_memory_allocated"],
         COST_MEMORY_BAND))
    bad = [(n, v, b) for n, v, b in checks if not b[0] <= v <= b[1]]
    if bad:
        fail(f"dryrun cost model outside its bands: {bad}")
    return row


# ---------------------------------------------------------------- examples
EXAMPLE_COUNTERS = ("served", "prefix_hit", "prefills", "decode_steps", "replicas")
EXAMPLE_FIRST_LOSS_TOL = 2e-2
EXAMPLE_INIT = ("weights drawn on the CPU and moved to the device, in place of the "
                "Trainer's draw on the card")


def _example(ops, main, device):
    """``main(["--device", device])`` with its printed lines kept: (result,
    lines, kernel launches, seconds)."""
    import contextlib
    import io
    _zero(ops)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(["--device", device])
    took = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in ops.items() if fn.launches}
    return res, buf.getvalue().splitlines(), launched, took


def examples_phase(ops, card):
    """``repro_torch.examples.serve_diffusion`` and ``elastic_failover`` on
    the card, each beside the same run on the CPU in this process: equal
    serving counters for the three policies and flash-attention launches
    on the card; equal scale events, sizing, recovery and elastic events,
    the first loss within ``EXAMPLE_FIRST_LOSS_TOL`` and a finite final
    loss.  The ``Trainer`` draws its weights from a generator on its own
    device, and a CUDA generator's stream is not the CPU's: for the two
    elastic runs it draws them on the CPU and moves them, so both train
    the same weights: on the card this stands in for the ``Trainer``'s own
    draw (``train_loop.init_params``, the name it looks up), which the
    phase's line and result say."""
    import math
    from repro_torch.examples import elastic_failover, serve_diffusion
    from repro_torch.models import init_params
    from repro_torch.runtime import train_loop
    from repro_torch.tree import tree_map
    out = {}
    sd = {dev: _example(ops, serve_diffusion.main, dev) for dev in ("cuda", "cpu")}
    (card_sd, card_lines, card_launch, card_s), (cpu_sd, _, cpu_launch, cpu_s) = \
        sd["cuda"], sd["cpu"]
    counters = {dev: {p: {k: v[p][k] for k in EXAMPLE_COUNTERS} for p in v}
                for dev, v in (("cuda", card_sd), ("cpu", cpu_sd))}
    out["serve_diffusion"] = {"counters": counters["cuda"], "launches": card_launch,
                              "cpu_launches": cpu_launch, "lines": card_lines,
                              "seconds": [card_s, cpu_s]}
    say(f"examples serve_diffusion [{card}]: card {card_s:.1f}s, cpu {cpu_s:.1f}s, "
        f"card launches {json.dumps(card_launch)}; " + json.dumps(counters["cuda"]))
    problems = []
    if counters["cuda"] != counters["cpu"]:
        problems.append(f"serve_diffusion counters differ: {counters}")
    if card_launch.get("flash_attention", 0) <= 0 or cpu_launch:
        problems.append(f"serve_diffusion launches: card {card_launch}, cpu {cpu_launch}")
    def drawn_on_cpu(cfg, device="cuda", seed=0):
        return tree_map(lambda x: x.to(device), init_params(cfg, device="cpu", seed=seed))

    train_loop.init_params = drawn_on_cpu
    try:
        ef = {dev: _example(ops, elastic_failover.main, dev) for dev in ("cuda", "cpu")}
    finally:
        train_loop.init_params = init_params
    card_ef, cpu_ef = ef["cuda"][0], ef["cpu"][0]
    keys = ("scale_up", "sizing", "recovery", "scale_down", "events", "steps_run")
    first = abs(card_ef["losses"][0] - cpu_ef["losses"][0])
    out["elastic_failover"] = {
        "init": EXAMPLE_INIT, "card": card_ef, "cpu_losses": cpu_ef["losses"],
        "first_loss_diff": first,
        "launches": ef["cuda"][2], "lines": ef["cuda"][1],
        "seconds": [ef["cuda"][3], ef["cpu"][3]]}
    say(f"examples elastic_failover [{card}] ({EXAMPLE_INIT}): card "
        f"{ef['cuda'][3]:.1f}s, cpu {ef['cpu'][3]:.1f}s; events {json.dumps({k: card_ef[k] for k in keys})}; "
        f"first loss card {card_ef['losses'][0]:.5f} cpu {cpu_ef['losses'][0]:.5f}; "
        f"final loss card {card_ef['final_loss']:.5f} cpu {cpu_ef['final_loss']:.5f}")
    if any(card_ef[k] != cpu_ef[k] for k in keys):
        problems.append(f"elastic_failover events differ: "
                        f"{[(k, card_ef[k], cpu_ef[k]) for k in keys]}")
    if not first <= EXAMPLE_FIRST_LOSS_TOL:
        problems.append(f"elastic_failover first loss differs by {first}")
    if not math.isfinite(card_ef["final_loss"]):
        problems.append(f"elastic_failover final loss {card_ef['final_loss']}")
    if problems:
        fail("examples: " + "; ".join(problems))
    return out


# -------------------------------------------------------------- mesh_serve
def empty_batch_check(ops):
    """Each kernel entry point given an empty batch on the card (a rank's
    batch shard when dp exceeds the batch) returns an empty result and
    launches nothing."""
    import torch
    z = dict(device="cuda", dtype=torch.bfloat16)
    f = dict(device="cuda", dtype=torch.float32)
    cases = {
        "flash_attention": lambda: ops["flash_attention"](
            torch.zeros((0, 16, 4, 64), **z), torch.zeros((0, 16, 2, 64), **z),
            torch.zeros((0, 16, 2, 64), **z)),
        "moe_gmm": lambda: ops["moe_gmm"](torch.zeros((4, 0, 64), **z),
                                          torch.zeros((4, 64, 32), **z)),
        "rglru_gated_scan": lambda: ops["rglru_gated_scan"](
            *(torch.zeros((0, 3, 64), **z) for _ in range(3)), torch.zeros(64, **f),
            torch.zeros((0, 64), **f)),
        "wkv6": lambda: ops["wkv6"](*(torch.zeros((0, 3, 2, 64), **z) for _ in range(3)),
                                    torch.zeros((0, 3, 2, 64), **f),
                                    torch.zeros((2, 64), **f),
                                    torch.zeros((0, 2, 64, 64), **f)),
    }
    for name, call in cases.items():
        before = {k: fn.launches for k, fn in ops.items()}
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        if any(o.numel() for o in outs) or any(
                fn.launches != before[k] for k, fn in ops.items()):
            fail(f"empty batch: {name} launched or returned data")
    return sorted(cases)


def moe_block_bytes(cfg, tp: int) -> float:
    """Bytes each rank receives a decode token when the MoE layers run on
    each rank's block of the capacity buffer (``moe_ffn`` on DTensors) on
    a (1, tp) mesh: the f32 partial output [1, D] all-reduced over 'tp'
    (2 (tp - 1) / tp of it on a ring), every expert staying in place."""
    return cfg.num_layers * 2 * (tp - 1) / tp * cfg.d_model * 4


def mesh_serve_phase(ops, card, served):
    """The four served families again, at full width on the same streams,
    under ``make_ctx(make_host_mesh())`` at world size 1 over NCCL: the
    params, caches, prompts and tokens are DTensors and every kernel runs on
    the local shards.  Counters, greedy tokens and every kernel's launches
    must equal the unsharded run's (``served``); decode ms/token of both."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_process_group, make_ctx, make_host_mesh
    gc.collect()
    torch.cuda.empty_cache()
    started = init_process_group("cuda")
    if not started or dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        fail("mesh_serve: wanted a fresh NCCL process group of one rank")
    rows = {}
    try:
        ctx = make_ctx(make_host_mesh())
        for arch, sessions, n_req, needs in FAMILIES:
            t0 = time.perf_counter()
            launches, _, perf = serve_full_width(arch, sessions, n_req, needs, ops,
                                                 ctx=ctx)
            base = served[arch][2]
            cmp = {k: (perf[k], base[k]) for k in SERVE_COUNTERS}
            problems = [k for k, (a, b) in cmp.items() if a != b]
            if perf["greedy_tokens"] != base["greedy_tokens"]:
                problems.append("greedy tokens")
            if launches != served[arch][0]:
                problems.append(f"launches {launches} != {served[arch][0]}")
            if perf["mesh"] != [1, 1]:
                problems.append(f"mesh {perf['mesh']}")
            row = {"arch": arch, "mesh": perf["mesh"], "counters": cmp,
                   "tokens_equal": perf["greedy_tokens"] == base["greedy_tokens"],
                   "launches": launches,
                   "decode_ms_per_token_after_first": perf[
                       "decode_ms_per_token_after_first"],
                   "unsharded_decode_ms_per_token_after_first": base[
                       "decode_ms_per_token_after_first"],
                   "prefill_ms_per_request_after_first": perf[
                       "prefill_ms_per_request_after_first"],
                   "unsharded_prefill_ms_per_request_after_first": base[
                       "prefill_ms_per_request_after_first"],
                   "peak_gb": perf["peak_gb"], "unsharded_peak_gb": base["peak_gb"],
                   "seconds": time.perf_counter() - t0, "nvidia_smi": card}
            if get_arch(arch).num_experts:
                row["moe_decode_bytes_per_token_tp2"] = moe_block_bytes(get_arch(arch), 2)
            rows[arch] = row
            say(f"mesh_serve {arch} [{card}]: " + json.dumps(row))
            say(f"mesh_serve {arch}: decode {row['decode_ms_per_token_after_first']:.2f} "
                f"ms/token under the mesh vs "
                f"{row['unsharded_decode_ms_per_token_after_first']:.2f} without")
            if problems:
                fail(f"mesh_serve {arch}: {problems}")
        owner = {"flash_attention": "internlm2-1.8b", "dispatch_scores": "internlm2-1.8b",
                 "dispatch_score_update": "internlm2-1.8b", "moe_gmm": "olmoe-1b-7b",
                 "rglru_scan": "recurrentgemma-9b", "wkv6": "rwkv6-3b"}
        got = {k: rows[a]["launches"][k] for k, a in owner.items()}
        if got != SERVE_LAUNCHES:
            fail(f"mesh_serve launch counts {got}, want {SERVE_LAUNCHES}")
        rows["launches"] = got
        rows["empty_batch"] = empty_batch_check(ops)
        say("mesh_serve: on an empty batch every kernel entry launched nothing: "
            + ", ".join(rows["empty_batch"]))
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------------- archs
# (arch, layers kept: None for all), each a 16-token prefill and 8 greedy
# decode steps against caches of 64
ARCHS_RUN = (("llama3-8b", None), ("llama3.2-3b", None), ("qwen3-moe-235b-a22b", 2))
ARCHS_PROMPT, ARCHS_STEPS, ARCHS_CAP = 16, 8, 64


def archs_phase(ops, card):
    """llama3-8b and llama3.2-3b whole, qwen3-moe-235b-a22b at full width
    with 2 of its 94 layers (all 94 are 470 GB of bf16): a counted 16-token
    prefill (one K3 launch a layer; qwen3 three K4 launches a layer at E =
    128, D = 4,096, F = 1,536), 8 greedy decode steps (qwen3: 3 K4 launches
    a layer a step), finite logits, decode ms/token beside its floor."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import cache_init
    rows = []
    for arch, layers in ARCHS_RUN:
        cfg = get_arch(arch)
        if layers:
            cfg = replace(cfg, num_layers=layers)
        say(f"archs: {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
            f"heads={cfg.num_heads}/{cfg.num_kv_heads} d_ff={cfg.d_ff} "
            f"experts={cfg.num_experts} top_k={cfg.moe_top_k} vocab={cfg.vocab_size} "
            f"params={cfg.param_count() / 1e9:.3f}e9 [{card}]")
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (1, ARCHS_PROMPT), generator=g,
                               device="cuda")
        row = _prefill_decode(cfg, {"tokens": tokens}, ARCHS_CAP,
                              lambda: cache_init(cfg, 1, ARCHS_CAP, device="cuda"),
                              ARCHS_PROMPT, ARCHS_STEPS, ops, f"archs {arch}")
        row["layers_of"] = get_arch(arch).num_layers
        pre, dec = row["prefill_launches"], row["decode_launches"]
        checks = {f"{cfg.num_layers} flash_attention launches a prefill":
                      pre.get("flash_attention", 0) == cfg.num_layers,
                  "no flash_attention launch in decode": "flash_attention" not in dec,
                  "finite logits": row["finite"]}
        if cfg.num_experts:
            checks[f"{3 * cfg.num_layers} moe_gmm launches a prefill"] = (
                pre.get("moe_gmm", 0) == 3 * cfg.num_layers)
            checks[f"{3 * cfg.num_layers * ARCHS_STEPS} moe_gmm launches in decode"] = (
                dec.get("moe_gmm", 0) == 3 * cfg.num_layers * ARCHS_STEPS)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            fail(f"archs {arch}: {bad} (prefill {pre}, decode {dec})")
        _report(row, card, f"archs {arch}")
        rows.append(row)
    return rows


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
    # the CPU ranks and the dry run's fake ranks run beside the build, the
    # parity and the model phases
    gloo = gloo4_start()
    dry = dryrun_start()

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

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models.moe import capacity
    ops = kernel_ops()

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
            ((1, 70, 70, 2, 2, 16), True, 16),
            ((1, 16, 16, 16, 1, 256), True, 2048),     # recurrentgemma prefill
            ((1, 512, 512, 16, 1, 256), True, 2048),
            ((1, 2048, 2048, 16, 1, 256), True, 2048)):
        flash_rows.append(flash_case(shape, causal, window, "bf16",
                                     timed=shape[1] >= 512))
    for shape in ((1, 16, 16, 16, 8, 128), (2, 256, 256, 4, 2, 64),
                  (1, 16, 16, 16, 1, 256)):
        flash_rows.append(flash_case(shape, True, 0, "f32"))
    # the encoder-decoder's and llava's shapes: no mask with Sq != Skv (the
    # aligned-ends offset must not enter), ragged tiles on both axes, seven
    # query heads a KV head; the first, third and last are timed
    for shape, causal, timed in (
            ((1, 1024, 1024, 16, 16, 64), False, True),     # whisper encoder
            ((1, 1500, 1500, 16, 16, 64), False, False),    # 1,500 frames: ragged
            ((1, 128, 1024, 16, 16, 64), False, True),      # cross-attention
            ((1, 187, 1500, 16, 16, 64), False, False),     # ragged cross-attention
            ((1, 4608, 4608, 56, 8, 128), True, True)):     # llava prefill
        flash_rows.append(flash_case(shape, causal, 0, "bf16", timed=timed))
    flash_rows.append(flash_case((2, 100, 300, 4, 4, 64), False, 0, "f32"))
    # latent attention's expanded prefill: qk 192, v 128 and a scale of its
    # own, ragged tiles in f32 (DeepSeek-V2-Lite's 16,384 in phase 13)
    for shape, dtype_name in (((1, 16, 16, 16, 16, 192), "bf16"),
                              ((1, 2048, 2048, 16, 16, 192), "bf16"),
                              ((1, 100, 100, 4, 4, 192), "f32")):
        flash_rows.append(flash_case(shape, True, 0, dtype_name, Dv=128, scale=0.114721))
    for row in flash_rows:
        say("parity flash_attention: " + json.dumps(row))
    # one sequence shard at a time, each at its own query offset; the llava
    # split's last block is timed
    split_rows = [flash_split_case(label, shape, window, shards, timed=i == 0)
                  for i, (label, shape, window, shards) in enumerate(FLASH_SPLITS)]
    for row in split_rows:
        say("parity flash_attention split: " + json.dumps(row))
    for W, O, E, dens in ((16, 64, 4, 0.2), (256, 512, 64, 0.05),
                          (300, 1200, 96, 0.02), (64, 256, 4, 0.2),
                          (8, 256, 16, 0.2), (1, 256, 16, 0.2),     # serving window
                          (8, 1, 16, 0.5), (8, 3, 16, 0.5),         # ragged O
                          (8, 255, 16, 0.2), (8, 1201, 16, 0.05)):
        say("parity dispatch_scores: " + json.dumps(scores_case(W, O, E, dens)))
    for W, K, E in ((16, 3, 4), (256, 128, 64), (300, 200, 96), (64, 8, 4),
                    (256, 2, 16), (256, 2, 5), (256, 2, 17),     # serving, ragged E
                    (256, 1, 16), (256, 33, 16), (256, 128, 16), (256, 64, 64),
                    (1, 2, 16)):
        say("parity dispatch_score_update: " + json.dumps(update_case(W, K, E)))
    z = torch.arange(12.0, device="cuda").reshape(3, 4)
    before = ops["dispatch_score_update"].launches
    same = ops["dispatch_score_update"](z, torch.zeros((3, 0), device="cuda"),
                                        torch.zeros((0, 4), device="cuda"))
    if not torch.equal(same, z) or ops["dispatch_score_update"].launches != before:
        fail("dispatch_score_update with K == 0 must copy and launch nothing")
    olmoe = get_arch("olmoe-1b-7b")
    E, K, D, F = olmoe.num_experts, olmoe.moe_top_k, olmoe.d_model, olmoe.d_ff
    C = capacity(1, K, E, olmoe.capacity_factor)         # 8 at T = 1 and T = 16
    for dt in ("f32", "bf16"):
        for shape in ((2, 128, 256, 128), (4, 256, 512, 256), (8, 128, 128, 512)):
            say("parity moe_gmm: " + json.dumps(gmm_case(*shape, dtype_name=dt)))
    for shape in ((E, C, D, F), (E, C, F, D), (E, 13, D, F)):
        for out_dtype in (torch.float32, None):
            say("parity moe_gmm: " + json.dumps(gmm_case(*shape, out_dtype=out_dtype)))
    # fill counts at olmoe's shapes: one decode token (8 live experts, one row
    # each), a routed prompt (16 tokens at C = 8, 2,048 at C = 320) and full
    decode_fill = routed_counts(1, E, K, C, D)
    for c, tokens in ((C, 16), (13, 64), (320, 2048)):
        fills = (routed_counts(1, E, K, c, D), routed_counts(tokens, E, K, c, D, seed=1))
        for fill in fills:
            for shape, out_dtype in (((E, c, D, F), torch.float32), ((E, c, F, D), None)):
                say("parity moe_gmm counts: " + json.dumps(gmm_case(
                    *shape, out_dtype=out_dtype, counts=fill)))
        say("parity moe_gmm counts: " + json.dumps(gmm_case(
            E, c, D, F, "f32", counts=fills[1])))
        # poisoned weights: NaN in every expert with count 0 and in dead rows
        for fill, dt in ((fills[0], "bf16"), (fills[1], "bf16"), (fills[0], "f32")):
            say("parity moe_gmm poisoned: " + json.dumps(gmm_case(
                E, c, D, F, dt, counts=fill, poison=True)))
    # DeepSeek-V2-Lite's experts: F = 1,408 leaves the last 256-wide tile
    # half full, as the output width (gate, up) and as the reduction (down)
    ds_fill = routed_counts(1, 64, 6, 8, 2048)
    for shape, out_dtype in (((64, 8, 2048, 1408), torch.float32), ((64, 8, 1408, 2048), None),
                             ((64, 200, 2048, 1408), torch.float32),
                             ((64, 200, 1408, 2048), None)):
        say("parity moe_gmm deepseek-v2-lite: " + json.dumps(gmm_case(
            *shape, out_dtype=out_dtype, counts=ds_fill if shape[1] == 8 else None)))
    say("parity moe_gmm deepseek-v2-lite poisoned: " + json.dumps(gmm_case(
        64, 8, 1408, 2048, counts=ds_fill, poison=True)))
    rg = get_arch("recurrentgemma-9b")
    for shape in ((1, 128, 256), (2, 256, 512), (3, 512, 128)):
        for with_h0 in (False, True):
            say("parity rglru_scan: " + json.dumps(rglru_case(*shape, with_h0)))
    for shape in ((2, 17, 300), (1, 1, rg.rnn_width), (1, 16, rg.rnn_width)):
        say("parity rglru_scan: " + json.dumps(rglru_case(*shape)))
    # a 2,048-token prompt (recurrentgemma's window) and 65 steps, whose last
    # group of the 8 steps a thread loads together holds one step
    long = [(1, T, rg.rnn_width) for T in (2048, 65)]
    for shape in long:
        say("parity rglru_scan: " + json.dumps(rglru_case(*shape)))
    for shape in [(1, 1, rg.rnn_width), (1, 16, rg.rnn_width), (2, 17, 300)] + long:
        for dt in ("bf16", "f32"):
            say("parity rglru_gated_scan: " + json.dumps(rglru_gated_case(
                *shape, dtype_name=dt)))
    say("parity rglru_gated_scan: " + json.dumps(rglru_gated_case(
        1, 2048, rg.rnn_width, with_h0=False)))
    rw = get_arch("rwkv6-3b")
    H, N = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    for shape in ((1, 128, 2, 64), (2, 256, 2, 64), (1, 256, 4, 64)):
        say("parity wkv6: " + json.dumps(wkv6_case(*shape)))
    say("parity wkv6: " + json.dumps(wkv6_case(1, 128, 1, 64, decay=0.01)))
    for shape in ((1, 1, H, N), (1, 15, H, N), (1, 16, H, N), (1, 17, H, N),
                  (1, 64, H, N), (1, 2048, H, N), (2, 7, 3, 16), (1, 5, 2, 32),
                  (2, 33, 3, 16), (1, 40, 2, 32)):
        say("parity wkv6: " + json.dumps(wkv6_case(*shape, rkv="bf16")))
    for decay in (1e-3, 1e-5):       # past where the Pallas form's e^{-L} overflows
        say("parity wkv6: " + json.dumps(wkv6_case(1, 128, H, N, rkv="bf16",
                                                   decay=decay)))
    say(f"parity: ok in {time.perf_counter() - t0:.1f}s")

    # 4. model on the card vs the CPU
    t0 = time.perf_counter()
    problems = []
    for arch, plen in (("internlm2-1.8b", 16), ("gemma3-1b", 40),
                       ("olmoe-1b-7b", 16), ("recurrentgemma-9b", 40),
                       ("rwkv6-3b", 16), ("llama3-8b", 16), ("llama3.2-3b", 16),
                       ("qwen3-moe-235b-a22b", 16)):
        worst, _, found, _ = model_check(arch, plen)
        problems += found
        say(f"model {arch} reduced: card vs cpu logits rel. err {worst:.3e}")
    # whisper: 64 frames, its 8-token text, three K3 launches a layer pair
    # (2 + 2 layers); llava: 8 patches before 16 tokens, one a layer (4)
    for arch, plen, flen, k3 in (("whisper-medium", 8, 64, 6),
                                 ("llava-next-34b", 16, 8, 4)):
        worst, _, found, card = model_check(arch, plen, flen)
        problems += found
        if card.get("flash_attention", 0) != k3:
            problems.append(f"{arch}: {card.get('flash_attention', 0)} flash_attention "
                            f"launches in one prefill and 8 decode steps, want {k3}")
        say(f"model {arch} reduced: card vs cpu logits rel. err {worst:.3e}")
    if problems:
        fail("model checks failed: " + "; ".join(problems))
    say(f"model: ok in {time.perf_counter() - t0:.1f}s")

    # the (2, 2) mesh on 4 gloo ranks of this machine's torch
    t0 = time.perf_counter()
    gloo4 = gloo4_finish(gloo, smi_line)
    say(f"gloo4: ok, {gloo4['checks']} checks, {gloo4['wall_s']:.1f}s since its start "
        f"({time.perf_counter() - t0:.1f}s waited)")

    # 5. serve at full width, one family at a time
    served = {}
    for arch, sessions, n_req, needs in FAMILIES:
        t0 = time.perf_counter()
        served[arch] = serve_full_width(arch, sessions, n_req, needs, ops)
        say(f"serve {arch}: ok in {time.perf_counter() - t0:.1f}s")
    # each kernel's launches are read from the run of the family whose path
    # it was ported for
    owner = {"flash_attention": "internlm2-1.8b", "dispatch_scores": "internlm2-1.8b",
             "dispatch_score_update": "internlm2-1.8b", "moe_gmm": "olmoe-1b-7b",
             "rglru_scan": "recurrentgemma-9b", "wkv6": "rwkv6-3b"}
    launches = {k: served[a][0][k] for k, a in owner.items()}
    if launches != SERVE_LAUNCHES:
        fail(f"serve launch counts {launches}, want {SERVE_LAUNCHES}")
    shapes = served["internlm2-1.8b"][1]

    # 5b. the same four under a mesh at world size 1, kernels on local shards
    t0 = time.perf_counter()
    mesh_serve = mesh_serve_phase(ops, smi_line, served)
    mesh_serve["seconds"] = time.perf_counter() - t0
    say(f"mesh_serve: ok in {mesh_serve['seconds']:.1f}s")

    # 6. real KV bytes on the card, 7. a checkpoint of the same params
    t0 = time.perf_counter()
    psrv, payload = payload_phase(ops, smi_line)
    payload["seconds"] = time.perf_counter() - t0
    say(f"payload: ok in {payload['seconds']:.1f}s")
    t0 = time.perf_counter()
    ckpt = checkpoint_phase(psrv.params, smi_line)
    ckpt["seconds"] = time.perf_counter() - t0
    say(f"checkpoint: ok in {ckpt['seconds']:.1f}s")
    del psrv
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the CI workflow's serving smokes with the port's launcher
    t0 = time.perf_counter()
    ci = ci_phase()
    say(f"ci: ok in {time.perf_counter() - t0:.1f}s")

    # 9. training: the guards, card vs CPU, full width, a restart, the
    # MoE, RG-LRU and RWKV6 families
    t0 = time.perf_counter()
    train = train_phase(ops, smi_line)
    train["seconds"] = time.perf_counter() - t0
    say(f"train: ok in {train['seconds']:.1f}s")

    # the cost model: two production cells on fake ranks, and its counts of
    # the train and decode steps beside what the card measured
    t0 = time.perf_counter()
    dryrun = dryrun_finish(dry, smi_line, train, served)
    dryrun["seconds"] = time.perf_counter() - t0
    say(f"dryrun: ok in {dryrun['seconds']:.1f}s")

    # the port's serving and elastic-training examples, card beside CPU
    t0 = time.perf_counter()
    examples = examples_phase(ops, smi_line)
    examples["seconds"] = time.perf_counter() - t0
    say(f"examples: ok in {examples['seconds']:.1f}s")

    # 10. the same MoE training under --mesh host, compression, elastic restore
    t0 = time.perf_counter()
    none_row = next(r for r in train["families"] if r["arch"] == MESH_ARCH)
    mesh = mesh_phase(ops, smi_line, none_row)
    mesh["seconds"] = time.perf_counter() - t0
    say(f"mesh: ok in {mesh['seconds']:.1f}s")

    # 11. whisper-medium whole; 12. llava at full width, 8 layers
    t0 = time.perf_counter()
    encdec = encdec_phase(ops, smi_line)
    encdec["seconds"] = time.perf_counter() - t0
    say(f"encdec: ok in {encdec['seconds']:.1f}s")
    t0 = time.perf_counter()
    vision = vision_phase(ops, smi_line)
    vision["seconds"] = time.perf_counter() - t0
    say(f"vision: ok in {vision['seconds']:.1f}s")

    # llama3-8b, llama3.2-3b whole; qwen3-moe-235b-a22b at 2 of 94 layers
    t0 = time.perf_counter()
    archs = archs_phase(ops, smi_line)
    say(f"archs: ok in {time.perf_counter() - t0:.1f}s")

    # 13. timing at the main path's shapes (decode shapes for the scans,
    # whose decode launches outnumber their prefill launches eightfold)
    main_rows = {
        "flash_attention": flash_case(shapes["flash_attention"], True, 0, "bf16",
                                      timed=True),
        "dispatch_scores": scores_case(*shapes["dispatch_scores"], density=0.2,
                                       timed=True),
        "dispatch_score_update": update_case(*shapes["dispatch_score_update"],
                                             timed=True),
        "moe_gmm": gmm_case(E, C, F, D, counts=decode_fill, timed=True),   # w2
        "rglru_scan": rglru_gated_case(1, 1, rg.rnn_width, timed=True),
        "wkv6": wkv6_case(1, 1, H, N, rkv="bf16", timed=True),
        # internlm2-1.8b's whole tree (the train cell's), held to the plain
        # version in the train phase
        "adamw_update": train["optimizer"],
    }
    # AdamW's launches are read from the train phase's launcher run
    main_launches = {**launches, "adamw_update": train["full_width"]["adamw_launches"]}
    q3 = get_arch("qwen3-moe-235b-a22b")
    q3_C = capacity(1, q3.moe_top_k, q3.num_experts, q3.capacity_factor)
    olmoe_block, olmoe_block_fill = decode_block(get_arch("olmoe-1b-7b"),
                                                 SHAPES["decode_32k"].global_batch, 16, 16)
    long_prompt = {(1, 2048, 2048, 16, 8, 128): "flash_attention S=2048 D=128 (causal)",
                   (1, 512, 512, 16, 1, 256): "flash_attention S=512 D=256 (window 2048)",
                   (1, 1024, 1024, 16, 16, 64):
                       "flash_attention whisper encoder S=1024 D=64 (non-causal)",
                   (1, 128, 1024, 16, 16, 64):
                       "flash_attention whisper cross-attention Sq=128 Skv=1024",
                   (1, 4608, 4608, 56, 8, 128):
                       "flash_attention llava prefill S=4608 H=56/8 D=128 (causal)"}
    more_rows = {
        "flash_attention D=256 (recurrentgemma prefill)": flash_case(
            (1, 16, 16, rg.num_heads, rg.num_kv_heads, rg.head_dim), True,
            rg.window_size, "bf16", timed=True),
        **{name: next(r for r in flash_rows if tuple(r["shape"]) == shape
                      and r["dtype"] == "bf16")
           for shape, name in long_prompt.items()},
        "flash_attention llava split, last of 16 blocks (288 rows, q_offset 4320)":
            split_rows[0],
        "moe_gmm w1/w3 (f32 out), decode routing": gmm_case(
            E, C, D, F, out_dtype=torch.float32, counts=decode_fill, timed=True),
        "moe_gmm w2, C=8 all experts live": gmm_case(E, C, F, D, timed=True),
        "moe_gmm w1/w3 (f32 out), C=8 all experts live": gmm_case(
            E, C, D, F, out_dtype=torch.float32, timed=True),
        "moe_gmm w1/w3 (f32 out), C=320 all rows live": gmm_case(
            E, 320, D, F, out_dtype=torch.float32, timed=True),
        "moe_gmm w2, C=320 all rows live": gmm_case(E, 320, F, D, timed=True),
        "moe_gmm qwen3 w2, decode routing (E=128, D=4096, F=1536)": gmm_case(
            q3.num_experts, q3_C, q3.d_ff, q3.d_model, timed=True,
            counts=routed_counts(1, q3.num_experts, q3.moe_top_k, q3_C, q3.d_model)),
        "moe_gmm w1/w3 (f32 out), one rank's block of olmoe-1b-7b x decode_32k "
        "on 16x16 (E=4, C=2)": gmm_case(*olmoe_block, out_dtype=torch.float32,
                                         counts=olmoe_block_fill, timed=True),
        "rglru_scan plain entry T=1": rglru_case(1, 1, rg.rnn_width, timed=True),
        "rglru_scan plain entry T=16 (prefill)": rglru_case(1, 16, rg.rnn_width,
                                                            timed=True),
        "rglru_scan gated T=16 (prefill)": rglru_gated_case(1, 16, rg.rnn_width,
                                                            timed=True),
        "rglru_scan plain entry T=2048": rglru_case(1, 2048, rg.rnn_width, timed=True),
        "rglru_scan gated T=2048": rglru_gated_case(1, 2048, rg.rnn_width, timed=True),
        "dispatch_score_update (256, 64, 64)": update_case(256, 64, 64, timed=True),
        "wkv6 T=16 (prefill)": wkv6_case(1, 16, H, N, rkv="bf16", timed=True),
        "wkv6 T=2048": wkv6_case(1, 2048, H, N, rkv="bf16", timed=True),
        "dispatch_scores (256, 512, 64)": scores_case(256, 512, 64, density=0.05,
                                                      timed=True),
        **deepseek_rows(),
    }

    def ms(x):
        return "none" if x is None else f"{x:.4f}"

    for k, row in list(main_rows.items()) + list(more_rows.items()):
        extra = ""
        if "bound_all_experts_ms" in row:
            extra = f" bound_all_experts_us={row['bound_all_experts_ms'] * 1e3:.3f}"
        say(f"timing {k}: kernel_ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} library_ms={ms(row['library_ms'])} "
            f"bound_us={row['bound_ms'] * 1e3:.3f} ({row['bound_by']}){extra}")
    kernels = []
    for k, row in main_rows.items():
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": main_launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    say(f"total: {time.perf_counter() - t_all:.1f}s")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi_line, "flash_rows": flash_rows,
         "flash_split_rows": split_rows,
         "main_rows": main_rows, "more_rows": more_rows,
         "serve": {a: v[2] for a, v in served.items()}, "launches": launches,
         "shapes": shapes, "payload": payload, "checkpoint": ckpt, "ci": ci,
         "train": train, "mesh": mesh, "encdec": encdec, "vision": vision,
         "gloo4": gloo4, "mesh_serve": mesh_serve, "archs": archs, "dryrun": dryrun,
         "examples": examples},
        indent=1))
    say(f"nvidia-smi: {smi_line}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
