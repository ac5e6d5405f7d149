"""Per-cell roofline with region attribution and kernel substitution.

The counterpart of the reference's ``launch/perf.py``.  The dry run traces
the plain route (attention through ``attention_core``, the RG-LRU and WKV6
loops over time), so the attention scores and the two scans carry traffic
and flops that the hand-written kernels (K3, K5, K6) do not.  This module:

  1. traces a cell (``dryrun.build_cell`` on fake ranks) and attributes
     its costs to the ``record_function`` regions attn_scores / wkv_scan /
     rglru_rec / other (``op_analysis``);
  2. models the kernel-substituted roofline: each region's counted cost is
     replaced by its kernel's analytic cost (I/O once per block and the
     causal half of the matmul flops for flash attention; the state kept
     on chip for the scans), the reference's models unchanged;
  3. prints the baseline and substituted terms.

Like the dry run, a shape-only analysis on FakeTensors: it allocates
nothing on any device and has no ``--device``.

Run:  python -m repro_torch.launch.perf --arch llama3-8b --shape train_4k
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

from .dryrun import model_flops, trace_cell
from .rooflines import HBM_BW, PEAK_FLOPS

REGIONS = ["attn_scores", "wkv_scan", "rglru_rec"]


def flash_kernel_model(cfg, shape, n_dev: int, mesh_shape) -> Dict[str, float]:
    """Analytic per-device cost of Pallas flash attention for this cell.

    Traffic: q,k,v read + o written once per pass (fwd) and ~2x for bwd
    (dq,dk,dv + recomputed streams).  FLOPs: 2*S^2*H*D per seq fwd (causal
    half), x2 more ops for pv, x2.5 for bwd recompute+grads.
    """
    if cfg.num_heads == 0:
        return {"bytes": 0.0, "dot_flops": 0.0}
    B, S = shape.global_batch, shape.seq_len
    H, Dh, Hkv = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    attn_layers = sum(1 for k in cfg.pattern() if k in ("A", "L"))
    if cfg.encoder_layers:
        attn_layers = cfg.encoder_layers + 2 * cfg.decoder_layers
    Sq = 1 if shape.kind == "decode" else S   # decode: one query vs S keys
    # per layer, global: q/o [B,Sq,H,Dh] + k/v [B,S,Hkv,Dh], bf16
    io = (2 * B * Sq * H * Dh + 2 * B * S * Hkv * Dh) * 2.0
    # causal: half the S^2 pairs for prefill/train; decode attends to all S
    pair_frac = 0.5 if Sq == S else 1.0
    flops = 4.0 * B * Sq * S * pair_frac * H * Dh  # qk + pv
    passes = 3.0 if shape.kind == "train" else 1.0   # fwd + bwd(dq,dkv)
    total_bytes = attn_layers * io * passes
    total_flops = attn_layers * flops * (3.5 if shape.kind == "train" else 1.0)
    return {"bytes": total_bytes / n_dev, "dot_flops": total_flops / n_dev}


def wkv_kernel_model(cfg, shape, n_dev: int) -> Dict[str, float]:
    """Chunked WKV6 kernel: streams r/k/v/w once, state stays in VMEM."""
    if "W" not in cfg.pattern():
        return {"bytes": 0.0, "dot_flops": 0.0}
    B, S = shape.global_batch, shape.seq_len
    D, N = cfg.d_model, cfg.rwkv_head_dim
    layers = cfg.num_layers
    io = 5 * B * S * D * 4.0              # r,k,v,w read + o write (f32)
    flops = 4.0 * B * S * D * N           # A@v + state updates (chunked form)
    passes = 3.0 if shape.kind == "train" else 1.0
    return {"bytes": layers * io * passes / n_dev,
            "dot_flops": layers * flops * passes / n_dev}


def rglru_kernel_model(cfg, shape, n_dev: int) -> Dict[str, float]:
    if "R" not in cfg.pattern():
        return {"bytes": 0.0, "dot_flops": 0.0}
    B, S = shape.global_batch, shape.seq_len
    W = cfg.rnn_width
    layers = sum(1 for k in cfg.pattern() if k == "R")
    io = 3 * B * S * W * 4.0              # a, b read + y write
    passes = 3.0 if shape.kind == "train" else 1.0
    return {"bytes": layers * io * passes / n_dev, "dot_flops": 0.0}


def analyze_cell(arch: str, shape_name: str, multi_pod: bool = False,
                 breakdown_top: int = 12, *, reduced: bool = False,
                 mesh_shape: Optional[Tuple[int, ...]] = None):
    cfg, shape, n_dev, mesh_dims, base, tr = trace_cell(
        arch, shape_name, multi_pod, reduced=reduced, mesh_shape=mesh_shape,
        regions=REGIONS, top=breakdown_top)
    total, regions = tr.total, tr.regions
    # kernel substitution: remove the plain regions' costs, add the kernel
    # models; the collectives stay as counted
    sub_bytes, sub_flops = total.bytes, total.dot_flops
    for r, model in (("attn_scores", flash_kernel_model(cfg, shape, n_dev, mesh_dims)),
                     ("wkv_scan", wkv_kernel_model(cfg, shape, n_dev)),
                     ("rglru_rec", rglru_kernel_model(cfg, shape, n_dev))):
        rc = regions.get(r)
        if rc is None or rc.bytes == 0:
            continue
        sub_bytes = sub_bytes - rc.bytes + model["bytes"]
        sub_flops = sub_flops - rc.dot_flops + model["dot_flops"]
    substituted = dict(base, compute_s=max(sub_flops, 0) / PEAK_FLOPS,
                       memory_s=max(sub_bytes, 0) / HBM_BW)

    mf = model_flops(cfg, shape) / n_dev
    return {
        "arch": arch, "shape": shape_name, "devices": n_dev,
        "peak_gib": round(tr.memory["peak_device_bytes"] / 2**30, 2),
        "baseline_terms": base,
        "kernelized_terms": substituted,
        "region_bytes": {r: regions[r].bytes for r in regions},
        "region_flops": {r: regions[r].dot_flops for r in regions},
        "model_flops_per_device": mf,
        "roofline_fraction_baseline": (mf / PEAK_FLOPS) / max(base.values()),
        "roofline_fraction_kernelized": (mf / PEAK_FLOPS) / max(substituted.values()),
        "breakdown": tr.breakdown,
        "collectives": dict(total.collective_bytes),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = analyze_cell(args.arch, args.shape, args.multi_pod)
    b, k = res["baseline_terms"], res["kernelized_terms"]
    print(f"== {args.arch} x {args.shape} ({res['devices']} dev, peak {res['peak_gib']} GiB)")
    print(f" baseline:    compute={b['compute_s']:.3f}s memory={b['memory_s']:.3f}s "
          f"collective={b['collective_s']:.3f}s  frac={res['roofline_fraction_baseline']:.4f}")
    print(f" kernelized:  compute={k['compute_s']:.3f}s memory={k['memory_s']:.3f}s "
          f"collective={k['collective_s']:.3f}s  frac={res['roofline_fraction_kernelized']:.4f}")
    print(" region bytes (GB):",
          {r: round(v / 1e9, 1) for r, v in res["region_bytes"].items()})
    print(" top traffic:")
    for kk, v, n in res["breakdown"]:
        print(f"   {v / 1e9:9.1f} GB n={n:6d} {kk}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)


if __name__ == "__main__":
    main()
