"""Mixture-of-Experts FFN on torch: capacity-based dispatch on one device.

A port of ``moe_ffn`` in the reference's ``models/moe.py`` (the mesh-free
path): the router's softmax with renormalised top-k, the stable rank of
each assignment within its expert, the k-sliced scatter into an [E, C, D]
capacity buffer, SwiGLU experts, and the gated gather back.  Assignments
past an expert's capacity are dropped (their slot is clipped to C-1 and
they add zero), so their tokens fall through the residual, as in GShard.

The scatter accumulates (``index_add_``), as the reference's ``.at[].add``
does: a dropped entry shares its clipped slot with a kept one, and a plain
index assignment would let its zero overwrite the kept row.

Serving (``train=False``) runs the experts through the grouped-GEMM kernel
(``kernels.moe_gmm``).  Each expert's fill, ``min(assignments, C)``, goes to
the three GEMMs as ``counts``: rows at and past it are empty, so the kernel
skips them and reads no weights of an expert that holds no token.  A
dropped assignment is clipped to slot C-1 only in an expert whose fill is
C, so every row the gather reads lies below its expert's fill.  The counts
are summed on the device by ``scatter_add_`` (``torch.bincount`` reads its
input's maximum back to the host on CUDA), so the FFN makes no host sync
for them.

Training (``train=True``) follows the reference's train path, which never
reaches its Pallas kernel: the experts are the three einsums of its
``_expert_mlp`` with ``preferred_element_type=F32``, written here on
f32-upcast operands (a bf16 product is exact in f32), so autograd
differentiates them on the CPU and on the card alike.  The kernel has no
backward.  No fill mask is needed there: the empty rows of the buffer are
zero and stay zero through the SwiGLU.  ``moe_ffn_sharded`` (expert
parallelism) is not ported (ROADMAP D2).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.moe_gmm.ops import moe_gmm
from .layers import F32, dense_init


def moe_init(gen, d_model: int, d_ff: int, n_experts: int, lead=()):
    return {
        "router": dense_init(gen, (d_model, n_experts), dtype=F32, lead=lead),
        "experts": {
            "w1": dense_init(gen, (n_experts, d_model, d_ff), lead=lead),   # gate
            "w3": dense_init(gen, (n_experts, d_model, d_ff), lead=lead),   # up
            "w2": dense_init(gen, (n_experts, d_ff, d_model), lead=lead),   # down
        },
    }


def capacity(T: int, top_k: int, n_experts: int, factor: float,
             multiple: int = 8) -> int:
    c = int(math.ceil(T * top_k / n_experts * factor))
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def _rank_positions(flat_e):
    """Stable rank of each entry within its bucket (argsort + searchsorted)."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) - first
    return pos


def _router(p, x2d, top_k: int):
    logits = x2d.to(F32) @ p["router"].to(F32)                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)            # [T, K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def _expert_counts(flat_e, n_experts: int):
    """Assignments per expert, int32 [E], summed on the device."""
    ones = torch.ones_like(flat_e, dtype=torch.int32)
    return torch.zeros(n_experts, dtype=torch.int32,
                       device=flat_e.device).scatter_add_(0, flat_e, ones)


def _aux_loss(probs, counts, n_assignments: int):
    f_e = counts.to(F32) / n_assignments
    return counts.numel() * torch.sum(f_e * probs.mean(dim=0))


def _expert_mlp(w, buf, counts=None, train=False):
    """buf: [E, C, D] -> [E, C, D] through SwiGLU experts, the gate and up
    products kept in fp32 and the down product rounded to buf's dtype, where
    the reference's einsums round.  Serving: three grouped GEMMs, rows at
    and past ``counts[e]`` come out 0.  Training: the reference's einsums,
    summed in fp32 on upcast operands."""
    if train:
        bf = buf.to(F32)
        g = torch.einsum("ecd,edf->ecf", bf, w["w1"].to(F32))
        u = torch.einsum("ecd,edf->ecf", bf, w["w3"].to(F32))
        h = (F.silu(g) * u).to(buf.dtype)
        return torch.einsum("ecf,efd->ecd", h.to(F32), w["w2"].to(F32)).to(buf.dtype)
    g = moe_gmm(buf, w["w1"], out_dtype=F32, counts=counts)
    u = moe_gmm(buf, w["w3"], out_dtype=F32, counts=counts)
    h = (F.silu(g) * u).to(buf.dtype)
    return moe_gmm(h, w["w2"], counts=counts)


def moe_ffn(p, x2d, *, n_experts: int, top_k: int, capacity_factor: float,
            train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: [T, D] -> ([T, D], aux).  ``train``: the experts run the
    reference's einsums instead of the kernel."""
    T, D = x2d.shape
    E, K = n_experts, top_k
    C = capacity(T, K, E, capacity_factor)
    probs, gate_vals, gate_idx = _router(p, x2d, K)
    flat_e = gate_idx.reshape(T * K)
    assigned = _expert_counts(flat_e, E)
    aux = _aux_loss(probs, assigned, T * K)
    fill = torch.clamp(assigned, max=C)

    pos = _rank_positions(flat_e)
    keep = pos < C
    slot = torch.clamp(pos, 0, C - 1)
    row = flat_e * C + slot                                           # into [E*C]

    buf = torch.zeros((E * C, D), dtype=x2d.dtype, device=x2d.device)
    zero = torch.zeros((), dtype=x2d.dtype, device=x2d.device)
    for k in range(K):      # k-sliced scatters cap the transient at [T, D]
        buf.index_add_(0, row[k::K], torch.where(keep[k::K, None], x2d, zero))
    y = _expert_mlp(p["experts"], buf.view(E, C, D), fill, train).view(E * C, D)
    out = torch.zeros((T, D), dtype=F32, device=x2d.device)
    for k in range(K):
        w = (gate_vals[:, k] * keep[k::K]).to(F32)
        out = out + y[row[k::K]].to(F32) * w[:, None]
    return out.to(x2d.dtype), aux
