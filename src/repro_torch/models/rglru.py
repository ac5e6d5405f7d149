"""Griffin/RecurrentGemma recurrent block on torch: temporal conv + RG-LRU
(arXiv:2402.19427).

A port of the reference's ``models/rglru.py``.  Block: x -> (linear to
rnn_width -> causal conv1d(4) -> RG-LRU) gated by a parallel GeLU branch ->
output projection.  RG-LRU per channel:

    r_t = sigmoid(W_a xi_t),  i_t = sigmoid(W_x xi_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

The gate matmuls run as batched products.  Serving (prefill and decode)
runs the two sigmoids, a, b and the time recurrence in one launch of the
RG-LRU scan kernel's gated entry (``kernels.rglru_scan.ops.
rglru_gated_scan``), which has no backward.  Under a mesh it runs on each
rank's local width (the scan is independent per channel), with ``lam``
and the carried state sliced to the same channels.  Training follows the
reference's train path: the sigmoids as separate fp32 ops, then
``rglru_scan``, the reference's ``lax.scan`` become a Python loop over
time that autograd differentiates on the CPU and on the card alike.  The
GeLU is the tanh approximation, which is what ``jax.nn.gelu`` computes by
default.  The recurrence step (the loop, or the kernel's call) runs in the
``record_function`` region "rglru_rec", the reference's named scope, which
the cost model reads (opened through ``obs.spans.span``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import trips
from ..kernels.rglru_scan.ops import rglru_gated_scan
from ..obs.spans import span
from .layers import BF16, F32, dense_init
from .sharding import ShardCtx, gather_inner, mm

RGLRU_C = 8.0


def rglru_init(gen, d_model: int, width: int, conv_width: int = 4, lead=()):
    return {
        "w_in": dense_init(gen, (d_model, width), lead=lead),
        "w_gate_branch": dense_init(gen, (d_model, width), lead=lead),
        "conv": dense_init(gen, (conv_width, width), lead=lead),
        "w_a": dense_init(gen, (width, width), lead=lead),
        "w_x": dense_init(gen, (width, width), lead=lead),
        "lam": torch.full(tuple(lead) + (width,), 0.65, dtype=F32, device=gen.device),
        "out_proj": dense_init(gen, (width, d_model), lead=lead),
    }


def causal_conv1d(x, kernel, prev):
    """x: [B, T, W]; kernel: [Cw, W]; prev: [B, Cw-1, W] carry-in.  Depthwise,
    summed in fp32.  Returns (out [B, T, W] in x's dtype, carry-out)."""
    cw = kernel.shape[0]
    T = x.shape[1]
    xp = torch.cat([prev.to(x.dtype), x], dim=1)               # [B, T+Cw-1, W]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(cw):
        out = out + xp[:, i:i + T].to(F32) * kernel[cw - 1 - i].to(F32)
    return out.to(x.dtype), xp[:, xp.shape[1] - (cw - 1):]


def rglru_scan(xi, r, i_gate, lam, h0):
    """The reference's ``rglru_scan``.  xi, r, i_gate: [B, T, W] (r and
    i_gate the sigmoid gates); lam: [W]; h0: [B, W].  Returns (y [B, T, W]
    f32, hT).  The steps are stacked, never written into a preallocated
    buffer, so autograd sees each one; a and the gated input are unbound
    once, so backward stacks their step grads once.  The loop is marked
    (``trips.scan``): the cost model counts it by its trip count."""
    log_a = (-RGLRU_C * F.softplus(lam))[None, None, :] * r.to(F32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (
        i_gate.to(F32) * xi.to(F32))
    def step(_, h, a_t, g_t):
        h = a_t * h + g_t
        return h, h

    with span("rglru_rec"):          # region of the cost model
        h, y = trips.scan(a.shape[1], step, h0.to(F32), (a, gated))
    return y, h


def _gated_kernel(*operands):
    with span("rglru_rec"):
        return rglru_gated_scan(*operands)


def rglru_block_apply(p, x, state, train=False, ctx: ShardCtx = ShardCtx()):
    """x: [B, T, D]; state: {h: [B, W], conv: [B, Cw-1, W]}.
    Returns (out, new state) with fresh state tensors.  ``train``: the
    reference's separate gates and scan instead of the kernel."""
    x = gather_inner(x)             # read by the input and gate branches
    xi = ctx.cstr(mm(x, p["w_in"]), "dp", None, "tp")
    xi, conv_state = causal_conv1d(xi, p["conv"], state["conv"])
    if train:
        # gates laid out as xi (a matmul may split the sequence over 'tp',
        # and the scan's unbind cannot take a sharded time dim)
        r = torch.sigmoid(ctx.cstr(mm(xi, p["w_a"]), "dp", None, "tp").to(F32))
        i_gate = torch.sigmoid(ctx.cstr(mm(xi, p["w_x"]), "dp", None, "tp").to(F32))
        y, hT = rglru_scan(xi, r, i_gate, p["lam"], state["h"])
    else:
        B, T, W = xi.shape
        btw, bw = ("dp", None, "tp"), ("dp", "tp")
        y, hT = ctx.local_call(
            _gated_kernel, (xi, mm(xi, p["w_a"]), mm(xi, p["w_x"]), p["lam"], state["h"]),
            (btw, btw, btw, ("tp",), bw), [(btw, (B, T, W)), (bw, (B, W))])
    gate = F.gelu(mm(x, p["w_gate_branch"]).to(F32), approximate="tanh")
    out = mm((y * gate).to(x.dtype), p["out_proj"])
    return out, {"h": hT, "conv": conv_state}


def rglru_state_init(batch: int, width: int, conv_width: int = 4, device=None,
                     lead=()):
    return {
        "h": torch.zeros(tuple(lead) + (batch, width), dtype=F32, device=device),
        "conv": torch.zeros(tuple(lead) + (batch, conv_width - 1, width), dtype=BF16,
                            device=device),
    }
