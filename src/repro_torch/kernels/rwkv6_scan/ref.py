"""Plain PyTorch WKV6 recurrence (the oracle of ``csrc/wkv6.cu``).

A port of ``wkv6_ref`` in the reference's ``kernels/rwkv6_scan/ref.py``:
the exact per-step scan in fp32,
    S_t = diag(w_t) S_{t-1} + k_t v_t^T;  out_t = r_t (S_{t-1} + u k_t v_t^T).
"""

from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None):
    """r, k, v, w: [B, T, H, N]; u: [H, N]; s0: [B, H, N, N] or None (zeros).

    Returns (out [B, T, H, N] f32, sT [B, H, N, N] f32); S[i, j] is key dim
    i, value dim j.
    """
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]               # [B,H,N,N]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    out = (torch.stack(outs, 1) if outs
           else torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device))
    return out, S
