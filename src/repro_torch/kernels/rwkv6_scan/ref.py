"""Plain PyTorch WKV6 recurrence (the oracle of ``csrc/wkv6.cu``).

A port of ``wkv6_ref`` in the reference's ``kernels/rwkv6_scan/ref.py``:
the exact per-step scan in fp32,
    S_t = diag(w_t) S_{t-1} + k_t v_t^T;  out_t = r_t (S_{t-1} + u k_t v_t^T).
The loop over time is marked (``trips.scan``): the cost model counts it by
its trip count.
"""

from __future__ import annotations

import torch

from ... import trips


def wkv6_ref(r, k, v, w, u, s0=None):
    """r, k, v, w: [B, T, H, N]; u: [H, N]; s0: [B, H, N, N] or None (zeros).

    Returns (out [B, T, H, N] f32, sT [B, H, N, N] f32); S[i, j] is key dim
    i, value dim j.
    """
    B, T, H, N = r.shape
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))

    def step(_, S, r_t, k_t, v_t, w_t):
        kv = k_t[:, :, :, None] * v_t[:, :, None, :]                  # [B,H,N,N]
        out = torch.einsum("bhi,bhij->bhj", r_t, S + u[None, :, :, None] * kv)
        return w_t[:, :, :, None] * S + kv, out

    if T == 0:
        return torch.zeros((B, 0, H, N), dtype=torch.float32, device=r.device), S
    S, out = trips.scan(T, step, S, (r, k, v, w))
    return out, S
