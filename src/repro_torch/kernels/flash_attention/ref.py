"""Plain PyTorch flash-attention oracle (GQA, causal, optional window).

A port of ``attention_ref`` in the reference's
``kernels/flash_attention/ref.py``: direct softmax attention in fp32 over
the full score matrix (small shapes, and the CPU path of the wrapper).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D]; returns [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (D ** -0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos + (Skv - Sq)  # aligned ends (prefill convention)
    if window:
        ok &= kpos > qpos + (Skv - Sq) - window
    s = torch.where(ok[None, None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return o.to(q.dtype)
