"""Plain PyTorch flash-attention oracle (GQA, causal, optional window).

A port of ``attention_ref`` in the reference's
``kernels/flash_attention/ref.py``: direct softmax attention in fp32 over
the full score matrix (small shapes, and the CPU path of the wrapper).
It also takes a softmax ``scale`` and values of another width than the
keys (latent attention's qk 192 / v 128), which the reference's has not.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0, q_offset=None,
                  scale=None):
    """q: [B, Sq, H, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, Dv]; returns
    [B, Sq, H, Dv].

    Query row i sits at position ``q_offset + i``; None means ``Skv - Sq``
    (aligned ends, the prefill convention).  ``scale`` multiplies the
    scores; None means 1 / sqrt(D)."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (
        D ** -0.5 if scale is None else scale)
    offset = Skv - Sq if q_offset is None else q_offset
    qpos = torch.arange(Sq, device=q.device)[:, None] + offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok[None, None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return o.to(q.dtype)
