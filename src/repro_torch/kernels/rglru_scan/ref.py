"""Plain PyTorch RG-LRU recurrence (the oracle of ``csrc/rglru_scan.cu``).

A port of ``rglru_ref`` in the reference's ``kernels/rglru_scan/ref.py``:
the exact per-step scan h_t = a_t * h_{t-1} + b_t in fp32.
"""

from __future__ import annotations

import torch


def rglru_ref(a, b, h0=None):
    """a, b: [B, T, W]; h0: [B, W] or None (zeros).

    Returns (y [B, T, W] f32, hT [B, W] f32).
    """
    B, T, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    a, b = a.float(), b.float()
    ys = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    y = torch.stack(ys, 1) if ys else torch.zeros((B, 0, W), device=a.device)
    return y, h
