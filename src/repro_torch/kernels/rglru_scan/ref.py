"""Plain PyTorch RG-LRU recurrence (the oracle of ``csrc/rglru_scan.cu``).

``rglru_ref`` is a port of ``rglru_ref`` in the reference's
``kernels/rglru_scan/ref.py``: the exact per-step scan h_t = a_t * h_{t-1} +
b_t in fp32.  ``rglru_gated_ref`` puts in front of it the gate chain of the
reference's ``models/rglru.py`` (``rglru_block_apply``'s two sigmoids and
``rglru_scan``'s a and b), as tensor operations in the same order.  The
loop over time is marked (``trips.scan``): the cost model counts it by its
trip count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import trips

RGLRU_C = 8.0


def rglru_ref(a, b, h0=None):
    """a, b: [B, T, W]; h0: [B, W] or None (zeros).

    Returns (y [B, T, W] f32, hT [B, W] f32).
    """
    B, T, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    a, b = a.float(), b.float()

    def step(_, h, a_t, b_t):
        h = a_t * h + b_t
        return h, h

    if T == 0:
        return torch.zeros((B, 0, W), device=a.device), h
    h, y = trips.scan(T, step, h, (a, b))
    return y, h


def rglru_gated_ref(xi, r_logit, i_logit, lam, h0=None):
    """xi, r_logit, i_logit: [B, T, W]; lam: [W] f32; h0: [B, W] or None.

    r = sigmoid(r_logit), i = sigmoid(i_logit) in fp32;
    a = exp(-8 softplus(lam) r); b = sqrt(clamp(1 - a^2, 0, 1)) (i xi);
    then ``rglru_ref(a, b, h0)``.
    """
    r = torch.sigmoid(r_logit.to(torch.float32))
    i_gate = torch.sigmoid(i_logit.to(torch.float32))
    a = torch.exp((-RGLRU_C * F.softplus(lam))[None, None, :] * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, 0.0, 1.0)) * (i_gate * xi.to(torch.float32))
    return rglru_ref(a, b, h0)
