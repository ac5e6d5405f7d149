"""Wrapper for the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

CPU tensors take the plain version (``ref.rglru_ref``); CUDA tensors launch
the kernel or raise.  a, b and h0 are cast to contiguous float32 (as the
reference's scan casts them); the kernel computes in fp32 throughout.
``rglru_scan.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import rglru_ref

_SIGNATURES = {
    "rglru_scan_fwd": [_build.P, _build.P, _build.P, _build.P, _build.P,
                       _build.I, _build.I, _build.I, _build.P],
}


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t per channel.  a, b: [B, T, W]; h0: [B, W]
    or None (zeros).  Returns (y [B, T, W] f32, hT [B, W] f32)."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be one "
                         "[B, T, W] shape")
    B, T, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} must be [B, W] = {(B, W)}")
    if a.device.type == "cpu":
        return rglru_ref(a, b, h0)
    if a.device.type != "cuda" or b.device != a.device \
            or (h0 is not None and h0.device != a.device):
        raise ValueError("rglru_scan kernel takes a, b, h0 on one CUDA device")
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    y = torch.empty_like(a)
    hT = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if B == 0 or W == 0:
        return y, hT
    lib = _build.library("rglru_scan", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(),
                                 None if h0 is None else h0.data_ptr(),
                                 y.data_ptr(), hT.data_ptr(), B, T, W, stream)
    _build.check(err, "rglru_scan_fwd")
    rglru_scan.launches += 1
    return y, hT


rglru_scan.launches = 0

__all__ = ["rglru_scan", "rglru_ref"]
