"""Wrapper for the WKV6 kernel (``csrc/wkv6.cu``).

CPU tensors take the plain version (``ref.wkv6_ref``); CUDA tensors launch
the kernel or raise.  r, k and v go to the kernel as they are, float32 or
bfloat16 (the model's projections are bf16); w, u and s0 are cast to
contiguous float32 (the model's decay and bonus are fp32 already).  The
kernel moves its inputs and states in 8- and 16-byte pieces: an operand
whose storage does not start on 16 bytes is copied to one that does.
``wkv6.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import wkv6_ref

_SIGNATURES = {
    "wkv6_fwd": [_build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
                 _build.P, _build.P, _build.I, _build.I, _build.I, _build.I,
                 _build.I, _build.P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)


def _aligned(x):
    return x if x.data_ptr() % 16 == 0 else x.clone()


def wkv6(r, k, v, w, u, s0=None):
    """WKV6 linear attention with data-dependent decay and state carry.

    r, k, v, w: [B, T, H, N]; u: [H, N]; s0: [B, H, N, N] or None (zeros).
    Returns (out [B, T, H, N] f32, sT [B, H, N, N] f32).  On CUDA: N in
    {16, 32, 64}, r, k, v contiguous of one dtype, float32 or bfloat16.
    """
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError("r, k, v, w must share one [B, T, H, N] shape")
    B, T, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u {tuple(u.shape)} must be [H, N] = {(H, N)}")
    if s0 is not None and tuple(s0.shape) != (B, H, N, N):
        raise ValueError(f"s0 {tuple(s0.shape)} must be [B, H, N, N]")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    _build.refuse_grad("wkv6", r, k, v, w, u, s0)
    _build.refuse_dtensor("wkv6", r, k, v, w, u, s0)
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, w, u)) \
            or (s0 is not None and s0.device != dev):
        raise ValueError("wkv6 kernel takes every operand on one CUDA device")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 kernel takes r, k, v of one dtype, float32 or "
                        f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel takes N in {HEAD_SIZES}, got {N}")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("wkv6 kernel takes contiguous r, k, v")
    r, k, v = _aligned(r), _aligned(k), _aligned(v)
    w = _aligned(w.to(torch.float32).contiguous())
    u = u.to(torch.float32).contiguous()
    s0 = None if s0 is None else _aligned(s0.to(torch.float32).contiguous())
    out = torch.empty((B, T, H, N), dtype=torch.float32, device=dev)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    if B == 0 or H == 0:
        return out, sT
    lib = _build.library("wkv6", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                           u.data_ptr(), None if s0 is None else s0.data_ptr(),
                           out.data_ptr(), sT.data_ptr(), B, T, H, N,
                           _DTYPES[r.dtype], stream)
    _build.check(err, "wkv6_fwd")
    wkv6.launches += 1
    return out, sT


wkv6.launches = 0

__all__ = ["wkv6", "wkv6_ref"]
