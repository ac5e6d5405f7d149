"""Wrapper for the flash-attention kernel (``csrc/flash_attention.cu``).

CPU tensors take the plain version (``ref.attention_ref``); CUDA tensors
launch the kernel or raise.  ``flash_attention.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import attention_ref

_SIGNATURES = {
    "flash_attention_fwd": [_build.P, _build.P, _build.P, _build.P,
                            _build.I, _build.I, _build.I, _build.I, _build.I,
                            _build.I, _build.I, _build.I, _build.I, _build.P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Tiled online-softmax GQA attention with aligned ends.

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] with H % Hkv == 0.  On CUDA:
    float32 or bfloat16, D in {16, 32, 64, 128}, contiguous inputs, and
    Skv >= Sq when a causal or window mask applies.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, S, heads, D]")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError("H must be a multiple of Hkv")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if (causal or window) and Skv < Sq:
        raise ValueError("masked attention needs Skv >= Sq (aligned ends)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, D, _DTYPES[q.dtype], int(bool(causal)),
            int(window), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "attention_ref"]
