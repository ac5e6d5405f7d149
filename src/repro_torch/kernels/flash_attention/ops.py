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
                            _build.I, _build.I, _build.I, _build.I, _build.I,
                            _build.I, _build.F, _build.P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
# (qk, v) head widths that differ: latent attention's expanded prefill
SPLIT_HEAD_DIMS = ((192, 128),)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset=None, scale=None):
    """Tiled online-softmax GQA attention.

    q: [B, Sq, H, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, Dv] with H % Hkv
    == 0; returns [B, Sq, H, Dv].  ``scale`` multiplies the scores (None:
    1 / sqrt(D)).  Query row i
    sits at position ``q_offset + i`` (the Pallas body's ``q_offset``);
    None means ``Skv - Sq``, aligned ends.  A given offset must be >= 0
    and, when a causal or window mask applies, keep the last row within
    the keys (``q_offset + Sq <= Skv``).  On CUDA: float32 or bfloat16, D =
    Dv in {16, 32, 64, 128, 256} or (D, Dv) = (192, 128), contiguous
    inputs, and Skv >= Sq when a mask applies with the default offset.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, S, heads, D]")
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    Dv = v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError("H must be a multiple of Hkv")
    masked = bool(causal or window)
    if q_offset is not None:
        q_offset = int(q_offset)
        if q_offset < 0:
            raise ValueError(f"q_offset must be >= 0, got {q_offset}")
        if masked and q_offset + Sq > Skv:
            raise ValueError(f"masked attention needs q_offset + Sq <= Skv, got "
                             f"{q_offset} + {Sq} > {Skv}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             scale=scale)
    _build.refuse_grad("flash_attention", q, k, v)
    _build.refuse_dtensor("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not ((D == Dv and D in HEAD_DIMS) or (D, Dv) in SPLIT_HEAD_DIMS):
        raise ValueError(f"flash_attention kernel takes D = Dv in {HEAD_DIMS} or "
                         f"(D, Dv) in {SPLIT_HEAD_DIMS}, got ({D}, {Dv})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous tensors")
    if masked and Skv < Sq:
        raise ValueError("masked attention needs Skv >= Sq (aligned ends)")
    if q_offset is None:
        q_offset = Skv - Sq
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, D, Dv, _DTYPES[q.dtype], q_offset, int(bool(causal)),
            int(window), 0.0 if scale is None else float(scale), stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

__all__ = ["flash_attention", "attention_ref"]
