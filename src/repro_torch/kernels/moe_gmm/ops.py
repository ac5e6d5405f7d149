"""Wrapper for the grouped expert GEMM kernel (``csrc/moe_gmm.cu``).

CPU tensors take the plain version (``ref.gmm_ref``); CUDA tensors launch
the kernel or raise.  ``moe_gmm.launches`` counts launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import gmm_ref

_SIGNATURES = {
    "moe_gmm_fwd": [_build.P, _build.P, _build.P, _build.I, _build.I, _build.I,
                    _build.I, _build.I, _build.I, _build.P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gmm(x, w, out_dtype=None):
    """Per-expert x[e] @ w[e] with fp32 accumulation.

    x: [E, C, D]; w: [E, D, F] -> [E, C, F] in ``out_dtype`` (default x's
    dtype).  On CUDA: x and w contiguous and of one dtype, float32 or
    bfloat16; ``out_dtype`` float32 or bfloat16.
    """
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         "[E, C, D] and [E, D, F]")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return gmm_ref(x, w, out_dtype)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"unsupported devices {x.device}, {w.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or out_dtype not in _DTYPES:
        raise TypeError(f"moe_gmm kernel takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype} -> {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm kernel takes contiguous tensors")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library("moe_gmm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              E, C, D, F, _DTYPES[x.dtype], _DTYPES[out_dtype],
                              stream)
    _build.check(err, "moe_gmm_fwd")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0

__all__ = ["moe_gmm", "gmm_ref"]
