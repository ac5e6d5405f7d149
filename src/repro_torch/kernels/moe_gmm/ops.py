"""Wrapper for the grouped expert GEMM kernel (``csrc/moe_gmm.cu``).

CPU tensors take the plain version (``ref.gmm_ref``); CUDA tensors launch
the kernel or raise.  ``moe_gmm.launches`` counts launches.

On the card, bf16 x and w (with D and F multiples of 8) run on the tensor
cores (``mma.sync`` fed by ``ldmatrix`` from a ``cp.async`` ring); f32 runs
on the SIMT pipes, since TF32 would miss the 1e-5 contract.  With
``counts``, blocks of rows at or past an expert's count write zeros without
reading that expert's weights, so a decode token reads the weights of the
experts it was routed to and no others.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import gmm_ref

_SIGNATURES = {
    "moe_gmm_fwd": [_build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
                    _build.I, _build.I, _build.I, _build.I, _build.P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moe_gmm(x, w, out_dtype=None, counts=None):
    """Per-expert x[e] @ w[e] with fp32 accumulation.

    x: [E, C, D]; w: [E, D, F] -> [E, C, F] in ``out_dtype`` (default x's
    dtype).  ``counts`` (int32 [E] on x's device, optional): rows c <
    counts[e] hold x[e, c] @ w[e] and the rest are exactly 0, whatever x and
    w hold there.  On CUDA: x and w contiguous and of one dtype, float32 or
    bfloat16; ``out_dtype`` float32 or bfloat16.
    """
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         "[E, C, D] and [E, D, F]")
    if counts is not None and (counts.shape != (x.shape[0],)
                               or counts.dtype != torch.int32
                               or counts.device != x.device):
        raise ValueError(f"counts must be int32 [{x.shape[0]}] on {x.device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return gmm_ref(x, w, out_dtype, counts)
    _build.refuse_grad("moe_gmm", x, w)
    _build.refuse_dtensor("moe_gmm", x, w)
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
                              None if counts is None else counts.data_ptr(),
                              E, C, D, F, _DTYPES[x.dtype], _DTYPES[out_dtype],
                              stream)
    _build.check(err, "moe_gmm_fwd")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0

__all__ = ["moe_gmm", "gmm_ref"]
