"""Wrappers for the RG-LRU scan kernel (``csrc/rglru_scan.cu``).

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
kernel or raise.  Two entries share the kernel:

* ``rglru_scan(a, b, h0)``, the counterpart of the TPU kernel: a, b and h0
  are cast to contiguous float32 (as the reference's scan casts them);
* ``rglru_gated_scan(xi, r_logit, i_logit, lam, h0)``, the RG-LRU block's
  gate chain and scan in one launch: xi and the two logits go to the kernel
  in their own type when all three are bfloat16 or all float32 (no copy for
  contiguous operands, as the model passes them), else as float32.

Every call is one launch over the whole time axis.  ``rglru_scan.launches``
counts the launches of both entries, ``rglru_gated_scan.launches`` those of
the gated one.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import rglru_gated_ref, rglru_ref

_SIGNATURES = {
    "rglru_scan_fwd": [_build.P] * 5 + [_build.I] * 3 + [_build.P],
    "rglru_gated_scan_fwd": [_build.P] * 7 + [_build.I] * 4 + [_build.P],
}


def _check_state(h0, B, W):
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} must be [B, W] = {(B, W)}")


def _cuda_only(first, *rest):
    if first.device.type != "cuda" or any(
            x is not None and x.device != first.device for x in rest):
        raise ValueError("the rglru_scan kernel takes its operands on one CUDA device")


def _f32(x):
    return None if x is None else x.to(torch.float32).contiguous()


def _launch(entry, operands, h0, B, T, W, *flags):
    """Allocate y and hT on the operands' device and launch ``entry``.
    Returns (y, hT, kernel launches)."""
    dev = operands[0].device
    y = torch.empty((B, T, W), dtype=torch.float32, device=dev)
    hT = torch.empty((B, W), dtype=torch.float32, device=dev)
    if B == 0 or W == 0:
        return y, hT, 0
    lib = _build.library("rglru_scan", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(x.data_ptr() for x in operands), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), hT.data_ptr(), B, T, W, *flags, stream)
    _build.check(err, entry)
    return y, hT, 1


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t per channel.  a, b: [B, T, W]; h0: [B, W]
    or None (zeros).  Returns (y [B, T, W] f32, hT [B, W] f32)."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be one "
                         "[B, T, W] shape")
    B, T, W = a.shape
    _check_state(h0, B, W)
    if a.device.type == "cpu":
        return rglru_ref(a, b, h0)
    _cuda_only(a, b, h0)
    _build.refuse_grad("rglru_scan", a, b, h0)
    _build.refuse_dtensor("rglru_scan", a, b, h0)
    y, hT, n = _launch("rglru_scan_fwd", (_f32(a), _f32(b)), _f32(h0), B, T, W)
    rglru_scan.launches += n
    return y, hT


def rglru_gated_scan(xi, r_logit, i_logit, lam, h0=None):
    """The RG-LRU of ``models/rglru.py``: r = sigmoid(r_logit), i =
    sigmoid(i_logit), a = exp(-8 softplus(lam) r), b = sqrt(clamp(1 - a^2,
    0, 1)) (i xi), then the scan from h0.  xi, r_logit, i_logit: [B, T, W];
    lam: [W]; h0: [B, W] or None.  Returns (y [B, T, W] f32, hT [B, W] f32)."""
    if xi.ndim != 3 or r_logit.shape != xi.shape or i_logit.shape != xi.shape:
        raise ValueError(f"xi {tuple(xi.shape)}, r_logit {tuple(r_logit.shape)} and "
                         f"i_logit {tuple(i_logit.shape)} must be one [B, T, W] shape")
    B, T, W = xi.shape
    if tuple(lam.shape) != (W,):
        raise ValueError(f"lam {tuple(lam.shape)} must be [W] = {(W,)}")
    _check_state(h0, B, W)
    if xi.device.type == "cpu":
        return rglru_gated_ref(xi, r_logit, i_logit, lam, h0)
    _cuda_only(xi, r_logit, i_logit, lam, h0)
    _build.refuse_grad("rglru_gated_scan", xi, r_logit, i_logit, lam, h0)
    _build.refuse_dtensor("rglru_gated_scan", xi, r_logit, i_logit, lam, h0)
    gates = (xi, r_logit, i_logit)
    bf16 = all(x.dtype == torch.bfloat16 for x in gates)
    gates = tuple(x.contiguous() if bf16 else _f32(x) for x in gates)
    y, hT, n = _launch("rglru_gated_scan_fwd", (*gates, _f32(lam)), _f32(h0),
                       B, T, W, int(bf16))
    rglru_scan.launches += n
    rglru_gated_scan.launches += n
    return y, hT


rglru_scan.launches = 0
rglru_gated_scan.launches = 0

__all__ = ["rglru_scan", "rglru_gated_scan", "rglru_ref", "rglru_gated_ref"]
