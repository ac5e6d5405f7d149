"""Wrappers for the dispatch-scoring kernels (``csrc/dispatch_score.cu``).

CPU tensors take the plain versions (``ref.py``); CUDA tensors launch the
kernels or raise.  Operands are cast to contiguous float32 (as the
reference's wrappers cast with ``astype``); ragged edges are masked inside
the kernels, so nothing is padded.  ``dispatch_scores.launches`` and
``dispatch_score_update.launches`` count launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import dispatch_score_update_ref, dispatch_scores_ref

_SIGNATURES = {
    "dispatch_scores_f32": [_build.P, _build.P, _build.P,
                            _build.I, _build.I, _build.I, _build.P],
    "dispatch_score_update_f32": [_build.P, _build.P, _build.P, _build.P,
                                  _build.I, _build.I, _build.I, _build.P],
}


def _f32(x):
    return x.to(torch.float32).contiguous()


def _cuda_operands(*xs):
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if any(x.device != dev for x in xs):
        raise ValueError("operands must be on one device")
    return [_f32(x) for x in xs]


def dispatch_scores(demand, presence):
    """Window scores demand @ presence.T.  demand: [W, O]; presence: [E, O]."""
    if demand.ndim != 2 or presence.ndim != 2 \
            or demand.shape[1] != presence.shape[1]:
        raise ValueError(f"demand {tuple(demand.shape)} and presence "
                         f"{tuple(presence.shape)} must be [W, O] and [E, O]")
    if demand.device.type == "cpu":
        return dispatch_scores_ref(demand, presence)
    d, p = _cuda_operands(demand, presence)
    W, O = d.shape
    E = p.shape[0]
    out = torch.empty((W, E), dtype=torch.float32, device=d.device)
    if W == 0 or E == 0:
        return out
    lib = _build.library("dispatch_score", _SIGNATURES)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = lib.dispatch_scores_f32(d.data_ptr(), p.data_ptr(),
                                      out.data_ptr(), W, E, O, stream)
    _build.check(err, "dispatch_scores_f32")
    dispatch_scores.launches += 1
    return out


def dispatch_score_update(scores, mult, delta):
    """Rank-K update scores + mult @ delta on the resident matrix.

    scores: [W, E]; mult: [W, K]; delta: [K, E].  K == 0 (an epoch with no
    presence churn) returns a float32 copy and launches nothing.
    """
    if scores.ndim != 2 or mult.ndim != 2 or delta.ndim != 2 \
            or scores.shape != (mult.shape[0], delta.shape[1]) \
            or mult.shape[1] != delta.shape[0]:
        raise ValueError(f"scores {tuple(scores.shape)}, mult "
                         f"{tuple(mult.shape)}, delta {tuple(delta.shape)} "
                         "must be [W, E], [W, K], [K, E]")
    if scores.device.type == "cpu":
        return dispatch_score_update_ref(scores, mult, delta)
    s, m, d = _cuda_operands(scores, mult, delta)
    W, E = s.shape
    K = m.shape[1]
    if K == 0 or W == 0 or E == 0:
        return s.clone()
    out = torch.empty_like(s)
    lib = _build.library("dispatch_score", _SIGNATURES)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.dispatch_score_update_f32(s.data_ptr(), m.data_ptr(),
                                            d.data_ptr(), out.data_ptr(),
                                            W, E, K, stream)
    _build.check(err, "dispatch_score_update_f32")
    dispatch_score_update.launches += 1
    return out


dispatch_scores.launches = 0
dispatch_score_update.launches = 0

__all__ = ["dispatch_scores", "dispatch_scores_ref",
           "dispatch_score_update", "dispatch_score_update_ref"]
