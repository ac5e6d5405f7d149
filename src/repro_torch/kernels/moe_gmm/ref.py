"""Plain PyTorch grouped expert matmul (the oracle of ``csrc/moe_gmm.cu``).

A port of ``gmm_ref`` in the reference's ``kernels/moe_gmm/ref.py``, with
the output type made explicit: products are summed in fp32 (bf16 operands
are upcast, and their products are exact in fp32) and the result is cast to
``out_dtype``, or to x's dtype when it is None (the TPU kernel's contract).

``counts`` (int32 [E], optional) marks rows c >= counts[e] dead: x is
masked there before the product (``torch.where``, so a NaN in a dead row
does not survive as NaN * 0) and the result is exactly 0 there, whatever
w[e] holds.
"""

from __future__ import annotations

import torch


def gmm_ref(x, w, out_dtype=None, counts=None):
    """x: [E, C, D]; w: [E, D, F] -> [E, C, F] in ``out_dtype`` (default x's)."""
    xf = x.float()
    live = None
    if counts is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        live = (rows[None, :] < counts.to(x.device)[:, None])[..., None]
        xf = torch.where(live, xf, 0.0)
    out = torch.einsum("ecd,edf->ecf", xf, w.float())
    if live is not None:
        out = torch.where(live, out, 0.0)
    return out.to(out_dtype or x.dtype)
