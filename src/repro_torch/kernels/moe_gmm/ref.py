"""Plain PyTorch grouped expert matmul (the oracle of ``csrc/moe_gmm.cu``).

A port of ``gmm_ref`` in the reference's ``kernels/moe_gmm/ref.py``, with
the output type made explicit: products are summed in fp32 (bf16 operands
are upcast, and their products are exact in fp32) and the result is cast to
``out_dtype``, or to x's dtype when it is None (the TPU kernel's contract).
"""

from __future__ import annotations

import torch


def gmm_ref(x, w, out_dtype=None):
    """x: [E, C, D]; w: [E, D, F] -> [E, C, F] in ``out_dtype`` (default x's)."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return out.to(out_dtype or x.dtype)
