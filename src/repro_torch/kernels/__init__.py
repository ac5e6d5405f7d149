"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``).

Each kernel directory holds ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: plain version for CPU tensors, the kernel for CUDA
tensors, with a ``launches`` counter; AdamW's wrapper takes CUDA tensors
alone, and ``optim/adamw.py`` chooses its path).  ``_build`` compiles and loads the
sources at first use.  No kernel has a backward: on CUDA tensors, every
wrapper raises when grad mode is on and an input requires grad
(``_build.refuse_grad``), where the plain versions stay differentiable.
"""

from .adamw.ops import adamw_fused
from .adamw.ref import adamw_ref
from .dispatch_score.ops import (
    dispatch_score_update,
    dispatch_score_update_ref,
    dispatch_scores,
    dispatch_scores_ref,
)
from .flash_attention.ops import attention_ref, flash_attention
from .moe_gmm.ops import gmm_ref, moe_gmm
from .rglru_scan.ops import rglru_gated_ref, rglru_gated_scan, rglru_ref, rglru_scan
from .rwkv6_scan.ops import wkv6, wkv6_ref

__all__ = [
    "adamw_fused", "adamw_ref",
    "dispatch_scores", "dispatch_scores_ref",
    "dispatch_score_update", "dispatch_score_update_ref",
    "flash_attention", "attention_ref",
    "moe_gmm", "gmm_ref",
    "rglru_scan", "rglru_ref", "rglru_gated_scan", "rglru_gated_ref",
    "wkv6", "wkv6_ref",
]
