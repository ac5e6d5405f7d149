"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``).

Each kernel directory holds ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: plain version for CPU tensors, the kernel for CUDA
tensors, with a ``launches`` counter).  ``_build`` compiles and loads the
sources at first use.
"""

from .dispatch_score.ops import (
    dispatch_score_update,
    dispatch_score_update_ref,
    dispatch_scores,
    dispatch_scores_ref,
)
from .flash_attention.ops import attention_ref, flash_attention

__all__ = [
    "dispatch_scores", "dispatch_scores_ref",
    "dispatch_score_update", "dispatch_score_update_ref",
    "flash_attention", "attention_ref",
]
