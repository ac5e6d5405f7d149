"""Numpy <-> torch bridge for parameter and cache trees.

The reference keeps params and caches as nested dicts/lists of arrays; as
numpy (``tree_map(np.asarray, ...)`` on the JAX side) they cross into the
port here with their structure kept, the stacked ``groups`` axis included.
bfloat16 arrays are recognised by ``dtype.name == "bfloat16"`` and copied
bit-exact through their 16-bit pattern, so no bf16 numpy dtype package is
needed on this side.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_map


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.array(a, order="C")                  # a private C-ordered copy
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor, bf16_dtype: Optional[np.dtype] = None):
    """bfloat16 comes back as its uint16 bit pattern, or viewed as
    ``bf16_dtype`` when the caller has a numpy bfloat16 dtype to give."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy().copy()


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Numpy param tree (the reference's layout) -> torch tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: Any, bf16_dtype: Optional[np.dtype] = None) -> Any:
    """Inverse of ``params_from_numpy``."""
    return tree_map(lambda t: tensor_to_numpy(t, bf16_dtype), tree)


# Cache trees ({"groups": ..., "rem": [...]}) convert leaf by leaf the same way.
caches_from_numpy = params_from_numpy
caches_to_numpy = params_to_numpy
