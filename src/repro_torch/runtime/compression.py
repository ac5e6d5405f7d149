"""Gradient compression for the data-parallel reduction: top-k with error
feedback, int8 quantization, and an all-reduce of int8 codes.

A port of the reference's ``runtime/compression.py`` on torch:

  * ``topk_compress`` -- per-leaf magnitude top-k sparsification with
    error feedback (the residual re-enters the next step; Stich et al. /
    DGC).  Every entry whose magnitude reaches the k-th largest is sent, so
    ties send more than k, as in the reference.
  * ``int8_quantize`` -- per-leaf symmetric int8 with an f32 scale,
    rounded half to even (``torch.round``, as ``jnp.round``).
  * ``compressed_psum`` -- the data-parallel mean over a mesh axis: an
    all-reduce MAX of the per-rank scales, then an all-reduce SUM of the
    codes, divided by the axis size.  The codes travel as int32, as the
    reference's ``psum`` of ``q.astype(int32)`` does, so the wire carries
    4 bytes an element, the same as f32: the "4x smaller" of the
    reference's docstring does not hold, and this port keeps its wire.

Each function takes a tree (nested dicts and lists) of tensors.
``compressed_psum`` takes each rank's own values, as the body of the
reference's ``shard_map`` sees them (a DTensor leaf contributes its local
shard) and returns plain tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.sharding import local
from ..tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


# ----------------------------------------------------------- top-k + EF
def topk_compress(grads, error_state, k_ratio: float = 0.01):
    """Returns (sparse_grads, new_error_state).

    sparse_grads has the tree and shapes of ``grads`` with only the top k
    fraction of entries (by magnitude, per leaf) non-zero; the rest add up
    in ``error_state`` and re-enter next step (error feedback keeps SGD
    convergence; arXiv:1809.07599)."""

    def one(g, e):
        acc = g.to(F32) + e
        flat = acc.reshape(-1)
        k = max(1, int(flat.numel() * k_ratio))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        mask = torch.abs(acc) >= thresh
        sent = torch.where(mask, acc, torch.zeros((), dtype=F32, device=acc.device))
        return sent.to(g.dtype), acc - sent

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(error_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)


# ------------------------------------------------------------- int8 quant
def _scale_of(x):
    """max(|x|), at least 1e-12, in x's dtype (as the reference's)."""
    return torch.clamp(torch.abs(x).max(), min=1e-12)


def _codes(x, scale):
    return torch.clamp(torch.round(x.to(F32) / scale.to(F32)), -127, 127).to(torch.int8)


def int8_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _scale_of(x) / 127.0
    return _codes(x, scale), scale.to(F32)


def int8_dequantize(q, scale):
    return q.to(F32) * scale


def quantize_tree(grads):
    """Each leaf -> its (codes, scale) pair."""
    return tree_map(int8_quantize, grads)


# ------------------------------------------------- compressed DP all-reduce
def compressed_psum(grads, mesh, axis: str = "pod"):
    """Data-parallel gradient mean over mesh axis ``axis`` with int8 codes.

    Each rank quantizes its leaf with the scale all ranks share (the MAX
    of their scales); the int32 sum of the codes times that scale over n
    is the mean, off by at most scale / 2 an element from each rank's
    rounding."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def one(leaf):
        leaf = local(leaf)
        peak = _scale_of(leaf).to(F32)                  # exact for bf16 too
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        scale = peak.to(leaf.dtype) / 127.0
        total = _codes(leaf, scale).to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.to(F32) * scale.to(F32) / n).to(leaf.dtype)

    return tree_map(one, grads)
